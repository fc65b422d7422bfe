"""Plan and build caches.

Counterpart of ``cfftpack_tpu/utils/cache.py``.  The reference's
create-once/use-many plan maps to the host plan tables and their device
copies (``plan.device_tables``) and, on a card, the kernel library,
which ``ops._build`` compiles once per checkout into its own build
directory.  There is no compiled-program cache to turn on, as JAX's.
"""
from __future__ import annotations

import os

import torch

__all__ = ["enable_compilation_cache", "warm_plans"]


def enable_compilation_cache(path: str = "~/.cache/cfftpack_tpu_torch"):
    """Make the directory ``path`` and return it.  The kernels' build
    cache is ``ops._build``'s own; this keeps the JAX name and return."""
    path = os.path.expanduser(path)
    os.makedirs(path, exist_ok=True)
    return path


def warm_plans(sizes, with_twiddles: bool = True, dtype=torch.float32,
               device=None):
    """Build the plan tables of the given transform lengths ahead of the
    first call (factorization; with ``with_twiddles`` the device tables,
    Bluestein's included, in ``dtype`` on ``device``, the card unless
    the caller names another) and, on a card, load the kernel library."""
    from .. import plan
    from ..config import resolve_device
    from ..ops import _build
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        # the tables are keyed by the device the tensors report
        device = torch.device("cuda", torch.cuda.current_device())
    for n in sizes:
        plan.factor(int(n))
        if with_twiddles:
            plan.device_tables(int(n), dtype, device)
    if device.type == "cuda":
        _build.load()
