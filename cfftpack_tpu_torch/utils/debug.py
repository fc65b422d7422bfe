"""Numerical debugging hooks.

Counterpart of ``cfftpack_tpu/utils/debug.py``.  JAX re-runs an
offending op under ``jax_debug_nans``; here :func:`enable_nan_checks`
sets a package flag under which the public transforms run
:func:`check_finite` on their result at the API layer's one exit
(:func:`api_exit`, around every name that ``ops`` and ``parallel``
export), so the check costs one flag test a call when it is off.  The
same exit puts each such call in the span ``cfftpack.<name>``
(``utils.profiling.span``).
"""
from __future__ import annotations

import functools

import torch

from .. import config
from . import profiling

__all__ = ["enable_nan_checks", "check_finite", "api_exit"]


def enable_nan_checks(enable: bool = True):
    """Raise ``FloatingPointError`` when a public transform returns a
    NaN or Inf (while on)."""
    config.NAN_CHECKS = bool(enable)


def check_finite(*tensors, name: str = "array"):
    """Assert that every tensor is finite (post-hoc check for pipelines
    that keep NaN-checking off in production); raises
    ``FloatingPointError`` naming the first that is not."""
    for i, t in enumerate(tensors):
        t = torch.as_tensor(t)
        bad = t.numel() - int(torch.isfinite(t).sum()) if (
            t.is_floating_point() or t.is_complex()) else 0
        if bad:
            raise FloatingPointError(
                f"{name}[{i}]: {bad} non-finite values "
                f"(shape {tuple(t.shape)}, dtype {t.dtype})")


def api_exit(fn):
    """``fn`` inside the span ``cfftpack.<its name>``, with its tensor
    results passed to :func:`check_finite` while NaN checks are on."""
    name = "cfftpack." + fn.__name__

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        with profiling.span(name):
            out = fn(*args, **kwargs)
            if config.NAN_CHECKS:
                outs = out if isinstance(out, tuple) else (out,)
                check_finite(*(t for t in outs
                               if isinstance(t, torch.Tensor)),
                             name=fn.__name__)
        return out
    return entry
