"""Warm a call up front for serving.

Counterpart of ``cfftpack_tpu/utils/aot.py``.  JAX compiles a program
per shape ahead of time; here the first call of a shape builds its plan
tables and launch plans (and, on a card, loads the kernel library), so
one warm-up call takes that cost before the first request.
"""
from __future__ import annotations

__all__ = ["precompile"]


def precompile(fn, *example_args, **example_kwargs):
    """Call ``fn`` once on the example arguments and return a callable
    whose calls at those shapes find every table built.

    Example::

        step = precompile(lambda v: ct.rfft_split(v),
                          torch.zeros((4096, 960), device="cuda"))
        out = step(batch)
    """
    fn(*example_args, **example_kwargs)
    return fn
