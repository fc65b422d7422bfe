"""Readers of the program's own spans in a traced run.

The port marks each step of a call with a ``record_function`` span while
the profiler records (``cfftpack_tpu_torch/utils/profiling.py``): the
leaf steps ``cfftpack.pack``, ``.merge``, ``.scale``, ``.filter`` and
``.unpack``, ``cfftpack.K1`` .. ``cfftpack.K11`` around each C call,
``cfftpack.adjoint`` around a kernel's backward.  Device times of the
kernels launched inside a span are ``readers.span_us``; this module adds
the host's side.  A reader returns None where the run has no such span,
as on a program without them.
"""
from __future__ import annotations

import re

KERNEL_SPAN = re.compile(r"cfftpack\.K\d+")


def kernel_host_us(run):
    """Host time a call inside the ``cfftpack.K*`` spans that lie inside
    the window's calls: the C entries' calls, their launches included."""
    tr = run.trace
    if tr is None:
        return None
    inside = [b - a for name, ranges in tr.spans.items()
              if KERNEL_SPAN.fullmatch(name) for a, b in ranges
              if any(c0 <= a and b <= c1 for c0, c1 in tr.calls)]
    return sum(inside) / tr.ncalls if inside else None
