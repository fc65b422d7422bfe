"""Tracing and timing hooks.

Counterpart of ``cfftpack_tpu/utils/profiling.py``: a ``torch.profiler``
trace (CPU and, on a card, CUDA activity) exported as a Chrome trace,
and a block timer that times CUDA work on CUDA events.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

__all__ = ["trace", "Timer"]


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace around a block and export it to
    ``logdir/trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``).  Yields ``logdir``, by default a directory
    under the temporary directory.

        with trace("/tmp/t"): fn(x)
    """
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "cfftpack_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_tensors(sync) -> list:
    if sync is None:
        return []
    items = sync if isinstance(sync, (list, tuple)) else [sync]
    return [t for t in items if isinstance(t, torch.Tensor) and t.is_cuda]


class Timer:
    """Block timer.  ``sync``: the tensor (or tensors) the block
    produces.  When one is on a card, the block is timed on CUDA events
    on that card's current stream; otherwise on ``time.perf_counter``.
    ``seconds`` holds the time after the block."""

    def __init__(self, sync=None):
        self._cuda = _cuda_tensors(sync)
        self.seconds = None

    def __enter__(self):
        if self._cuda:
            dev = self._cuda[0].device
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record(torch.cuda.current_stream(dev))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            start, end = self._events
            end.record(torch.cuda.current_stream(self._cuda[0].device))
            end.synchronize()
            self.seconds = start.elapsed_time(end) / 1e3
        else:
            self.seconds = time.perf_counter() - self._t0
        return False
