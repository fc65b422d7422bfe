"""Tracing and timing hooks.

Counterpart of ``cfftpack_tpu/utils/profiling.py``: a ``torch.profiler``
trace (CPU and, on a card, CUDA activity) exported as a Chrome trace,
and a block timer that times CUDA work on CUDA events.

The port's own instrumentation lives here too.  :func:`span` marks a
step of the program with ``torch.profiler.record_function`` while a
profiler records, so the step's host time and the kernels it launches
land in the same trace as CUPTI's kernels, on one clock; otherwise it
costs one flag test.  The names are fixed (metrics read them):

* ``cfftpack.<name>``: every public transform (``utils.debug.api_exit``)
  and ``cfftpack.step`` (``entry.step``);
* the leaf steps of a call, which do not overlap: ``cfftpack.pack``
  (copies into a kernel's row layout; in ``ops/dct.py`` the gathers,
  cats and flips before the FFT), ``cfftpack.merge`` (the packed real
  spectrum's merge and unmerge; in ``ops/dct.py`` the table multiplies on
  either side of the FFT), ``cfftpack.scale`` (a norm's multiply no
  kernel store takes), ``cfftpack.filter`` (the step's multiply),
  ``cfftpack.unpack`` (copies out of split planes; in ``ops/dct.py`` the
  riffles, cats and the DST's output flip or sign), and
  ``cfftpack.K1`` .. ``cfftpack.K11`` (and ``cfftpack.cgemm``,
  ``cfftpack.cmul``) around each C call (``ops._build.call``);
* ``cfftpack.adjoint``: a kernel's backward (``ops._adjoint``);
* ``cfftpack.plan``: a cache miss that builds device tables or a launch
  plan (:func:`planning`; ``plan.device_tables``, ``plan.launch_plan``).

The launch registry: :data:`launches` counts each C entry's successful
calls by its key in :data:`KERNELS` (``ops._build.call``), :data:`plans`
the builds under ``cfftpack.plan``, :data:`real_maps` the real route's
maps by direction (``r2c``, ``c2r``: ``ops.fused_fft.srfft_real``,
``sirfft_real``, on any device, a backward's adjoint map included),
:data:`complex_maps` the complex API's ``fft``/``ifft`` calls by route
(``interleaved``: K1's interleaved mode; ``planes``: the split pass,
``ops.core.complex_pass``, on any device); :func:`counts` reads them all,
:func:`reset` zeroes them.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

__all__ = ["trace", "Timer", "span", "planning", "counts", "reset",
           "launches", "real_maps", "complex_maps", "KERNELS"]

# The C entries' names in the registry: the eleven kernels, the
# tensor-core product's own entry (``cgemm_f32``, called by the smoke) and
# the step's spectral multiply and its adjoint (``ops.cmul``).
KERNELS = tuple(f"K{i}" for i in range(1, 12)) + ("cgemm", "cmul")
launches: dict = dict.fromkeys(KERNELS, 0)
real_maps: dict = {"r2c": 0, "c2r": 0}
complex_maps: dict = {"interleaved": 0, "planes": 0}
plans = 0
_OFF = contextlib.nullcontext()


def span(name: str):
    """The span ``name`` around a ``with`` block: a
    ``torch.profiler.record_function`` while a profiler records on this
    thread (autograd's device thread inherits the caller's state), else
    one shared do-nothing context, so that off it makes no object and
    launches nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def planning():
    """The span ``cfftpack.plan`` around a cache miss that builds device
    tables or a launch plan; the build is counted in :data:`plans`."""
    global plans
    plans += 1
    return span("cfftpack.plan")


def counts() -> dict:
    """Launches by :data:`KERNELS` key, ``plans`` (the builds under
    ``cfftpack.plan``), the real route's maps as ``real.r2c`` and
    ``real.c2r`` and the complex API's routes as ``complex.interleaved``
    and ``complex.planes``."""
    return {**launches, "plans": plans,
            **{"real." + k: v for k, v in real_maps.items()},
            **{"complex." + k: v for k, v in complex_maps.items()}}


def reset() -> None:
    """Every count of the registry back to 0."""
    global plans
    for k in launches:
        launches[k] = 0
    for k in real_maps:
        real_maps[k] = 0
    for k in complex_maps:
        complex_maps[k] = 0
    plans = 0


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
