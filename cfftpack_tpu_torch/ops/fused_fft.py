"""K1: the whole mixed-radix Stockham DFT of each row in one kernel.

Counterpart of ``cfftpack_tpu/ops/pallas_fft.py`` (the Pallas kernel
``_make_kernel`` behind ``sfft_pallas``).  A block of the CUDA kernel
in ``csrc/stockham_fft.cu`` holds whole rows on chip and runs every
stage there, so the transform reads and writes device memory once, and
applies an optional scale in its store.  Eligible: n > 1 with no prime
factor above 32, float32 or float64, and two ping-pong buffers of both
planes of one row within the shared memory one block may use.

The lengths of :data:`REG_LENGTHS` run the register-pass kernel: the
stages of ``plan.factor(n)`` grouped into passes (``plan.reg_passes``)
that a thread runs in registers, one shared-memory exchange a pass.
Every other length runs the stage loop.  The choice is by length alone.

On a CPU tensor :func:`sfft_fused` runs the plain PyTorch version
(``core._stockham``, the same stage schedule and tables); on a CUDA
tensor it launches the kernel or raises.  Its gradient is the adjoint
transform, the other direction at the same scale, through the same
wrapper (``_adjoint``).  A launch plan per (n, dtype,
inverse, device) holds what the C entry takes besides the data, so a
launch is the checks, two ``torch.empty`` and one C call, counted in
``utils.profiling.launches["K1"]``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import plan
from ..utils import profiling
from . import _adjoint, _build, core

__all__ = ["fused_eligible", "sfft_fused", "sfft_plain", "REG_LENGTHS"]

# Shared memory one block may use on sm_90 (227 KB).
_SMEM_BUDGET = 232448
# The stage loop: rows per block are sized to this much, so two blocks
# share an SM.
_SMEM_TARGET = 96 * 1024
_THREADS = 512

# The register kernel: the lengths it is compiled for and the elements a
# thread holds in a pass.
REG_LENGTHS = {torch.float32: (480, 512, 960, 1024, 2048, 4096, 8192),
               torch.float64: (480, 512, 960, 1024, 2048, 4096)}
_REG_ELEMS = 16
_REG_MAX_THREADS = {torch.float32: 512, torch.float64: 256}


def fused_eligible(n: int, dtype: torch.dtype) -> bool:
    if n <= 1 or plan.needs_bluestein(n):
        return False
    if dtype not in (torch.float32, torch.float64):
        return False
    return 4 * n * dtype.itemsize <= _SMEM_BUDGET


def _tile_rows(n: int, dtype: torch.dtype) -> int:
    """Rows T per block of the stage loop: floor(target / (2 buffers *
    2 planes * n * size))."""
    per_row = 4 * n * dtype.itemsize
    return max(1, min(_SMEM_BUDGET, _SMEM_TARGET) // per_row)


def _reg_threads_per_row(n: int) -> int:
    return -(-n // _REG_ELEMS)


def _reg_tile_rows(n: int, dtype: torch.dtype) -> int:
    """Rows a block of the register kernel: one, or two where a row is one
    warp (n = 512).  Measured on an H100 at 2^22 elements, 1, 2 and 4
    rows a block (``chip_smoke.py`` phase 25c, PERF.md): one was fastest
    or within 2% at every length in both dtypes but 512 float32 (32.5
    against 34.0 us)."""
    return 2 if _reg_threads_per_row(n) == 32 else 1


def _flat_twiddles(tabs):
    """(offsets, re, im): stage tables concatenated as K1 reads them,
    stage s at ``[offsets[s], offsets[s+1])`` (f64 host)."""
    offs = [0]
    for t in tabs:
        offs.append(offs[-1] + t.size)
    flat = (np.concatenate([t.ravel() for t in tabs]) if len(tabs)
            else np.zeros(0, dtype=np.complex128))
    return tuple(offs), flat.real.copy(), flat.imag.copy()


def sfft_plain(xr, xi, n: int, inverse: bool):
    """K1's plain PyTorch version on any device (rows of the last axis)."""
    return core._stockham(xr, xi, n, inverse)


@dataclass(frozen=True)
class LaunchPlan:
    """What a K1 launch of one (n, dtype, inverse, device) passes to the
    C entry besides the data: the C function, the table pointers, the C
    arrays of the stage schedule and of the register passes (``passes``
    empty for the stage loop), rows a block and threads."""
    fn: object
    tables: tuple
    passes: tuple
    tile_rows: int
    threads: int
    keep: tuple
    version: int


_PLANS: dict = {}


def launch_plan(n: int, dtype: torch.dtype, inverse: bool,
                device) -> LaunchPlan:
    """The cached launch plan of (n, dtype, inverse, device), built on
    first use and again after ``plan`` replaces a table."""
    key = (n, dtype, inverse, device)
    lp = _PLANS.get(key)
    if lp is not None and lp.version == plan.VERSION:
        return lp
    with profiling.planning():
        lp = _PLANS[key] = _build_plan(n, dtype, device)
    return lp


def _build_plan(n: int, dtype: torch.dtype, device) -> LaunchPlan:
    t = plan.device_tables(n, dtype, device)
    lib = _build.load()
    fn = lib.cfft_stockham_f32 if dtype == torch.float32 else \
        lib.cfft_stockham_f64
    keep = (t,)
    if n in REG_LENGTHS[dtype]:
        passes = plan.reg_passes(n)
        ptw = plan.to_device(plan.reg_twiddles(n), dtype, device)
        keep += (ptw,)
        tb = _reg_tile_rows(n, dtype)
        threads = tb * _reg_threads_per_row(n)
        reg = (ptw.data_ptr(), passes, len(passes),
               _build.ints([len(q) for q in passes]))
    else:
        tb, threads = _tile_rows(n, dtype), _THREADS
        reg = (None, (), 0, _build.ints([]))
    tables = (t.twr.data_ptr(), t.twi.data_ptr(), t.dr.data_ptr(),
              t.di.data_ptr(), reg[0])
    stages = (len(t.factors), _build.ints(t.factors),
              _build.ints(t.offs[:-1]), _build.ints(t.dense_offs), reg[2],
              reg[3])
    return LaunchPlan(fn, tables + stages, reg[1], tb, threads, keep,
                      plan.VERSION)


def _check(xr, xi, n: int) -> None:
    if not (xr.is_cuda and xi.is_cuda) or xr.device != xi.device:
        raise ValueError(f"K1 needs both planes on one CUDA device, got "
                         f"{xr.device} and {xi.device}")
    if xr.dtype not in (torch.float32, torch.float64) or xi.dtype != xr.dtype:
        raise TypeError(f"K1 takes float32 or float64 planes of one dtype, "
                        f"got {xr.dtype} and {xi.dtype}")
    if not fused_eligible(n, xr.dtype):
        raise ValueError(f"K1 does not take n={n} in {xr.dtype}")
    rows = xr.shape[0]
    if rows >= 2 ** 31:
        raise ValueError(f"K1 takes fewer than 2^31 rows, got {rows}")


def _launch(xr, xi, n: int, inverse: bool, scale: float):
    _check(xr, xi, n)
    rows = xr.shape[0]
    with profiling.span("cfftpack.pack"):
        xr = xr.contiguous()
        xi = xi.contiguous()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if rows == 0:
        return yr, yi
    lp = launch_plan(n, xr.dtype, inverse, xr.device)
    err = _build.call("K1", lp.fn, xr.device, xr.data_ptr(), xi.data_ptr(),
                      yr.data_ptr(), yi.data_ptr(), *lp.tables[:5], rows, n,
                      *lp.tables[5:], int(inverse), lp.tile_rows, lp.threads,
                      scale)
    if err != 0:
        raise RuntimeError(f"K1 launch failed at n={n}, rows={rows}, "
                           f"{xr.dtype}: CUDA error {err}")
    return yr, yi


def sfft_fused(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    """DFT over the last axis through K1, times ``scale`` (applied in the
    kernel's store).

    Same contract as ``core.sfft``; the caller guarantees
    ``fused_eligible(n, dtype)``.  Differentiable: the adjoint of the DFT
    times ``scale`` is the other direction times ``scale``.
    """
    if _adjoint.needs_grad(xr, xi):
        return _adjoint.linear(
            lambda a, b: sfft_fused(a, b, n, inverse, scale),
            lambda a, b: sfft_fused(a, b, n, not inverse, scale), xr, xi)
    shape = xr.shape
    xr2 = xr.reshape(-1, n)
    xi2 = xi.reshape(-1, n)
    if xr.device.type == "cpu":
        yr, yi = sfft_plain(xr2, xi2, n, inverse)
        if scale != 1.0:
            yr, yi = yr * scale, yi * scale
    else:
        yr, yi = _launch(xr2, xi2, n, inverse, scale)
    return yr.reshape(shape), yi.reshape(shape)
