"""K1: the whole mixed-radix Stockham DFT of each row in one kernel.

Counterpart of ``cfftpack_tpu/ops/pallas_fft.py`` (the Pallas kernel
``_make_kernel`` behind ``sfft_pallas``).  A block of the CUDA kernel
in ``csrc/stockham_fft.cu`` holds whole rows in shared memory and runs
every stage there, so the transform reads and writes device memory
once.  Eligible: n > 1 with no prime factor above 32, float32 or
float64, and two ping-pong buffers of both planes of one row within
the shared memory one block may use.

On a CPU tensor :func:`sfft_fused` runs the plain PyTorch version
(``core._stockham``, the same stage schedule and tables); on a CUDA
tensor it launches the kernel or raises.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import plan
from . import _build, core

__all__ = ["fused_eligible", "sfft_fused", "sfft_plain"]

launches = 0

# Shared memory one block may use on sm_90 (227 KB).
_SMEM_BUDGET = 232448
# Rows per block are sized to this much, so two blocks share an SM.
_SMEM_TARGET = 96 * 1024
_THREADS = 512


def fused_eligible(n: int, dtype: torch.dtype) -> bool:
    if n <= 1 or plan.needs_bluestein(n):
        return False
    if dtype not in (torch.float32, torch.float64):
        return False
    return 4 * n * dtype.itemsize <= _SMEM_BUDGET


def _tile_rows(n: int, dtype: torch.dtype) -> int:
    """Rows T per block: floor(target / (2 buffers * 2 planes * n * size))."""
    per_row = 4 * n * dtype.itemsize
    return max(1, min(_SMEM_BUDGET, _SMEM_TARGET) // per_row)


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


def _launch(xr, xi, n: int, inverse: bool):
    global launches
    if not (xr.is_cuda and xi.is_cuda) or xr.device != xi.device:
        raise ValueError(f"K1 needs both planes on one CUDA device, got "
                         f"{xr.device} and {xi.device}")
    if xr.dtype not in (torch.float32, torch.float64) or xi.dtype != xr.dtype:
        raise TypeError(f"K1 takes float32 or float64 planes of one dtype, "
                        f"got {xr.dtype} and {xi.dtype}")
    if not fused_eligible(n, xr.dtype):
        raise ValueError(f"K1 does not take n={n} in {xr.dtype}")
    if xr.shape[0] >= 2 ** 31:
        raise ValueError(f"K1 takes fewer than 2^31 rows, got {xr.shape[0]}")
    xr = xr.contiguous()
    xi = xi.contiguous()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    rows = xr.shape[0]
    if rows == 0:
        return yr, yi
    t = plan.device_tables(n, xr.dtype, xr.device)
    facs = np.asarray(t.factors, dtype=np.int32)
    tw_offs = np.asarray(t.offs[:-1], dtype=np.int32)
    dense_offs = np.asarray(t.dense_offs, dtype=np.int32)
    lib = _build.load()
    fn = (lib.cfft_stockham_f32 if xr.dtype == torch.float32
          else lib.cfft_stockham_f64)
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                 t.twr.data_ptr(), t.twi.data_ptr(), t.dr.data_ptr(),
                 t.di.data_ptr(), rows, n, len(facs), facs.ctypes.data,
                 tw_offs.ctypes.data, dense_offs.ctypes.data, int(inverse),
                 _tile_rows(n, xr.dtype), _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed at n={n}, rows={rows}, "
                           f"{xr.dtype}: CUDA error {err}")
    launches += 1
    return yr, yi


def sfft_fused(xr, xi, n: int, inverse: bool):
    """Unscaled DFT over the last axis through K1.

    Same contract as ``core.sfft``; the caller guarantees
    ``fused_eligible(n, dtype)``.
    """
    shape = xr.shape
    xr2 = xr.reshape(-1, n)
    xi2 = xi.reshape(-1, n)
    if xr.device.type == "cpu":
        yr, yi = sfft_plain(xr2, xi2, n, inverse)
    else:
        yr, yi = _launch(xr2, xi2, n, inverse)
    return yr.reshape(shape), yi.reshape(shape)
