"""Sharded 2-D FFT: row-column with an all-to-all transpose.

Counterpart of ``cfftpack_tpu/parallel/fft2d.py``.  Each rank holds the
block (..., n0/D, n1) of the images, rows sharded over
``mesh[axis_name]`` (and the leading axis a block of a batch sharded
over ``batch_axis_name``), and gets back the block of the same rows of
the spectrum:

    1. length-n1 DFT over the rows (K1)
    2. tiled all-to-all: columns sharded, rows gathered -> (..., n0, n1/D)
    3. length-n0 DFT over axis -2 in the natural layout (K6)
    4. tiled all-to-all back -> (..., n0/D, n1)

Each pass carries its axis's norm scale into its kernel's store.  The
(re, im) planes travel together, so there are two all-to-alls a
direction in every form.  The real forms pad the ragged n1//2 + 1 bins
to a multiple of D for the exchange and slice them off after it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import (DEFAULT_NORM, _as_real_plane, check_norm,
                      complex_dtype_of, fwd_scale, inv_scale)
from ..ops import core
from ._comm import all_to_all_tiled, axis_size, on_mesh

__all__ = ["fft2_sharded", "ifft2_sharded", "fft2_sharded_split",
           "ifft2_sharded_split", "rfft2_sharded", "irfft2_sharded",
           "rfft2_sharded_split", "irfft2_sharded_split"]


def _setup(mesh, axis_name: str, batch_axis_name):
    if batch_axis_name is not None:
        axis_size(mesh, batch_axis_name)          # the axis must exist
    return axis_size(mesh, axis_name), mesh.get_group(axis_name)


def _columns(planes, group, fn):
    """Rows -> columns exchange, ``fn`` over axis -2, and back."""
    planes = all_to_all_tiled(planes, group, -1, -2)
    planes = fn(*planes)
    return all_to_all_tiled(planes, group, -2, -1)


def _fft2_pair(xr, xi, mesh, axis_name: str, inverse: bool, norm: str,
               batch_axis_name):
    xr = _as_real_plane(on_mesh(xr, mesh), "fft2_sharded")
    xi = _as_real_plane(on_mesh(xi, mesh), "fft2_sharded")
    if xr.shape != xi.shape:
        raise ValueError("re/im shapes differ")
    if xi.dtype != xr.dtype:
        xi = xi.to(xr.dtype)
    d, group = _setup(mesh, axis_name, batch_axis_name)
    n0, n1 = xr.shape[-2] * d, xr.shape[-1]
    if n1 % d:
        raise ValueError(f"2-D shape ({n0},{n1}) must be divisible by mesh "
                         f"size {d}")
    scale = inv_scale if inverse else fwd_scale
    planes = core.sfft(xr, xi, n1, inverse, scale(norm, n1))
    return _columns(planes, group, lambda ar, ai: core.scaled_pass(
        ar, ai, -2, inverse, scale(norm, n0)))


def fft2_sharded_split(xr, xi, mesh, axis_name: str = "data",
                       norm: str = DEFAULT_NORM,
                       batch_axis_name: str | None = None):
    """Sharded 2-D FFT on an (re, im) pair: this rank's (..., n0/D, n1)
    block in, the same rows of the spectrum out."""
    return _fft2_pair(xr, xi, mesh, axis_name, False, check_norm(norm),
                      batch_axis_name)


def ifft2_sharded_split(yr, yi, mesh, axis_name: str = "data",
                        norm: str = DEFAULT_NORM,
                        batch_axis_name: str | None = None):
    return _fft2_pair(yr, yi, mesh, axis_name, True, check_norm(norm),
                      batch_axis_name)


def _fft2_complex(x, mesh, axis_name, inverse, norm, batch_axis_name):
    x = on_mesh(x, mesh)
    x = x.to(complex_dtype_of(x.dtype))
    return torch.complex(*_fft2_pair(x.real, x.imag, mesh, axis_name,
                                     inverse, check_norm(norm),
                                     batch_axis_name))


def fft2_sharded(x, mesh, axis_name: str = "data",
                 norm: str = DEFAULT_NORM,
                 batch_axis_name: str | None = None):
    """2-D FFT over the trailing two axes, rows sharded over the mesh:
    this rank's (..., n0/D, n1) block in, the same rows of the spectrum
    out."""
    return _fft2_complex(x, mesh, axis_name, False, norm, batch_axis_name)


def ifft2_sharded(y, mesh, axis_name: str = "data",
                  norm: str = DEFAULT_NORM,
                  batch_axis_name: str | None = None):
    return _fft2_complex(y, mesh, axis_name, True, norm, batch_axis_name)


# ------------------------------------------------- sharded REAL 2-D

def _padded_bins(n1: int, d: int) -> int:
    return -(-(n1 // 2 + 1) // d) * d


def rfft2_sharded_split(x, mesh, axis_name: str = "data",
                        norm: str = DEFAULT_NORM,
                        batch_axis_name: str | None = None):
    """Sharded 2-D real FFT: this rank's real (..., n0/D, n1) block in,
    the same rows of the packed split (re, im) half-spectrum
    (..., n0/D, n1//2 + 1) out."""
    norm = check_norm(norm)
    x = _as_real_plane(on_mesh(x, mesh), "rfft2_sharded")
    d, group = _setup(mesh, axis_name, batch_axis_name)
    n0, n1 = x.shape[-2] * d, x.shape[-1]
    h1 = n1 // 2 + 1
    pad = (0, _padded_bins(n1, d) - h1)
    yr, yi = core.srfft(x, n1, fwd_scale(norm, n1))
    yr, yi = _columns((F.pad(yr, pad), F.pad(yi, pad)), group,
                      lambda ar, ai: core.scaled_pass(
                          ar, ai, -2, False, fwd_scale(norm, n0)))
    return yr[..., :h1], yi[..., :h1]


def irfft2_sharded_split(yr, yi, n1: int, mesh, axis_name: str = "data",
                         norm: str = DEFAULT_NORM,
                         batch_axis_name: str | None = None):
    """Inverse sharded 2-D real FFT; ``n1`` is the real row length."""
    norm = check_norm(norm)
    n1 = int(n1)
    yr = _as_real_plane(on_mesh(yr, mesh), "irfft2_sharded")
    yi = _as_real_plane(on_mesh(yi, mesh), "irfft2_sharded")
    if yr.shape != yi.shape:
        raise ValueError("re/im shapes differ")
    if yi.dtype != yr.dtype:
        yi = yi.to(yr.dtype)
    if yr.shape[-1] != n1 // 2 + 1:
        raise ValueError(
            f"irfft2_sharded: spectrum axis has {yr.shape[-1]} bins, "
            f"expected n1//2+1 = {n1 // 2 + 1} for n1={n1}")
    d, group = _setup(mesh, axis_name, batch_axis_name)
    n0, h1 = yr.shape[-2] * d, n1 // 2 + 1
    pad = (0, _padded_bins(n1, d) - h1)
    yr, yi = _columns((F.pad(yr, pad), F.pad(yi, pad)), group,
                      lambda ar, ai: core.scaled_pass(
                          ar, ai, -2, True, inv_scale(norm, n0)))
    return core.sirfft(yr[..., :h1], yi[..., :h1], n1, inv_scale(norm, n1))


def rfft2_sharded(x, mesh, axis_name: str = "data",
                  norm: str = DEFAULT_NORM,
                  batch_axis_name: str | None = None):
    """Complex-dtype convenience wrapper over rfft2_sharded_split."""
    return torch.complex(*rfft2_sharded_split(x, mesh, axis_name, norm,
                                              batch_axis_name))


def irfft2_sharded(y, n1: int, mesh, axis_name: str = "data",
                   norm: str = DEFAULT_NORM,
                   batch_axis_name: str | None = None):
    y = on_mesh(y, mesh)
    y = y.to(complex_dtype_of(y.dtype))
    return irfft2_sharded_split(y.real, y.imag, n1, mesh, axis_name, norm,
                                batch_axis_name)
