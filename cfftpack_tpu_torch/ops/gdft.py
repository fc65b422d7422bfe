"""Generalized DFT with fractional time/frequency shifts (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/gdft.py``.  The shifted transform
factorizes as pre-ramp * FFT * post-ramp,

    gdft(x, a, b)[k] = scale * sum_j x[j] e^{-2i pi (j+a)(k+b)/n}
                     = scale * e^{-2i pi a b / n} * e^{-2i pi a k / n}
                       * DFT[ x_j e^{-2i pi j b / n} ][k]

``a`` shifts the time grid, ``b`` the frequency grid (the C library's
gdft_create(size, a, b) maps to exponent (j+b_ref)(k+a_ref); our (a, b)
= its (b_ref, a_ref)).  FFTPACK norm scales the forward by 1/n.

``igdft`` is the true inverse, igdft(gdft(x, a, b), a, b) == x, not the
C library's ``gdft_inverse``, whose last ramp is unconjugated.

The transform is the engine's ``core.sfft`` on split planes, so it
reaches the same kernels as ``fft``; the ramps are built in float64 and
cached as tensors per (n, a, b, dtype, device).  float64 and complex128
input run natively in complex128.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import plan
from ..config import (DEFAULT_NORM, _as_real_plane, _check_axis, as_tensor,
                      check_norm, complex_dtype_of, fwd_scale, inv_scale)
from . import core, fused_fft

__all__ = ["gdft", "igdft", "gdft_split", "igdft_split",
           "shifted_dft_padded"]


def _ramps(n: int, a: float, b: float):
    j = np.arange(n)
    pre = np.exp(-2j * np.pi * j * b / n)
    post = np.exp(-2j * np.pi * (j * a + a * b) / n)
    return pre, post


@functools.lru_cache(maxsize=64)
def _device_ramps(n: int, a: float, b: float, dtype, device):
    """(pre re, im, post re, im) of the forward transform as real
    tensors; the inverse takes their conjugates."""
    pre, post = _ramps(n, a, b)
    return tuple(plan.to_device(t, dtype, device)
                 for t in (pre.real, pre.imag, post.real, post.imag))


def _gdft_planes(xr, xi, a: float, b: float, axis: int, norm: str,
                 inverse: bool):
    """The scaled transform over ``axis`` of same-dtype real planes."""
    n = xr.shape[axis]
    xr = xr.movedim(axis, -1)
    xi = xi.movedim(axis, -1)
    prer, prei, postr, posti = _device_ramps(n, a, b, xr.dtype, xr.device)
    if inverse:
        # conj of the forward composition:
        # x_j = sum_k y_k e^{+2i pi (j+a)(k+b)/n}
        ar, ai = fused_fft._cmul_tab(xr, xi, postr, -posti)
        yr, yi = core.sfft(ar, ai, n, True)
        zr, zi = fused_fft._cmul_tab(yr, yi, prer, -prei)
    else:
        ar, ai = fused_fft._cmul_tab(xr, xi, prer, prei)
        yr, yi = core.sfft(ar, ai, n, False)
        zr, zi = fused_fft._cmul_tab(yr, yi, postr, posti)
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    if s != 1.0:
        zr = zr * s
        zi = zi * s
    return zr.movedim(-1, axis), zi.movedim(-1, axis)


def _gdft_impl(x, a: float, b: float, axis: int, norm: str, inverse: bool):
    x = as_tensor(x)
    _check_axis(x, axis)
    x = x.to(complex_dtype_of(x.dtype))
    if x.shape[axis] < 1:
        raise ValueError(f"transform length must be >= 1, got "
                         f"{x.shape[axis]}")
    return torch.complex(*_gdft_planes(x.real, x.imag, a, b, axis, norm,
                                       inverse))


def gdft(x, a: float = 0.0, b: float = 0.0, axis: int = -1,
         norm: str = DEFAULT_NORM):
    """Generalized DFT: y[k] = scale * sum_j x[j] e^{-2i pi (j+a)(k+b)/n}."""
    return _gdft_impl(x, float(a), float(b), axis, check_norm(norm), False)


def igdft(x, a: float = 0.0, b: float = 0.0, axis: int = -1,
          norm: str = DEFAULT_NORM):
    """True inverse of :func:`gdft` (unlike the C library's, see the
    module docstring): igdft(gdft(x, a, b), a, b) == x for every norm."""
    return _gdft_impl(x, float(a), float(b), axis, check_norm(norm), True)


def shifted_dft_padded(x, n: int, m: int, a: float, b: float, nout: int):
    """U[k] = sum_{j<n} x[j] e^{-2i pi (j+a)(k+b)/m}, k = 0..nout-1, as a
    complex tensor: zero-pad to m, pre/post phase ramps around one
    length-m FFT.  The odd DCT/DST types V-VIII use the real-input form,
    ``core.s_shifted_dft_real``, which shares the phase tables."""
    x = as_tensor(x)
    x = x.to(complex_dtype_of(x.dtype))
    prer, prei, postr, posti = core._shifted_phases(
        n, m, float(a), float(b), nout, x.real.dtype, x.device)
    ar, ai = fused_fft._cmul_tab(x.real, x.imag, prer, prei)
    Ar, Ai = core.sfft(F.pad(ar, (0, m - n)), F.pad(ai, (0, m - n)), m,
                       inverse=False)
    return torch.complex(*fused_fft._cmul_tab(Ar[..., :nout], Ai[..., :nout],
                                         postr, posti))


# ------------------------------------------------- split (re, im) API

def _gdft_split_impl(xr, xi, a: float, b: float, axis: int, norm: str,
                     inverse: bool):
    xr = _as_real_plane(as_tensor(xr), "gdft_split")
    xi = _as_real_plane(as_tensor(xi, like=xr), "gdft_split")
    if xr.shape != xi.shape:
        raise ValueError("re/im shapes differ")
    if xi.dtype != xr.dtype:
        xi = xi.to(xr.dtype)
    _check_axis(xr, axis)
    return _gdft_planes(xr, xi, a, b, axis, norm, inverse)


def gdft_split(xr, xi, a: float = 0.0, b: float = 0.0, axis: int = -1,
               norm: str = DEFAULT_NORM):
    """Generalized DFT on an (re, im) pair of real tensors."""
    return _gdft_split_impl(xr, xi, float(a), float(b), axis,
                            check_norm(norm), False)


def igdft_split(xr, xi, a: float = 0.0, b: float = 0.0, axis: int = -1,
                norm: str = DEFAULT_NORM):
    """Inverse of :func:`gdft_split`."""
    return _gdft_split_impl(xr, xi, float(a), float(b), axis,
                            check_norm(norm), True)
