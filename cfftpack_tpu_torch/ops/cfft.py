"""Complex FFT API over the split engine (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/cfft.py``: ``fft``/``ifft`` on
complex tensors and the ``*_split`` forms on (re, im) pairs of real
tensors, with the same norms, axis handling and promotion rules, and
their 2-D and N-D forms as per-axis passes.  This module checks and
coerces the input and turns the norm into a scale; the engine chooses
the kernels: ``core.complex_pass`` for a complex tensor (K1's
interleaved mode on the last axis at K1's register lengths, else the
split pass over its planes) and ``core.scaled_pass`` for real planes
(K6 on an eligible axis -2, else ``core.sfft`` on the axis moved last).
``impl="pallas"`` on the split forms names the kernel instead of leaving
the choice to the engine: the four-step kernel K10 at its lengths, else
K1, else an error.  An input that is not a tensor is placed on the
default device (``config.as_tensor``); a tensor keeps its own.
"""
from __future__ import annotations

from ..config import (DEFAULT_NORM, _as_real_plane, _check_axis,
                      _check_length, as_tensor, check_norm, complex_dtype_of,
                      fwd_scale, inv_scale)
from . import core

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "fft_split", "ifft_split", "fft2_split", "ifft2_split"]


def _fft_impl(x, axis: int, norm: str, inverse: bool):
    """The complex transform over ``axis``: the checks and the norm's
    scale here, the route in ``core.complex_pass``."""
    x = as_tensor(x)
    _check_axis(x, axis)
    x = x.to(complex_dtype_of(x.dtype))
    n = x.shape[axis]
    _check_length(n)
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    return core.complex_pass(x, axis, inverse, s)


def fft(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """Forward complex FFT along ``axis``.

    Default norm="fftpack" scales by 1/N (the reference convention).
    Any length is supported in O(n log n).
    """
    return _fft_impl(x, axis, check_norm(norm), False)


def ifft(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """Inverse complex FFT along ``axis`` (unscaled under norm="fftpack")."""
    return _fft_impl(x, axis, check_norm(norm), True)


def _fft_split_impl(xr, xi, axis: int, norm: str, inverse: bool,
                    impl: str = "xla"):
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
    xr = _as_real_plane(as_tensor(xr), "fft_split")
    xi = _as_real_plane(as_tensor(xi, like=xr), "fft_split")
    if xr.shape != xi.shape:
        raise ValueError("re/im shapes differ")
    if xi.dtype != xr.dtype:
        xi = xi.to(xr.dtype)
    _check_axis(xr, axis)
    n = xr.shape[axis]
    _check_length(n)
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    return core.scaled_pass(xr, xi, axis, inverse, s, impl)


def fft_split(xr, xi, axis: int = -1, norm: str = DEFAULT_NORM,
              impl: str = "xla"):
    """Forward FFT on an (re, im) pair of real tensors.

    ``impl="xla"`` (the name kept from the JAX package's signature)
    leaves the choice of kernel to the engine.  ``impl="pallas"`` opts
    into a named kernel: the four-step kernel K10 at float32 n in
    {1024, 4096, 16384, 65536, 262144}, else K1 where it takes the length, else
    ``ValueError``.  K1 here takes float64 and any float32 length whose
    buffers fit a block's shared memory (n <= 14528), which are this
    kernel's own limits, not the TPU kernel's (float32 only).
    """
    return _fft_split_impl(xr, xi, axis, check_norm(norm), False, impl)


def ifft_split(xr, xi, axis: int = -1, norm: str = DEFAULT_NORM,
               impl: str = "xla"):
    return _fft_split_impl(xr, xi, axis, check_norm(norm), True, impl)


# ------------------------------------------------------ 2-D and N-D

def _fftn_impl(x, axes, norm: str, inverse: bool):
    x = as_tensor(x)
    if axes is None:
        axes = range(x.ndim)
    for ax in axes:
        x = _fft_impl(x, int(ax), norm, inverse)
    return x


def fft2(x, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """2-D FFT in row-column order: one pass per axis of ``axes``, the
    norm applied per axis."""
    return _fftn_impl(x, axes, check_norm(norm), inverse=False)


def ifft2(x, axes=(-2, -1), norm: str = DEFAULT_NORM):
    return _fftn_impl(x, axes, check_norm(norm), inverse=True)


def fftn(x, axes=None, norm: str = DEFAULT_NORM):
    return _fftn_impl(x, axes, check_norm(norm), inverse=False)


def ifftn(x, axes=None, norm: str = DEFAULT_NORM):
    return _fftn_impl(x, axes, check_norm(norm), inverse=True)


def _fft2_split_core(xr, xi, axes, norm: str, inverse: bool):
    for ax in axes:
        xr, xi = _fft_split_impl(xr, xi, int(ax), norm, inverse)
    return xr, xi


def fft2_split(xr, xi, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """2-D forward FFT on an (re, im) pair of real tensors: row-column
    order over ``axes``, matching :func:`fft2`; the axis -2 pass of
    float32 planes runs K6 where the length allows."""
    return _fft2_split_core(xr, xi, axes, check_norm(norm), False)


def ifft2_split(xr, xi, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """Inverse of :func:`fft2_split`."""
    return _fft2_split_core(xr, xi, axes, check_norm(norm), True)
