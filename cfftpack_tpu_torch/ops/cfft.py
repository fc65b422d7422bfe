"""Complex FFT API over the split engine (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/cfft.py``: ``fft``/``ifft`` on
complex tensors and the ``*_split`` forms on (re, im) pairs of real
tensors, with the same norms, axis handling and promotion rules, and
their 2-D and N-D forms as per-axis passes.  The engine (``core.sfft``)
works on the last axis; a pass over axis -2 of float32 planes whose
length the column kernel takes (``colfft.colfft_eligible``) runs K6 in
the natural layout, every other pass moves its axis last.  The complex
forms go through the same split passes, so they reach the same kernels.
An input that is not a tensor is placed on the default device
(``config.as_tensor``); a tensor keeps its own.
"""
from __future__ import annotations

import torch

from ..config import (DEFAULT_NORM, as_tensor, check_norm, complex_dtype_of,
                      fwd_scale, inv_scale)
from . import colfft, core

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "fft_split", "ifft_split", "fft2_split", "ifft2_split"]


def _apply_axis(x, axis: int, fn):
    """fn over the last axis, applied along ``axis`` (movedim is a view)."""
    return fn(x.movedim(axis, -1)).movedim(-1, axis)


def _check_axis(x, axis: int) -> None:
    if not -x.ndim <= axis < x.ndim:
        raise ValueError(f"axis {axis} out of range for rank-{x.ndim} input")


def _fft_impl(x, axis: int, norm: str, inverse: bool):
    x = as_tensor(x)
    _check_axis(x, axis)
    x = x.to(complex_dtype_of(x.dtype))
    n = x.shape[axis]
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")
    return torch.complex(*_split_pass(x.real, x.imag, axis, norm, inverse))


def fft(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """Forward complex FFT along ``axis``.

    Default norm="fftpack" scales by 1/N (the reference convention).
    Any length is supported in O(n log n).
    """
    return _fft_impl(x, axis, check_norm(norm), False)


def ifft(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """Inverse complex FFT along ``axis`` (unscaled under norm="fftpack")."""
    return _fft_impl(x, axis, check_norm(norm), True)


def _as_real_plane(x, name: str):
    """Coerce a real-plane operand to a >= 32-bit float dtype: integers
    promote with float32, narrower floats widen to float32 (their
    twiddles would lose ~1e-2), and complex input is rejected (it would
    flow into the real engine silently)."""
    if x.is_complex():
        raise TypeError(
            f"{name}: real input required, got {x.dtype}; take .real "
            "explicitly or use the complex fft API")
    if not x.dtype.is_floating_point:
        return x.to(torch.promote_types(x.dtype, torch.float32))
    if torch.finfo(x.dtype).bits < 32:
        return x.to(torch.float32)
    return x


def _k10_eligible(n: int, dtype) -> bool:
    """Lengths the JAX package's fused four-step Pallas kernel (K10,
    ``pallas_fourstep.fourstep_pallas_eligible``) takes: float32 and
    n = 64 * 16 * 4^k with n / 64 <= 4096."""
    if dtype != torch.float32 or n % 64:
        return False
    m = n // 64
    if m > 4096:
        return False
    while m > 16 and m % 4 == 0:
        m //= 4
    return m == 16


def _split_pass(xr, xi, axis: int, norm: str, inverse: bool,
                column: bool = True):
    """One scaled pass over ``axis`` of same-dtype real planes: K6 in
    the natural layout for an eligible axis -2 (unless ``column`` is
    off, as the reference's ``impl="pallas"`` has it), else the engine
    on the axis moved last."""
    n = xr.shape[axis]
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    if (column and xr.ndim >= 2 and axis % xr.ndim == xr.ndim - 2
            and colfft.colfft_eligible(n, xr.shape[-1], xr.dtype)):
        # the norm scale rides in the kernel's store
        return colfft.scolfft(xr, xi, inverse, scale=s)
    yr, yi = core.sfft(xr.movedim(axis, -1), xi.movedim(axis, -1), n,
                       inverse)
    if s != 1.0:
        yr = yr * s
        yi = yi * s
    return yr.movedim(-1, axis), yi.movedim(-1, axis)


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
    if impl == "pallas" and _k10_eligible(n, xr.dtype):
        raise NotImplementedError(
            f"impl='pallas' at n={n} selects the fused four-step kernel "
            "(K10), which is not ported yet (ROADMAP.md queue 2)")
    return _split_pass(xr, xi, axis, norm, inverse, column=impl == "xla")


def fft_split(xr, xi, axis: int = -1, norm: str = DEFAULT_NORM,
              impl: str = "xla"):
    """Forward FFT on an (re, im) pair of real tensors.

    ``impl`` keeps the JAX package's signature: every engine choice is
    the default one here, except that ``"pallas"`` at a length of the
    fused four-step kernel (K10) raises until that kernel is ported.
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
