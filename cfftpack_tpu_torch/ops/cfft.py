"""Complex FFT API over the split engine (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/cfft.py``: ``fft``/``ifft`` on
complex tensors and the ``*_split`` forms on (re, im) pairs of real
tensors, with the same norms, axis handling and promotion rules, and
their 2-D and N-D forms as per-axis passes.  The engine (``core.sfft``)
works on the last axis; a pass over axis -2 of float32 planes whose
length the column kernel takes (``colfft.colfft_eligible``) runs K6 in
the natural layout, every other pass moves its axis last.  The complex
forms go through the same split passes, so they reach the same kernels,
but for one route: ``fft``/``ifft`` on the last axis at K1's register
lengths run K1's interleaved complex mode on the complex tensor itself
(``fused_fft.cfft_interleaved``), with no planes and no join.
``impl="pallas"`` on the split forms names the kernel instead of leaving
the choice to the engine: the four-step kernel K10 at its lengths, else
K1, else an error.  An input that is not a tensor is placed on the
default device (``config.as_tensor``); a tensor keeps its own.
"""
from __future__ import annotations

import torch

from ..config import (DEFAULT_NORM, as_tensor, check_norm, complex_dtype_of,
                      fwd_scale, inv_scale)
from ..utils import profiling
from ..utils.profiling import span
from . import colfft, core, fourstep_fft, fused_fft

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
           "fft_split", "ifft_split", "fft2_split", "ifft2_split"]


def _apply_axis(x, axis: int, fn):
    """fn over the last axis, applied along ``axis`` (movedim is a view)."""
    return fn(x.movedim(axis, -1)).movedim(-1, axis)


def _check_axis(x, axis: int) -> None:
    if not -x.ndim <= axis < x.ndim:
        raise ValueError(f"axis {axis} out of range for rank-{x.ndim} input")


def _check_length(n: int) -> None:
    """Every entry point calls this before any table is built."""
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")


def _fft_impl(x, axis: int, norm: str, inverse: bool):
    """The complex transform over ``axis``: on the last axis at a length
    K1's interleaved mode takes (``fused_fft.cplx_eligible``), that mode
    on the complex tensor itself; otherwise the split pass over its
    planes, joined by ``torch.complex``.  ``profiling.complex_maps``
    counts the routes."""
    x = as_tensor(x)
    _check_axis(x, axis)
    x = x.to(complex_dtype_of(x.dtype))
    n = x.shape[axis]
    _check_length(n)
    if axis % x.ndim == x.ndim - 1 and fused_fft.cplx_eligible(n, x.dtype):
        profiling.complex_maps["interleaved"] += 1
        s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
        return fused_fft.cfft_interleaved(x, n, inverse, s)
    profiling.complex_maps["planes"] += 1
    yr, yi = _split_pass(x.real, x.imag, axis, norm, inverse)
    with span("cfftpack.unpack"):
        return torch.complex(yr, yi)


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


def _kernel_engine(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    """The transform of ``impl="pallas"``: K10 where it takes (n, dtype),
    else K1 called directly, else ``ValueError``, as the reference raises
    when neither of its kernels takes the length.  No Bluestein, no
    stream kernel, no in-core four-step.  K1 applies ``scale`` in its
    store, K10 takes one multiply after it."""
    if fourstep_fft.fourstep_eligible(n, xr.dtype):
        yr, yi = fourstep_fft.sfft_fourstep(xr, xi, n, inverse)
        if scale != 1.0:
            with span("cfftpack.scale"):
                yr, yi = yr * scale, yi * scale
        return yr, yi
    if fused_fft.fused_eligible(n, xr.dtype):
        return fused_fft.sfft_fused(xr, xi, n, inverse, scale)
    raise ValueError(
        f"impl='pallas' unsupported for n={n}, dtype={xr.dtype}: the "
        "four-step kernel takes float32 n in {1024, 4096, 16384, 65536, "
        "262144}, the fused kernel float32 or float64 n > 1 with no prime "
        "factor above 32 whose buffers fit one block's shared memory")


def _split_pass(xr, xi, axis: int, norm: str, inverse: bool,
                impl: str = "xla"):
    """One scaled pass over ``axis`` of same-dtype real planes.  The
    default engine: K6 in the natural layout for an eligible axis -2,
    else ``core.sfft`` on the axis moved last.  ``impl="pallas"``: the
    axis moved last and :func:`_kernel_engine`.  The norm scale goes to
    the engine, which applies it in a kernel's store where it can (K6,
    K1, K5) and with one multiply otherwise."""
    n = xr.shape[axis]
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    return scaled_pass(xr, xi, axis, inverse, s, impl)


def scaled_pass(xr, xi, axis: int, inverse: bool, s: float,
                impl: str = "xla"):
    """:func:`_split_pass` with the scale ``s`` given in place of a norm
    (the parallel layer's passes carry the whole transform's norm)."""
    n = xr.shape[axis]
    if (impl == "xla" and xr.ndim >= 2 and axis % xr.ndim == xr.ndim - 2
            and colfft.colfft_eligible(n, xr.shape[-1], xr.dtype)):
        return colfft.scolfft(xr, xi, inverse, scale=s)
    engine = _kernel_engine if impl == "pallas" else core.sfft
    yr, yi = engine(xr.movedim(axis, -1), xi.movedim(axis, -1), n, inverse, s)
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
    _check_length(xr.shape[axis])
    return _split_pass(xr, xi, axis, norm, inverse, impl)


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
