"""Split-complex (re, im) transform engine (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/core.py``.  The engine works on
pairs of real tensors: mixed-radix Stockham autosort (K1 and its plain
version, ``fused_fft``), Bluestein for larger prime factors, the
in-core four-step past K1's shared-memory cap, and the real transforms
built on the complex one.  Host and device tables come from ``plan``.

Every route to a kernel is chosen here, and only here.  ``sfft``
dispatches on (n, dtype) only: Bluestein, else K1
(``fused_fft.sfft_fused``), else for float32 the stream kernel K3 or,
past its cap, the s-way split K5 (``stream_fft.sfft_stream_split``),
else the four-step whose row transforms recurse here; it takes an
optional scale, which K1 and K5 apply in their store.  The API's passes
over an axis: :func:`complex_pass` (a complex tensor: K1's interleaved
mode on its last axis at K1's register lengths, else the planes, joined
under ``cfftpack.unpack``) and :func:`scaled_pass` (real planes: K6 in
the natural layout on an eligible axis -2, else ``sfft`` or, for
``impl="pallas"``, K10 or K1 by name, :func:`_kernel_engine`).  Real
transforms of float32 stream lengths with an even batch past K1's half
length take the real-stream kernel (K7, ``rstream``); even n whose half
K1 runs in registers take K1's real modes (``fused_fft.srfft_real``,
``sirfft_real``: the deinterleave, the packed merge or unmerge, the
scale and the interleave in one launch, each direction one linear map
under autograd); :func:`srfilter`, the real filter, takes the streaming
filter (K2 and K4, or K5) on the same structural condition
(``_use_rstream``).  The device decides one thing only, inside the
kernels' wrappers: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel.  Elsewhere the real transforms' steps around the
engine run in the spans ``cfftpack.merge`` (the packed spectrum's merge
and unmerge, ``fused_fft._real_merge`` and ``_real_unmerge`` over a
table set of ``plan.real_tables``), ``cfftpack.scale`` and
``cfftpack.unpack`` (``utils.profiling``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import plan
from ..utils import profiling
from ..utils.profiling import span
from . import colfft, fourstep_fft, fused_fft, rstream, stream_fft

__all__ = ["sfft", "srfft", "sirfft", "s_shifted_dft_real"]

# --------------------------------------------- large-n four-step (local)
#
# Past K1's shared-memory cap, lengths the stream kernels do not take
# (float64, or m not 5-smooth) run as the in-core four-step:
# x[j1*n2 + j2] as (n1, n2); DFT over j1 (axis -2, a dense matmul for
# n1 <= 64), twiddle e^{sgn 2i pi k1 j2/n}, DFT over j2 (rows, through
# sfft and so K1), then one (k1, k2) -> k2-major transpose.

_DENSE_N1_MAX = 64            # outer DFT as one dense matmul up to this


@functools.lru_cache(maxsize=64)
def _fourstep_twiddle(n1: int, n2: int, inverse: bool, dtype, device):
    k1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    n = n1 * n2
    sgn = 2j * np.pi / n if inverse else -2j * np.pi / n
    tw = np.exp(sgn * (k1 * j2))
    return (plan.to_device(tw.real, dtype, device),
            plan.to_device(tw.imag, dtype, device))


def _dft_axis2_dense(xr, xi, n1: int, inverse: bool):
    """DFT over axis -2 of (..., n1, nl) as one dense matmul (full
    precision: on the card the caller keeps TF32 off)."""
    Dr, Di = plan._dense_dft(n1, inverse, xr.dtype, xr.device)
    Yr = torch.matmul(Dr, xr) - torch.matmul(Di, xi)
    Yi = torch.matmul(Dr, xi) + torch.matmul(Di, xr)
    return Yr, Yi


def _fourstep_split_n(n: int) -> tuple[int, int] | None:
    """n1*n2 == n with n1 the divisor closest to 64 in [8, 256] and
    n2 >= 128; None if no divisor of n lies in the window."""
    best = None
    for n1 in range(8, 257):
        if n % n1 == 0 and n // n1 >= 128:
            if best is None or abs(n1 - 64) < abs(best - 64):
                best = n1
    if best is None:
        return None
    return best, n // best


def _fourstep_local(xr, xi, n: int, inverse: bool):
    """In-core four-step: x[j1*n2+j2] as (n1, n2); outer DFT over j1,
    twiddle, row FFTs over j2, transpose to natural order."""
    split = _fourstep_split_n(n)
    if split is None:
        raise ValueError(f"n={n} is too long for K1 in this dtype and has "
                         "no four-step split")
    n1, n2 = split
    lead = xr.shape[:-1]
    x2r = xr.reshape(lead + (n1, n2))
    x2i = xi.reshape(lead + (n1, n2))
    if n1 <= _DENSE_N1_MAX:
        Ar, Ai = _dft_axis2_dense(x2r, x2i, n1, inverse)
    else:
        tr, ti = sfft(x2r.transpose(-1, -2), x2i.transpose(-1, -2), n1,
                      inverse)
        Ar = tr.transpose(-1, -2)
        Ai = ti.transpose(-1, -2)
    twr, twi = _fourstep_twiddle(n1, n2, inverse, xr.dtype, xr.device)
    Tr, Ti = fused_fft._cmul_tab(Ar, Ai, twr, twi)
    Yr, Yi = sfft(Tr.reshape(-1, n2), Ti.reshape(-1, n2), n2, inverse)
    Yr = Yr.reshape(lead + (n1, n2)).transpose(-1, -2).reshape(lead + (n,))
    Yi = Yi.reshape(lead + (n1, n2)).transpose(-1, -2).reshape(lead + (n,))
    return Yr, Yi


def _bluestein(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    m, cr, ci, br, bi = plan.device_tables(n, xr.dtype, xr.device).bluestein
    if inverse:
        ci = -ci
        bi = -bi
    ar, ai = fused_fft._cmul_tab(xr, xi, cr, ci)
    ar = F.pad(ar, (0, m - n))
    ai = F.pad(ai, (0, m - n))
    Ar, Ai = sfft(ar, ai, m, inverse=False)
    Cr, Ci = fused_fft._cmul_tab(Ar, Ai, br, bi)
    Er, Ei = sfft(Cr, Ci, m, inverse=True)
    s = scale / m
    Er = Er[..., :n] * s
    Ei = Ei[..., :n] * s
    return fused_fft._cmul_tab(Er, Ei, cr, ci)


def sfft(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    """Mixed-radix DFT over the last axis of an (re, im) pair, unscaled
    unless ``scale`` is given.  Dispatch on (n, dtype) only: K1 and the
    K5 split apply ``scale`` in their store, Bluestein in its own 1/m
    multiply, every other engine with one multiply at the end."""
    if plan.needs_bluestein(n):
        return _bluestein(xr, xi, n, inverse, scale)
    if fused_fft.fused_eligible(n, xr.dtype):
        return fused_fft.sfft_fused(xr, xi, n, inverse, scale)
    if stream_fft.stream_filter_eligible(n, xr.dtype):
        # K3, or past its cap (2^20, 2^21) the K5 split
        return stream_fft.sfft_stream_split(xr, xi, n, inverse, scale)
    if n == 1:
        yr, yi = xr, xi
    else:
        yr, yi = _fourstep_local(xr, xi, n, inverse)
    if scale != 1.0:
        with span("cfftpack.scale"):
            yr, yi = yr * scale, yi * scale
    return yr, yi


# ------------------------------------------------- the API's passes

def complex_pass(x, axis: int, inverse: bool, scale: float):
    """The DFT over ``axis`` of the complex tensor ``x``, times ``scale``:
    on the last axis at a length K1's interleaved mode takes
    (``fused_fft.cplx_eligible``), that mode on the complex tensor itself;
    otherwise :func:`scaled_pass` over its planes, joined by
    ``torch.complex``.  ``profiling.complex_maps`` counts the routes."""
    n = x.shape[axis]
    if axis % x.ndim == x.ndim - 1 and fused_fft.cplx_eligible(n, x.dtype):
        profiling.complex_maps["interleaved"] += 1
        return fused_fft.cfft_interleaved(x, n, inverse, scale)
    profiling.complex_maps["planes"] += 1
    yr, yi = scaled_pass(x.real, x.imag, axis, inverse, scale)
    with span("cfftpack.unpack"):
        return torch.complex(yr, yi)


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


def scaled_pass(xr, xi, axis: int, inverse: bool, scale: float,
                impl: str = "xla"):
    """One pass over ``axis`` of same-dtype real planes, times ``scale``
    (a norm's, or the parallel layer's share of a whole transform's).
    ``impl="xla"``: K6 in the natural layout for an eligible axis -2,
    else :func:`sfft` on the axis moved last.  ``impl="pallas"``: the
    axis moved last and :func:`_kernel_engine`.  The engine applies the
    scale in a kernel's store where it can (K6, K1, K5) and with one
    multiply otherwise."""
    n = xr.shape[axis]
    if (impl == "xla" and xr.ndim >= 2 and axis % xr.ndim == xr.ndim - 2
            and colfft.colfft_eligible(n, xr.shape[-1], xr.dtype)):
        return colfft.scolfft(xr, xi, inverse, scale=scale)
    engine = _kernel_engine if impl == "pallas" else sfft
    yr, yi = engine(xr.movedim(axis, -1), xi.movedim(axis, -1), n, inverse,
                    scale)
    return yr.movedim(-1, axis), yi.movedim(-1, axis)


# ------------------------------------------------------- real transforms
#
# Even n: the half-length complex trick, the split/merge stage fused into
# one table FMA over (Z, Z-mirror) (``plan.real_tables``).

def _srfft_batchpair(x, n: int):
    """r2c via batch pairing: one length-n complex FFT at batch/2.

    U = rfft(x[2r]), V = rfft(x[2r+1]) from Z = fft(x[2r] + i x[2r+1]):
    U = (Z + conj(Zm))/2, V = -i(Z - conj(Zm))/2, Zm_k = Z_{(n-k)%n}.
    """
    lead = x.shape[:-1]
    B = x.shape[:-1].numel()
    h = n // 2
    xp = x.reshape(B // 2, 2, n)
    Zr, Zi = sfft(xp[:, 0], xp[:, 1], n, inverse=False)
    with span("cfftpack.merge"):
        Z0r = Zr[..., : h + 1]
        Z0i = Zi[..., : h + 1]
        # Zm bins 0..h: bin 0 is Z_0; k>=1 reads Z_{n-k} = slice+flip
        Zmr = torch.cat([Zr[..., :1], Zr[..., n - h:].flip(-1)], dim=-1)
        Zmi = torch.cat([Zi[..., :1], Zi[..., n - h:].flip(-1)], dim=-1)
        Ur = 0.5 * (Z0r + Zmr)
        Ui = 0.5 * (Z0i - Zmi)
        Vr = 0.5 * (Z0i + Zmi)
        Vi = 0.5 * (Zmr - Z0r)
    with span("cfftpack.unpack"):
        yr = torch.stack([Ur, Vr], dim=-2).reshape(lead + (h + 1,))
        yi = torch.stack([Ui, Vi], dim=-2).reshape(lead + (h + 1,))
    return yr, yi


def _sirfft_batchpair(yr, yi, n: int):
    """c2r inverse via batch pairing: rebuild Z = U + iV for row pairs,
    one length-n inverse FFT at batch/2; u = Re, v = Im.  Returns n*x."""
    lead = yr.shape[:-1]
    B = yr.shape[:-1].numel()
    h = n // 2
    ar = yr.reshape(B // 2, 2, h + 1)
    ai = yi.reshape(B // 2, 2, h + 1)
    Ur, Vr = ar[:, 0], ar[:, 1]
    Ui, Vi = ai[:, 0], ai[:, 1]
    with span("cfftpack.merge"):
        # bins 0..h: Z = U + iV; bins h+1..n-1: conj(U_{n-k}) +
        # i conj(V_{n-k})
        Zr_low = Ur - Vi
        Zi_low = Ui + Vr
        Umr = Ur[..., 1: n - h].flip(-1)
        Umi = Ui[..., 1: n - h].flip(-1)
        Vmr = Vr[..., 1: n - h].flip(-1)
        Vmi = Vi[..., 1: n - h].flip(-1)
        Zr = torch.cat([Zr_low, Umr + Vmi], dim=-1)
        Zi = torch.cat([Zi_low, Vmr - Umi], dim=-1)
    zr, zi = sfft(Zr, Zi, n, inverse=True)
    with span("cfftpack.unpack"):
        return torch.stack([zr, zi], dim=-2).reshape(lead + (n,))


def _use_pair(n: int, B: int) -> bool:
    """Odd n with an even flat batch: the half-length trick does not
    apply, so pairing rows halves the FFT work outright."""
    return B % 2 == 0 and B >= 2 and n > 1 and n % 2 == 1


def _use_rstream(n: int, B: int, dtype, split: bool = False) -> bool:
    """The stream kernels' real routes, on structural conditions only:
    float32, an even flat batch whose rows pair into complex ones, and a
    length whose half K1 does not take (n >= 30720), where the half-length
    route would run K3 at n/2 between deinterleave and merge passes.  The
    real-stream route (K7) for r2c, c2r and DCT-II/III takes the stream
    lengths (``rstream_eligible``); the streaming filter (``split``: K2 and
    K4, or the K5 split) also those past the cap."""
    if split:
        pairs = (B % 2 == 0 and B >= 2
                 and stream_fft.stream_filter_eligible(n, dtype))
    else:
        pairs = rstream.rstream_eligible(n, dtype, B)
    return pairs and not fused_fft.fused_eligible(n // 2, dtype)


def srfft(x, n: int, scale: float = 1.0):
    """r2c DFT of real x -> (re, im) pair of n//2+1 bins, times ``scale``
    (unscaled by default).

    Even n: the real-stream route (K7) where ``_use_rstream``, K1's r2c
    mode (``fused_fft.srfft_real``) where n/2 is a register length, both
    with the scale in their store, else the half-length complex trick
    with the fused merge stage; odd n: row pairing, or the complex FFT of
    (x, 0), truncated.  imag(DC) and (even n) imag(Nyquist) are exact
    zeros.
    """
    if _use_rstream(n, x.shape[:-1].numel(), x.dtype):
        return rstream.srfft_stream(x, n, scale)
    if fused_fft.real_eligible(n, x.dtype):
        return fused_fft.srfft_real(x, n, scale)
    yr, yi = _srfft(x, n)
    if scale != 1.0:
        with span("cfftpack.scale"):
            yr, yi = yr * scale, yi * scale
    return yr, yi


def _srfft(x, n: int):
    """srfft, unscaled, off the K7 and K1 real routes."""
    if n == 1:
        return x, torch.zeros_like(x)
    if _use_pair(n, x.shape[:-1].numel()):
        return _srfft_batchpair(x, n)
    if n % 2 == 0:
        Zr, Zi = sfft(x[..., 0::2], x[..., 1::2], n // 2, inverse=False)
        tab = plan.device_tables(n, x.dtype, x.device).real["rfft"]
        with span("cfftpack.merge"):
            return fused_fft._real_merge(Zr, Zi, tab)
    with span("cfftpack.pack"):
        zi = torch.zeros_like(x)
    Yr, Yi = sfft(x, zi, n, inverse=False)
    with span("cfftpack.merge"):
        yr = Yr[..., : n // 2 + 1]
        yi = Yi[..., : n // 2 + 1].clone()
        yi[..., 0] = 0.0
    return yr, yi


def sirfft(yr, yi, n: int, scale: float = 1.0):
    """c2r inverse of a packed pair: returns n * scale * x (real); the K7
    route and K1's c2r mode (``fused_fft.sirfft_real``, where n/2 is a
    register length) apply the scale in their store."""
    if _use_rstream(n, yr.shape[:-1].numel(), yr.dtype):
        return rstream.sirfft_stream(yr, yi, n, scale)
    if fused_fft.real_eligible(n, yr.dtype):
        return fused_fft.sirfft_real(yr, yi, n, scale)
    x = _sirfft(yr, yi, n)
    if scale != 1.0:
        with span("cfftpack.scale"):
            x = x * scale
    return x


def _sirfft(yr, yi, n: int):
    """sirfft, unscaled, off the K7 and K1 real routes."""
    if n == 1:
        return yr[..., 0:1]
    if _use_pair(n, yr.shape[:-1].numel()):
        return _sirfft_batchpair(yr, yi, n)
    if n % 2 == 0:
        tab = plan.device_tables(n, yr.dtype, yr.device).real["irfft"]
        with span("cfftpack.merge"):
            Zr, Zi = fused_fft._real_unmerge(yr, yi, tab)
        zr, zi = sfft(Zr, Zi, n // 2, inverse=True)
        with span("cfftpack.unpack"):
            return fused_fft._interleave(zr, zi)
    with span("cfftpack.merge"):
        tr = yr[..., 1:].flip(-1)
        ti = -yi[..., 1:].flip(-1)
        Zr = torch.cat([yr, tr], dim=-1)
        Zi = torch.cat([yi, ti], dim=-1)
    zr, _ = sfft(Zr, Zi, n, inverse=True)
    return zr


# ------------------------------------------------------- real filter

def _rfilter_fused(x, fr, fi, n: int):
    """Fused filter body (even n): deinterleave -> one n/2 complex FFT
    -> one half-spectrum FMA -> inverse FFT -> interleave."""
    h = n // 2
    Zr, Zi = sfft(x[..., 0::2], x[..., 1::2], h, inverse=False)
    c1r, c1i, c2r, c2i, c3r, c3i, c4r, c4i = plan.device_tables(
        n, x.dtype, x.device).rfilter
    Fr, Fi = fr[..., :h], fi[..., :h]
    # conj(Fm): Fm_k = F_{h-k}, k = 0..h-1
    Fmr = fr[..., 1:].flip(-1)
    Fmi = -fi[..., 1:].flip(-1)
    Pr = c1r * Fr - c1i * Fi + c3r * Fmr - c3i * Fmi
    Pi = c1r * Fi + c1i * Fr + c3r * Fmi + c3i * Fmr
    Qr = c2r * Fr - c2i * Fi + c4r * Fmr - c4i * Fmi
    Qi = c2r * Fi + c2i * Fr + c4r * Fmi + c4i * Fmr

    def zmul(pr, pi, qr, qi, Ar, Ai, Br, Bi):
        # (pr+ipi)(Ar+iAi) + (qr+iqi)(Br-iBi)
        re = pr * Ar - pi * Ai + qr * Br + qi * Bi
        im = pr * Ai + pi * Ar + qi * Br - qr * Bi
        return re, im

    # Z' = P*Z + Q*conj(Zm); bin 0 is its own mirror
    Z0r, Z0i = zmul(Pr[..., :1], Pi[..., :1], Qr[..., :1], Qi[..., :1],
                    Zr[..., :1], Zi[..., :1], Zr[..., :1], Zi[..., :1])
    Zcr, Zci = zmul(Pr[..., 1:], Pi[..., 1:], Qr[..., 1:], Qi[..., 1:],
                    Zr[..., 1:], Zi[..., 1:], Zr[..., 1:].flip(-1),
                    Zi[..., 1:].flip(-1))
    wr, wi = sfft(torch.cat([Z0r, Zcr], dim=-1),
                  torch.cat([Z0i, Zci], dim=-1), h, inverse=True)
    with span("cfftpack.unpack"):
        return fused_fft._interleave(wr, wi)


def _rfilter_stream(x, fr, fi, n: int, scale: float):
    """Large-n filter times ``scale``: rows paired, K2 forward to the
    permuted spectrum, the multiply fused into K4's inverse and the scale
    into its store; no deinterleave, merge or interleave pass."""
    h = n // 2
    ffr = torch.cat([fr, fr[1:h].flip(-1)])
    ffi = torch.cat([fi, -fi[1:h].flip(-1)])
    return stream_fft.sfilter_stream(x, ffr, ffi, n, scale)


def srfilter(x, fr, fi, n: int, scale: float = 1.0):
    """``sirfft(srfft(x) * (fr + i fi), n)`` times ``scale`` over the last
    axis of the real rows ``x``, ``(fr, fi)`` the packed n//2+1-bin filter
    with real DC and (even n) Nyquist bins.  Odd n: the composition; even
    n: the streaming filter (K2 and K4, or the K5 split, with the scale in
    the last store) where ``_use_rstream(..., split=True)`` holds and one
    filter serves every row, else the fused body (:func:`_rfilter_fused`),
    one half-length FFT each way and no packed spectrum."""
    if n % 2:
        # odd n: plain composition (no half-length packing to fuse)
        yr, yi = srfft(x, n)
        out = sirfft(yr * fr - yi * fi, yr * fi + yi * fr, n)
    elif (fr.ndim == 1 and fi.ndim == 1
          and _use_rstream(n, x.shape[:-1].numel(), x.dtype, split=True)):
        # the scale rides in the store of K4 (or K5 past the cap)
        return _rfilter_stream(x, fr, fi, n, scale)
    else:
        out = _rfilter_fused(x, fr, fi, n)
    # the unscaled pipeline is sirfft(srfft(x)*F); the public
    # composition applies fwd_scale then inv_scale on top
    if scale != 1.0:
        with span("cfftpack.scale"):
            out = out * scale
    return out


# ----------------------------------------------- shifted DFT (split)

@functools.lru_cache(maxsize=64)
def _shifted_phases(n: int, m: int, a: float, b: float, nout: int, dtype,
                    device):
    """Pre-phase e^{-2i pi (j+a) b/m} (j < n, the nonzero part of the
    pad) and post-phase e^{-2i pi k a/m} (k < nout), built in float64."""
    j = np.arange(m)
    pre = np.exp(-2j * np.pi * (j + a) * b / m)[:n]
    k = np.arange(nout)
    post = np.exp(-2j * np.pi * k * a / m)
    return tuple(plan.to_device(t, dtype, device)
                 for t in (pre.real, pre.imag, post.real, post.imag))


def s_shifted_dft_real(x, n: int, m: int, a: float, b: float, nout: int):
    """U[k] = sum_{j<n} x[j] e^{-2i pi (j+a)(k+b)/m} for real x,
    zero-padded to m, as an (re, im) pair of nout bins: a pre-phase, the
    pad, one ``sfft`` of length m and a post-phase (the odd-n DCT-IV)."""
    prer, prei, pr, pi_ = _shifted_phases(n, m, float(a), float(b), nout,
                                          x.dtype, x.device)
    ar = F.pad(x * prer, (0, m - n))
    ai = F.pad(x * prei, (0, m - n))
    Ar, Ai = sfft(ar, ai, m, inverse=False)
    Ar = Ar[..., :nout]
    Ai = Ai[..., :nout]
    return Ar * pr - Ai * pi_, Ar * pi_ + Ai * pr
