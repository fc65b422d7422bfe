"""Split-complex (re, im) transform engine (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/core.py``.  The engine works on
pairs of real tensors: mixed-radix Stockham autosort (radix 2/3/4/5
closed forms, dense odd radices up to 31), Bluestein for larger prime
factors, the in-core four-step past K1's shared-memory cap, and the
real transforms built on the complex one.  Host tables are float64
(``plan``), cast to the working dtype once per device plan.

Dispatch depends only on (n, dtype): Bluestein, else K1
(``fused_fft.sfft_fused``), else for float32 the stream kernel K3 or,
past its cap, the s-way split K5 (``stream_fft.sfft_stream_split``),
else the four-step whose row transforms recurse here.  ``sfft`` takes
an optional scale, which K1 and K5 apply in their store.  Real
transforms of float32 stream lengths with an even batch past K1's half
length take the real-stream kernel (K7, ``rstream``); even n whose half
K1 runs in registers take K1's real modes (``fused_fft.srfft_real``,
``sirfft_real``: the deinterleave, the packed merge or unmerge, the
scale and the interleave in one launch, each direction one linear map
under autograd).  The device decides one thing only, inside the
kernels' wrappers: a CPU tensor runs the plain version (``_stockham``
below for K1), a CUDA tensor launches the kernel.  Elsewhere the real
transforms' steps around the engine run in the spans ``cfftpack.merge``
(the packed spectrum's merge and unmerge, ``_real_merge`` and
``_real_unmerge`` over a table set of ``real_tables``),
``cfftpack.scale`` and ``cfftpack.unpack`` (``utils.profiling``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import plan
from ..utils.profiling import span
from . import fused_fft, rstream, stream_fft

__all__ = ["sfft", "srfft", "sirfft", "s_shifted_dft_real"]

_SQ3_2 = float(np.sqrt(3.0) / 2.0)
_C5_1, _S5_1 = float(np.cos(2 * np.pi / 5)), float(np.sin(2 * np.pi / 5))
_C5_2, _S5_2 = float(np.cos(4 * np.pi / 5)), float(np.sin(4 * np.pi / 5))


def _butterfly(Tr, Ti, p: int, inverse: bool, dense=None):
    """Length-p DFT over axis -2 of an (re, im) pair.

    ``dense`` is the (Dr, Di) forward DFT matrix for radices above 5.
    """
    sgn = 1.0 if inverse else -1.0
    R = [Tr[..., j, :] for j in range(p)]
    I = [Ti[..., j, :] for j in range(p)]
    if p == 1:
        return Tr, Ti
    if p == 2:
        return (torch.stack([R[0] + R[1], R[0] - R[1]], dim=-2),
                torch.stack([I[0] + I[1], I[0] - I[1]], dim=-2))
    if p == 3:
        tr, ti = R[1] + R[2], I[1] + I[2]
        dr, di = R[1] - R[2], I[1] - I[2]
        m1r = R[0] - 0.5 * tr
        m1i = I[0] - 0.5 * ti
        # m2 = sgn*1j*sq32*d  ->  re: -sgn*sq32*di, im: sgn*sq32*dr
        m2r = -(sgn * _SQ3_2) * di
        m2i = (sgn * _SQ3_2) * dr
        return (torch.stack([R[0] + tr, m1r + m2r, m1r - m2r], dim=-2),
                torch.stack([I[0] + ti, m1i + m2i, m1i - m2i], dim=-2))
    if p == 4:
        ar, ai = R[0] + R[2], I[0] + I[2]
        br, bi = R[0] - R[2], I[0] - I[2]
        cr, ci = R[1] + R[3], I[1] + I[3]
        # d = sgn*1j*(T1-T3)
        dr = -sgn * (I[1] - I[3])
        di = sgn * (R[1] - R[3])
        return (torch.stack([ar + cr, br + dr, ar - cr, br - dr], dim=-2),
                torch.stack([ai + ci, bi + di, ai - ci, bi - di], dim=-2))
    if p == 5:
        t1r, t1i = R[1] + R[4], I[1] + I[4]
        t2r, t2i = R[2] + R[3], I[2] + I[3]
        t3r, t3i = R[1] - R[4], I[1] - I[4]
        t4r, t4i = R[2] - R[3], I[2] - I[3]
        u0r, u0i = R[0] + t1r + t2r, I[0] + t1i + t2i
        a1r = R[0] + _C5_1 * t1r + _C5_2 * t2r
        a1i = I[0] + _C5_1 * t1i + _C5_2 * t2i
        a2r = R[0] + _C5_2 * t1r + _C5_1 * t2r
        a2i = I[0] + _C5_2 * t1i + _C5_1 * t2i
        # b1 = sgn*1j*(s1*t3 + s2*t4); b2 = sgn*1j*(s2*t3 - s1*t4)
        b1r = -sgn * (_S5_1 * t3i + _S5_2 * t4i)
        b1i = sgn * (_S5_1 * t3r + _S5_2 * t4r)
        b2r = -sgn * (_S5_2 * t3i - _S5_1 * t4i)
        b2i = sgn * (_S5_2 * t3r - _S5_1 * t4r)
        return (torch.stack([u0r, a1r + b1r, a2r + b2r, a2r - b2r,
                             a1r - b1r], dim=-2),
                torch.stack([u0i, a1i + b1i, a2i + b2i, a2i - b2i,
                             a1i - b1i], dim=-2))
    # odd radix 7..31: dense p x p DFT matrix (conjugate for the inverse)
    Dr, Di = dense
    if inverse:
        Di = -Di
    return (torch.matmul(Dr, Tr) - torch.matmul(Di, Ti),
            torch.matmul(Dr, Ti) + torch.matmul(Di, Tr))


def _stockham(xr, xi, n: int, inverse: bool):
    """Mixed-radix Stockham DFT over the last axis: K1's plain version."""
    if n == 1:
        return xr, xi
    t = plan.device_tables(n, xr.dtype, xr.device)
    shape = xr.shape
    Sr = xr.reshape(-1, 1, n)
    Si = xi.reshape(-1, 1, n)
    B = Sr.shape[0]
    L, m = 1, n
    for s, p in enumerate(t.factors):
        mn = m // p
        Ur, Ui = _butterfly(Sr.reshape(B, L, p, mn), Si.reshape(B, L, p, mn),
                            p, inverse, t.dense.get(p))
        if mn > 1:
            twr = t.twr[t.offs[s]: t.offs[s + 1]].view(p, mn)
            twi = t.twi[t.offs[s]: t.offs[s + 1]].view(p, mn)
            if inverse:
                twi = -twi
            Vr = Ur * twr - Ui * twi
            Vi = Ur * twi + Ui * twr
            Ur, Ui = Vr, Vi
        Sr = Ur.transpose(1, 2).reshape(B, L * p, mn)
        Si = Ui.transpose(1, 2).reshape(B, L * p, mn)
        L *= p
        m = mn
    return Sr.reshape(shape), Si.reshape(shape)


def _cmul_tab(xr, xi, tr, ti):
    """(xr + i xi) * (tr + i ti) with host-table (tr, ti)."""
    return xr * tr - xi * ti, xr * ti + xi * tr


# --------------------------------------------- large-n four-step (local)
#
# Past K1's shared-memory cap, lengths the stream kernels do not take
# (float64, or m not 5-smooth) run as the in-core four-step:
# x[j1*n2 + j2] as (n1, n2); DFT over j1 (axis -2, a dense matmul for
# n1 <= 64), twiddle e^{sgn 2i pi k1 j2/n}, DFT over j2 (rows, through
# _fft_any and so K1), then one (k1, k2) -> k2-major transpose.

_DENSE_N1_MAX = 64            # outer DFT as one dense matmul up to this


@functools.lru_cache(maxsize=64)
def _dense_dft(n1: int, inverse: bool, dtype, device):
    D = plan.dft_matrix(n1)
    if inverse:
        D = np.conj(D)
    return (plan.to_device(D.real, dtype, device),
            plan.to_device(D.imag, dtype, device))


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
    Dr, Di = _dense_dft(n1, inverse, xr.dtype, xr.device)
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
        tr, ti = _fft_any(x2r.transpose(-1, -2), x2i.transpose(-1, -2), n1,
                          inverse)
        Ar = tr.transpose(-1, -2)
        Ai = ti.transpose(-1, -2)
    twr, twi = _fourstep_twiddle(n1, n2, inverse, xr.dtype, xr.device)
    Tr, Ti = _cmul_tab(Ar, Ai, twr, twi)
    Yr, Yi = _fft_any(Tr.reshape(-1, n2), Ti.reshape(-1, n2), n2, inverse)
    Yr = Yr.reshape(lead + (n1, n2)).transpose(-1, -2).reshape(lead + (n,))
    Yi = Yi.reshape(lead + (n1, n2)).transpose(-1, -2).reshape(lead + (n,))
    return Yr, Yi


def _bluestein(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    m, cr, ci, br, bi = plan.device_tables(n, xr.dtype, xr.device).bluestein
    if inverse:
        ci = -ci
        bi = -bi
    ar, ai = _cmul_tab(xr, xi, cr, ci)
    ar = F.pad(ar, (0, m - n))
    ai = F.pad(ai, (0, m - n))
    Ar, Ai = _fft_any(ar, ai, m, inverse=False)
    Cr, Ci = _cmul_tab(Ar, Ai, br, bi)
    Er, Ei = _fft_any(Cr, Ci, m, inverse=True)
    s = scale / m
    Er = Er[..., :n] * s
    Ei = Ei[..., :n] * s
    return _cmul_tab(Er, Ei, cr, ci)


def _fft_any(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    """Engine dispatch on (n, dtype) only.  K1 and the K5 split apply
    ``scale`` in their store, Bluestein in its own 1/m multiply, every
    other engine with one multiply at the end."""
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


def sfft(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    """Mixed-radix DFT over the last axis of an (re, im) pair, unscaled
    unless ``scale`` is given."""
    return _fft_any(xr, xi, n, inverse, scale)


# ------------------------------------------------------- real transforms
#
# Even-n r2c/c2r use the half-length complex trick with the split/merge
# stage fused into a single 4-term table FMA over (Z, Z-mirror).
# Derivation: Y_k = Ze_k + w_k Zo_k with Ze = (Z + conj(Zm))/2,
# Zo = -i(Z - conj(Zm))/2, Zm_k = Z_{(h-k)%h}; expanding in (Zr, Zi,
# Zmr, Zmi) gives per-bin linear combinations with f64 host tables.

def _rfft_merge_tables(n: int):
    """Coefficients of (Zr, Zi, Zmr, Zmi) for yr, yi at bins 0..h-1."""
    h = n // 2
    k = np.arange(h)
    w = np.exp(-2j * np.pi * k / n)
    wr, wi = w.real, w.imag
    return ((1 + wi) / 2, wr / 2, (1 - wi) / 2, wr / 2,
            -wr / 2, (1 + wi) / 2, wr / 2, (wi - 1) / 2)


def _irfft_merge_tables(n: int):
    """Coefficients of (ya, yb, ymr, ymi) for Zr, Zi at bins 0..h-1."""
    h = n // 2
    k = np.arange(h)
    w = np.exp(-2j * np.pi * k / n)
    wr, wi = w.real, w.imag
    # Zr = (ya+ymr) - wr*(yb+ymi) + wi*(ya-ymr)
    # Zi = (yb-ymi) + wr*(ya-ymr) + wi*(yb+ymi)
    return (1 + wi, -wr, 1 - wi, -wr,
            wr, 1 + wi, -wr, wi - 1)


def _r2c_adjoint_table(t):
    """The (h, 8) c2r table of the adjoint of the r2c table ``t`` (h + 1
    bins): Zr[j] takes (a1_j, b1_j, a3_{h-j}, b3_{h-j}) of (g_r[j], g_i[j],
    g_r[h-j], g_i[h-j]), Zi[j] the same of a2, b2, a4, b4; bin 0 sums the
    terms of bins 0 and h, which both read Z[0]."""
    h = t.shape[0] - 1
    a1, a2, a3, a4, b1, b2, b3, b4 = t.T
    j = np.arange(1, h)
    out = np.empty((h, 8))
    out[1:] = np.stack([a1[j], b1[j], a3[h - j], b3[h - j],
                        a2[j], b2[j], a4[h - j], b4[h - j]], axis=-1)
    out[0] = (a1[0] + a3[0], b1[0] + b3[0], a1[h] + a3[h], b1[h] + b3[h],
              a2[0] + a4[0], b2[0] + b4[0], a2[h] + a4[h], b2[h] + b4[h])
    return out


def _c2r_adjoint_table(t):
    """The (h + 1, 8) r2c table of the adjoint of the c2r table ``t`` (h
    bins): g_r[k] takes (c1_k, d1_k) of Z[k] and (c3_{h-k}, d3_{h-k}) of
    Z[h-k], g_i[k] the same of c2, d2, c4, d4; bin h takes bin 0's mirror
    terms, read from Z[0] as its direct term."""
    h = t.shape[0]
    c1, c2, c3, c4, d1, d2, d3, d4 = t.T
    k = np.arange(1, h)
    out = np.zeros((h + 1, 8))
    out[1:h] = np.stack([c1[k], d1[k], c3[h - k], d3[h - k],
                         c2[k], d2[k], c4[h - k], d4[h - k]], axis=-1)
    out[0, [0, 1, 4, 5]] = c1[0], d1[0], c2[0], d2[0]
    out[h, [0, 1, 4, 5]] = c3[0], d3[0], c4[0], d4[0]
    return out


def real_tables(rfft_merge, irfft_merge, adjoint: bool = True) -> dict:
    """The real transforms' table sets, float64 (bins, 8) arrays, one row
    of 8 coefficients a bin (``_real_merge``, ``fused_fft.srfft_real``):
    ``rfft``, the r2c form of ``rfft_merge`` over bins 0 .. h, DC = Zr +
    Zi and Nyquist = Zr - Zi of Z[0] with zero imaginary rows; ``irfft``,
    the c2r form, ``irfft_merge`` by bin; with ``adjoint``, ``rfft_adj``
    and ``irfft_adj``, their transposes, the other form each."""
    h = len(rfft_merge[0])
    fwd = np.zeros((h + 1, 8))
    fwd[1:h] = np.stack(rfft_merge, axis=-1)[1:]
    fwd[0, :2] = 1.0, 1.0
    fwd[h, :2] = 1.0, -1.0
    inv = np.stack([np.asarray(t, dtype=np.float64) for t in irfft_merge],
                   axis=-1)
    sets = {"rfft": fwd, "irfft": inv}
    if adjoint:
        sets.update(rfft_adj=_r2c_adjoint_table(fwd),
                    irfft_adj=_c2r_adjoint_table(inv))
    return sets


def _real_merge(Zr, Zi, tab):
    """(yr, yi) at bins 0 .. h of the r2c table ``tab`` (h + 1, 8) over
    Z[k % h] and its mirror Z[(h - k) % h]: the packed merge."""
    a1, a2, a3, a4, b1, b2, b3, b4 = tab.unbind(-1)
    Zkr = torch.cat([Zr, Zr[..., :1]], dim=-1)
    Zki = torch.cat([Zi, Zi[..., :1]], dim=-1)
    Zmr = torch.cat([Zr[..., :1], Zr[..., 1:].flip(-1), Zr[..., :1]], dim=-1)
    Zmi = torch.cat([Zi[..., :1], Zi[..., 1:].flip(-1), Zi[..., :1]], dim=-1)
    return (Zkr * a1 + Zki * a2 + Zmr * a3 + Zmi * a4,
            Zkr * b1 + Zki * b2 + Zmr * b3 + Zmi * b4)


def _real_unmerge(yr, yi, tab):
    """(Zr, Zi) at bins 0 .. h-1 of the c2r table ``tab`` (h, 8) over y[k]
    and y[h - k]: the packed unmerge."""
    h = tab.shape[0]
    c1, c2, c3, c4, d1, d2, d3, d4 = tab.unbind(-1)
    ya = yr[..., :h]
    yb = yi[..., :h]
    ymr = yr[..., 1:].flip(-1)
    ymi = yi[..., 1:].flip(-1)
    return (ya * c1 + yb * c2 + ymr * c3 + ymi * c4,
            ya * d1 + yb * d2 + ymr * d3 + ymi * d4)


def _interleave(*parts):
    """Riffle s equal-length streams: out[..., s*t+j] = parts[j][..., t]."""
    lead = parts[0].shape[:-1]
    n = len(parts) * parts[0].shape[-1]
    return torch.stack(parts, dim=-1).reshape(lead + (n,))


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


def _use_rstream(n: int, B: int, dtype) -> bool:
    """The real-stream route (K7) for r2c, c2r and DCT-II/III: float32,
    an even flat batch and a stream length (``rstream_eligible``) whose
    half length K1 does not take (n >= 30720), where the half-length
    route would run K3 at n/2 between deinterleave and merge passes.
    Structural conditions only, as ``rfft._use_stream_filter``."""
    return (rstream.rstream_eligible(n, dtype, B)
            and not fused_fft.fused_eligible(n // 2, dtype))


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
            return _real_merge(Zr, Zi, tab)
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
            Zr, Zi = _real_unmerge(yr, yi, tab)
        zr, zi = sfft(Zr, Zi, n // 2, inverse=True)
        with span("cfftpack.unpack"):
            return _interleave(zr, zi)
    with span("cfftpack.merge"):
        tr = yr[..., 1:].flip(-1)
        ti = -yi[..., 1:].flip(-1)
        Zr = torch.cat([yr, tr], dim=-1)
        Zi = torch.cat([yi, ti], dim=-1)
    zr, _ = sfft(Zr, Zi, n, inverse=True)
    return zr


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
