"""DCT/DST types I-VIII over one axis, FFT-based, any length (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/dct.py``, with the same algorithms,
tables, norms and signatures:

* DCT-II/III: Makhoul's N-point algorithm, an even/odd interleave, one
  half-length complex FFT (even n) and a phase rotation, composed into
  single table FMAs (``_dct2_tables``, ``_dct3_tables``).  Float32 stream
  lengths with an even batch past K1's half length run K7 instead
  (``rstream.sdct2_stream``/``sdct3_stream``).
* DST-II/III from DCT-II/III by flips and alternating signs.
* DCT-I and DST-I through one real FFT of the even or odd extension.
* DCT-IV: for even n the half-length algorithm (pairs
  c[p] = x[2p] + i*x[n-1-2p], pre- and post-rotations around one
  n/2-point FFT); past K1 in float32 the whole of it runs as K8
  (``_dct4_stream``), the norm's scale in its store.  Odd n: the
  half-shift DFT of length 2n (``core.s_shifted_dft_real``).  DST-IV is
  a flip and sign of DCT-IV; K8 takes both into its load and store.
* Types V-VIII (the odd-period transforms): ``oddtypes``, one shifted DFT
  of length 2n-1 or 2n+1 each, through the engine's default dispatch
  (Bluestein and K1 for most n); no kernel gate of this module opens for
  them.

Spans (``utils.profiling``): off the K7 and K8 routes, the glue of types
2-4 around ``core.sfft``/``srfft``/``sirfft`` runs in the leaf spans
``cfftpack.pack`` (the Makhoul gathers, cats and flips, the DCT-III's four
gathers, the DST's input sign or flip, the DCT-IV's flip of its odd
half), ``cfftpack.merge``
(the table multiplies on either side of the FFT: the DCT-II's post-FFT FMA
and its bin-0 column, the DCT-III's pre-FFT FMA, the DCT-IV's pre- and
post-rotations), ``cfftpack.unpack`` (everything after the last table
multiply: riffles, interleaves, cats, the DCT-III's halving, the DST's
output flip or sign) and ``cfftpack.scale`` (the norm's multiply); none
holds another or a kernel's call.  K8's plain version, which shares the
DCT-IV's pair packing, opens its pack and merge spans on the CPU.

Norms: ``"fftpack"`` (and its alias ``"forward"``) puts FFTPACK's full
scale on the forward transform, ``"ortho"`` is orthonormal both ways,
``"backward"`` scales the inverse.  Float64 runs natively (the JAX
package's double-float route for TPUs has no counterpart here).  Host
tables are built in float64 and cached per (n, dtype, device).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import (DEFAULT_NORM, _apply_axis, _check_axis, _check_length,
                      as_tensor, check_norm)
from .. import plan
from ..utils.profiling import span
from . import _adjoint, colfft, core, fused_fft, oddtypes, rstream, stream_fft

__all__ = ["dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn"]

_SQRT2 = float(np.sqrt(2.0))


def _cexp_half(n: int, sign: float) -> np.ndarray:
    """exp(sign * 1j*pi*k/(2n)) for k=0..n-1 (host f64 table)."""
    k = np.arange(n)
    return np.exp(sign * 1j * np.pi / (2 * n) * k)


@functools.lru_cache(maxsize=256)
def _dev(key, n: int, dtype, device):
    """The host table ``key`` of length n as tensors of ``dtype`` on
    ``device``, cached."""
    return tuple(plan.to_device(t, dtype, device) for t in _HOST[key](n))


def _tab(key, n: int, x):
    return _dev(key, n, x.dtype, x.device)


# ---------------------------------------------------------------- cores
# All cores are unscaled: plain trig sums with FFTPACK's half-term
# conventions.

def _dct2_tables(n: int):
    """Even n.  Coefficients of (Zr, Zi, Zmr, Zmi) at output bin k,
    shaped (2, n/2) so the (B, h) operands broadcast straight to the
    (B, 2, h) output (k = c*h + j).

    y_k = Re(ph_k V_k), V_k = Ze_{k%h} + w_k Zo_{k%h}, ph = e^{-i pi
    k/(2n)}; substituting Ze/Zo in (Z, conj(Zm)) gives, with q = ph*w =
    e^{-5i pi k/(2n)}:  y = T1*Zr + T2*Zi + T3*Zmr + T4*Zmi.
    """
    h = n // 2
    k = np.arange(n)
    ph = np.exp(-1j * np.pi * k / (2 * n))
    q = np.exp(-5j * np.pi * k / (2 * n))
    T1 = (ph.real + q.imag) / 2
    T2 = (q.real - ph.imag) / 2
    T3 = (ph.real - q.imag) / 2
    T4 = (ph.imag + q.real) / 2
    return tuple(t.reshape(2, h) for t in (T1, T2, T3, T4))


def _dct2_core_tables(n: int):
    """``_dct2_tables`` as ``_dct2_core`` reads them: the interior
    columns, then the bin-0 column's (T1 + T3, T2 + T4)."""
    T1, T2, T3, T4 = _dct2_tables(n)
    return (T1[:, 1:], T2[:, 1:], T3[:, 1:], T4[:, 1:],
            (T1 + T3)[:, :1], (T2 + T4)[:, :1])


def _dct2_core(x, n: int, mode: int = -1):
    """y[k] = sum_j x[j] cos(pi*k*(2j+1)/(2n))  (Makhoul N-point), with
    the scale of norm ``mode`` (+1 fftpack forward, -1 unscaled, the
    default, 0 ortho): the K7 route applies it in its store."""
    if core._use_rstream(n, x.shape[:-1].numel(), x.dtype):
        return rstream.sdct2_stream(x, n, *_k7_norm(n, mode, 2))
    y = _dct2_unit(x, n)
    if mode < 0:  # unscaled: the reference's DCT-II side (cosq1b_)
        return y
    if mode > 0:
        with span("cfftpack.scale"):
            return y * (2.0 / n)
    w = _tab("weights", n, x)[0]            # y0*sqrt(1/n), yk*sqrt(2/n)
    with span("cfftpack.scale"):
        return y * w


def _dct2_unit(x, n: int):
    """_dct2_core, unscaled, off the K7 route."""
    if n == 1:
        return x
    if n % 2:
        # odd n: Makhoul permutation + full-length real DFT
        with span("cfftpack.pack"):
            v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
        Vr, Vi = core.srfft(v, n)                  # bins 0..n//2
        phr, phi = _tab("cexp_fwd", n, x)
        h = n // 2
        with span("cfftpack.merge"):
            y_low = phr[: h + 1] * Vr - phi[: h + 1] * Vi
            Vr_u = Vr[..., 1:].flip(-1)
            Vi_u = Vi[..., 1:].flip(-1)
            y_high = phr[h + 1:] * Vr_u + phi[h + 1:] * Vi_u
        with span("cfftpack.unpack"):
            return torch.cat([y_low, y_high], dim=-1)
    h = n // 2
    with span("cfftpack.pack"):
        if n % 4 == 0:
            # z_p = v[2p] + i v[2p+1] with v = [x_even, rev(x_odd)]
            # composes to stride-4 gathers of x
            zr = torch.cat([x[..., 0::4], x[..., 3::4].flip(-1)], dim=-1)
            zi = torch.cat([x[..., 2::4], x[..., 1::4].flip(-1)], dim=-1)
        else:
            v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
            zr = v[..., 0::2]
            zi = v[..., 1::2]
    Zr, Zi = core.sfft(zr, zi, h, inverse=False)
    t1, t2, t3, t4, c0r, c0i = _tab("dct2", n, x)
    # interior bins from slice+flip mirror operands, the bin-0 column
    # from Z_0, its own mirror
    with span("cfftpack.merge"):
        Zrc = Zr[..., None, 1:]
        Zic = Zi[..., None, 1:]
        y_c = t1 * Zrc + t2 * Zic + t3 * Zrc.flip(-1) + t4 * Zic.flip(-1)
        y_0 = c0r * Zr[..., None, :1] + c0i * Zi[..., None, :1]
    with span("cfftpack.unpack"):
        y2 = torch.cat([y_0, y_c], dim=-1)
    return y2.reshape(x.shape[:-1] + (n,))


def _dct3_tables(n: int):
    """Even n.  Coefficients of the gathered quadruple
    (x_k, x_{n-k}, x_{h-k}, x_{h+k}) for (Zr, Zi) at bins k = 0..h-1:
    the DCT-III phase stage V_k = ph_k (x_k - i x_{n-k}) composed with
    the c2r merge, so the pre-FFT pipeline is one table FMA."""
    h = n // 2
    k = np.arange(h)
    ph = np.exp(1j * np.pi * k / (2 * n))
    phr, phi = ph.real, ph.imag
    phF = np.exp(1j * np.pi * (h - k) / (2 * n))
    phrF, phiF = phF.real, phF.imag
    w = np.exp(-2j * np.pi * k / n)
    wr, wi = w.real, w.imag
    A = (phr * (1 + wi) - wr * phi, phi * (1 + wi) + wr * phr,
         phrF * (1 - wi) - wr * phiF, phiF * (1 - wi) + wr * phrF)
    B = (phi * (1 + wi) + wr * phr, -phr * (1 + wi) + wr * phi,
         -phiF * (1 - wi) - wr * phrF, phrF * (1 - wi) - wr * phiF)
    return A, B


def _dct3_core(x, n: int, mode: int = -1):
    """y[k] = x[0]/2 + sum_{j>=1} x[j] cos(pi*j*(2k+1)/(2n)), with the
    scale of norm ``mode`` (unscaled by default): the K7 route applies it
    in its load and store."""
    if core._use_rstream(n, x.shape[:-1].numel(), x.dtype):
        return rstream.sdct3_stream(x, n, *_k7_norm(n, mode, 3))
    if mode < 0:
        return _dct3_unit(x, n)
    if mode > 0:  # fftpack forward (cosq1f_): 2/n overall
        y = _dct3_unit(x, n)
        with span("cfftpack.scale"):
            return y * (2.0 / n)
    # ortho (transpose of orthonormal DCT-II): input scales sqrt(2/n),
    # except 2/sqrt(n) on x0, whose 1/2 the core applies
    w = _tab("weights", n, x)[1]
    with span("cfftpack.scale"):
        x = x * w
    return _dct3_unit(x, n)


def _dct3_unit(x, n: int):
    """_dct3_core, unscaled, off the K7 route.

    Even n: four slice/flip gathers of x, one table FMA building the
    half-length spectrum, one inverse complex FFT and a 4-way riffle of
    all n outputs (for n % 4 == 2 the streams are ragged; equal-length
    (n+2)//4 streams stay in range and a tail slice drops the 2
    extras).  Odd n: phase + c2r.
    """
    if n == 1:
        return 0.5 * x
    h = n // 2
    if n % 2 == 0:
        m = (n + 2) // 4 if n % 4 else n // 4
        with span("cfftpack.pack"):
            xa = x[..., :h]                                   # x_k
            xb = torch.cat([torch.zeros_like(x[..., :1]),
                            x[..., h + 1:].flip(-1)], dim=-1)  # x_{n-k}
            xc = x[..., 1: h + 1].flip(-1)                    # x_{h-k}
            xd = x[..., h:]                                   # x_{h+k}
        a1, a2, a3, a4, b1, b2, b3, b4 = _tab("dct3", n, x)
        with span("cfftpack.merge"):
            Zr = xa * a1 + xb * a2 + xc * a3 + xd * a4
            Zi = xa * b1 + xb * b2 + xc * b3 + xd * b4
        zr, zi = core.sfft(Zr, Zi, h, inverse=True)
        with span("cfftpack.unpack"):
            zr = 0.5 * zr
            zi = 0.5 * zi
            # y[4u..4u+3] = [zr_u, zi_{h-1-u}, zi_u, zr_{h-1-u}]
            y4 = fused_fft._interleave(
                zr[..., :m], zi[..., h - m:].flip(-1), zi[..., :m],
                zr[..., h - m:].flip(-1))
        return y4[..., :n] if 4 * m != n else y4
    with span("cfftpack.pack"):
        xnk = torch.cat([torch.zeros_like(x[..., :1]), x[..., 1:].flip(-1)],
                        dim=-1)                           # x[n-k], x[n]=0
    phr, phi = _tab("cexp_inv", n, x)
    # V = ph * (x - i*xnk) is conjugate-symmetric: bins 0..n//2 and one
    # c2r inverse
    with span("cfftpack.merge"):
        Vr = (phr * x + phi * xnk)[..., : h + 1]
        Vi = (phi * x - phr * xnk)[..., : h + 1]
    v = core.sirfft(Vr, Vi, n)
    # y[2j] = v[j]/2, y[2j+1] = v[n-1-j]/2 (n odd: half evens, half-1
    # odds)
    half = (n + 1) // 2
    with span("cfftpack.unpack"):
        v = 0.5 * v
        out = torch.empty_like(v)
        out[..., 0::2] = v[..., :half]
        out[..., 1::2] = v[..., half:].flip(-1)
    return out


def _alt_sign(n: int) -> np.ndarray:
    return (-1.0) ** np.arange(n)


def _dst2_core(x, n: int, mode: int = -1):
    """y[k] = sum_j x[j] sin(pi*(k+1)*(2j+1)/(2n)) = flip(dct2((-1)^j x)),
    with the scale of norm ``mode`` (ortho's weight of y[n-1] is that of
    the DCT-II's bin 0)."""
    (s,) = _tab("alt", n, x)
    with span("cfftpack.pack"):
        xs = x * s
    y = _dct2_core(xs, n, mode)
    del xs                         # freed before the flip's output is made
    with span("cfftpack.unpack"):
        return y.flip(-1)


def _dst3_core(x, n: int, mode: int = -1):
    """y[k] = (-1)^k x[n-1]/2 + sum_{j<n-1} x[j] sin(pi*(j+1)*(2k+1)/(2n)),
    with the scale of norm ``mode`` (ortho's weight of x[n-1] is that of
    the DCT-III's x[0])."""
    (s,) = _tab("alt", n, x)
    with span("cfftpack.pack"):
        xf = x.flip(-1)
    y = _dct3_core(xf, n, mode)
    del xf
    with span("cfftpack.unpack"):
        return s * y


def _dct1_re(x, n: int):
    """Re(DFT of the even extension): x0 + (-1)^k x_{n-1} + 2*sum_mid."""
    ext = torch.cat([x, x[..., 1:-1].flip(-1)], dim=-1)
    yr, _ = core.srfft(ext, 2 * (n - 1))  # bins 0..n-1
    return yr


def _dst1_core(x, n: int):
    """y[k] = sum_j x[j] sin(pi*(j+1)*(k+1)/(n+1)) via odd extension."""
    z = torch.zeros_like(x[..., :1])
    ext = torch.cat([z, x, z, -x.flip(-1)], dim=-1)
    _, yi = core.srfft(ext, 2 * (n + 1))  # bins 0..n+1
    return (-0.5) * yi[..., 1: n + 1]


# the pre-rotation and post-phase of even n (K8's tables, built where
# its launch plan builds them), and the post-phase in the permuted layout
_dct4_phases = rstream._dct4_phases
_dct4_post_perm = rstream._dct4_post_perm


def _dct4_pack(x, n: int):
    """Even n: the pairs c[p] = x[2p] + i*x[n-1-2p] times the
    pre-rotation e^{-i pi p/n}, the odd half's flip (x[n-1-2p]) under
    ``cfftpack.pack`` and the product under ``cfftpack.merge``."""
    prer, prei = _tab("dct4", n, x)[:2]
    with span("cfftpack.pack"):
        xo = x[..., 1::2].flip(-1)
    with span("cfftpack.merge"):
        return fused_fft._cmul_tab(x[..., 0::2], xo, prer, prei)


def _dct4_stream_ok(n: int, dtype) -> bool:
    """K8's gate: float32, even n whose half length is a stream length
    that K1 does not take (n >= 32768)."""
    if n % 2:
        return False
    h = n // 2
    return (stream_fft.stream_eligible(h, dtype)
            and not fused_fft.fused_eligible(h, dtype))


def _dct4_stream_tail(wr, wi, n: int, post):
    """The reference's permuted-stream tail (``dct._dct4_stream_tail``):
    the half-length FFT with permuted output through the stream passes'
    plain version, the post-phase in that layout, then un-permute, flip
    and riffle:

        y[2t]   =  Re z[t]        t = k2 + m*k1  at perm [k2, k1]
        y[2t+1] = -Im z[h-1-t]    (h-1-t lives at perm [m-1-k2, 127-k1])

    ``post`` is the (m, 128) permuted post-phase pair.
    """
    h = n // 2
    m = h // 128
    lead = wr.shape[:-1]
    Zr, Zi = stream_fft.stream_plain(wr.reshape(-1, m, 128),
                                     wi.reshape(-1, m, 128), h, "fwd")
    zr, zi = fused_fft._cmul_tab(Zr, Zi, *post)
    A = zr.transpose(-1, -2).reshape(lead + (h,))
    Bm = zi.flip((-2, -1)).transpose(-1, -2).reshape(lead + (h,))
    return fused_fft._interleave(A, -Bm)


def _dct4_stream_plain(x, n: int, scale: float = 1.0, dst: bool = False):
    """K8's plain version on any device: the pair packing and
    pre-rotation, then :func:`_dct4_stream_tail`, times ``scale``; with
    ``dst`` the DST-IV, (-1)^k of the DCT-IV of flip(x)."""
    if dst:
        x = x.flip(-1)
    wr, wi = _dct4_pack(x, n)
    y = _dct4_stream_tail(wr, wi, n, _tab("dct4_post_perm", n, x))
    if dst:
        y = y * _tab("alt", n, x)[0]
    return y * scale if scale != 1.0 else y


def _dct4_stream(x, n: int, scale: float = 1.0, dst: bool = False):
    """Even-n DCT-IV (DST-IV with ``dst``) times ``scale`` through K8 on
    a CUDA tensor (or raises), its plain version on a CPU tensor.  Both
    matrices are symmetric, so the adjoint is the same call."""
    if _adjoint.needs_grad(x):
        return _adjoint.linear(lambda v: _dct4_stream(v, n, scale, dst),
                               lambda g: _dct4_stream(g, n, scale, dst), x)
    if x.device.type == "cpu":
        return _dct4_stream_plain(x, n, scale, dst)
    out = rstream.launch("dct4", n, x, scale=scale, dst=dst)
    return out.reshape(x.shape)


def _dct4_core(x, n: int, scale: float = 1.0, dst: bool = False):
    """y[k] = sum_j x[j] cos(pi*(k+.5)*(j+.5)/n), times ``scale``; with
    ``dst`` the DST-IV (see :func:`_dst4_core`).

    Even n: pack c[p] = x[2p] + i*x[n-1-2p], pre-/post-rotations around
    one n/2-point FFT; y[2t] = Re z[t], y[2t+1] = -Im z[h-1-t] (K8 past
    K1 in float32, the flip, sign and scale in its load and store).
    Odd n: the half-shift DFT of length 2n.
    """
    if n % 2 == 0 and n >= 4 and _dct4_stream_ok(n, x.dtype):
        return _dct4_stream(x, n, scale, dst)
    if dst:
        (s,) = _tab("alt", n, x)
        with span("cfftpack.pack"):
            xf = x.flip(-1)
        y = _dct4_core(xf, n, scale)
        del xf
        with span("cfftpack.unpack"):
            return s * y
    if n % 2 == 0 and n >= 4:
        Wr, Wi = core.sfft(*_dct4_pack(x, n), n // 2, inverse=False)
        postr, posti = _tab("dct4", n, x)[2:]
        with span("cfftpack.merge"):
            zr, zi = fused_fft._cmul_tab(Wr, Wi, postr, posti)
        with span("cfftpack.unpack"):
            y = fused_fft._interleave(zr, -zi.flip(-1))
    else:
        # U[k] = sum_{j<2n} xpad[j] e^{-2i pi (j+.5)(k+.5)/(2n)}
        y, _ = core.s_shifted_dft_real(x, n, 2 * n, 0.5, 0.5, n)
    if scale == 1.0:
        return y
    with span("cfftpack.scale"):
        return y * scale


def _dst4_core(x, n: int, scale: float = 1.0):
    """y[k] = sum_j x[j] sin(pi*(k+.5)*(j+.5)/n) = (-1)^k dct4(flip(x)),
    times ``scale``."""
    return _dct4_core(x, n, scale, dst=True)


def _ends_weight(n: int, w: float) -> np.ndarray:
    v = np.ones(n)
    v[0] = w
    v[-1] = w
    return v


def _weights(n: int):
    """Scale vectors of the ortho norms: the DCT-II output and DCT-III
    input weights (the DST-II/III's, flipped) and the DCT-I end weights
    (1/2 and 1/sqrt 2)."""
    c2 = np.full(n, np.sqrt(2.0 / n))
    c2[0] = np.sqrt(1.0 / n)
    c3 = np.full(n, np.sqrt(2.0 / n))
    c3[0] = 2.0 / np.sqrt(n)
    return c2, c3, _ends_weight(n, 0.5), _ends_weight(n, 1.0 / _SQRT2)


def _reim(*cs):
    return tuple(p for c in cs for p in (c.real, c.imag))


_HOST = {
    "cexp_fwd": lambda n: _reim(_cexp_half(n, -1.0)),
    "cexp_inv": lambda n: _reim(_cexp_half(n, +1.0)),
    "dct2": _dct2_core_tables,
    "dct3": lambda n: sum(_dct3_tables(n), ()),
    "dct4": lambda n: _reim(*_dct4_phases(n)),
    "dct4_post_perm": _dct4_post_perm,
    "alt": lambda n: (_alt_sign(n),),
    "weights": _weights,
}


# ------------------------------------------------------ scaling wrappers
# mode: +1 fftpack forward scale, -1 unscaled, 0 ortho

def _dct1_apply(x, n: int, mode: int):
    """DCT-I; ortho reproduces the reference's hand-built orthonormal
    DCT-I (cfftpack.c:249-279) in closed form."""
    if n < 2:
        raise ValueError("dct type 1 requires n >= 2")
    M = n - 1.0
    re = _dct1_re(x, n)
    (sgn,) = _tab("alt", n, x)
    x0 = x[..., :1]
    xN = x[..., -1:]
    half_ends, rt_ends = _tab("weights", n, x)[2:]
    if mode > 0:  # fftpack forward: (x0/2 + sum + (-1)^k xN/2)*(2/M)
        return re * (1.0 / M) * half_ends
    if mode < 0:  # unscaled: x0 + (-1)^k xN + sum
        return 0.5 * re + 0.5 * (x0 + sgn * xN)
    # ortho: sqrt(2/M)*(x0/sqrt2 + sum + (-1)^k xN/sqrt2), ends /sqrt2
    c = 1.0 / _SQRT2 - 0.5
    y = 0.5 * re + c * (x0 + sgn * xN)
    return y * float(np.sqrt(2.0 / M)) * rt_ends


def _dst1_apply(x, n: int, mode: int):
    y = _dst1_core(x, n)
    if mode > 0:
        return y * (2.0 / (n + 1))
    if mode < 0:
        return y
    return y * float(np.sqrt(2.0 / (n + 1)))


def _k7_norm(n: int, mode: int, t: int):
    """The norm ``mode`` of DCT/DST type t (2 or 3) as K7 takes it:
    (scale, w0), w0 the extra weight of the DCT-II's bin 0 or the
    DCT-III's x[0]."""
    if mode < 0:
        return 1.0, 1.0
    if mode > 0:
        return 2.0 / n, 1.0
    # ortho: sqrt(2/n) throughout; the DCT-II output's bin 0 sqrt(1/n),
    # the DCT-III input's x0 2/sqrt(n)
    return (float(np.sqrt(2.0 / n)),
            float(np.sqrt(0.5)) if t == 2 else _SQRT2)


def _type4_scale(n: int, mode: int) -> float:
    """The scale of norm ``mode`` of DCT/DST type 4."""
    if mode > 0:
        return 2.0 / n
    if mode < 0:
        return 1.0
    return float(np.sqrt(2.0 / n))


def _dct4_apply(x, n: int, mode: int):
    return _dct4_core(x, n, _type4_scale(n, mode))


def _dst4_apply(x, n: int, mode: int):
    return _dst4_core(x, n, _type4_scale(n, mode))


_FWD = {1: _dct1_apply, 2: _dct2_core, 3: _dct3_core, 4: _dct4_apply,
        5: oddtypes.dct5_apply, 6: oddtypes.dct6_apply,
        7: oddtypes.dct7_apply, 8: oddtypes.dct8_apply}
_FWD_S = {1: _dst1_apply, 2: _dst2_core, 3: _dst3_core, 4: _dst4_apply,
          5: oddtypes.dst5_apply, 6: oddtypes.dst6_apply,
          7: oddtypes.dst7_apply, 8: oddtypes.dst8_apply}
# operator inverse of each type (I/IV/V/VIII are involutions up to scale;
# VI and VII are transposes of each other, Martucci 1994)
_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4, 5: 5, 6: 7, 7: 6, 8: 8}


def _norm_modes(norm: str) -> tuple[int, int]:
    """(forward mode, inverse mode) per norm: fftpack/forward scale the
    forward fully and leave the inverse unscaled; ortho is orthonormal
    both ways; backward puts the full scale on the inverse."""
    if norm in ("fftpack", "forward"):
        return 1, -1
    if norm == "ortho":
        return 0, 0
    return -1, 1  # backward


def _check_type(t) -> int:
    t = int(t)
    if t not in (1, 2, 3, 4, 5, 6, 7, 8):
        raise ValueError(f"transform type must be 1..8, got {t}")
    return t


def _prep_real(x):
    """A real floating tensor: complex input raises, integers become
    float64, floats narrower than 32 bits widen to float32."""
    x = as_tensor(x)
    if x.is_complex():
        raise TypeError("DCT/DST require real input")
    if not x.dtype.is_floating_point:
        return x.to(torch.float64)
    if torch.finfo(x.dtype).bits < 32:
        return x.to(torch.float32)
    return x


def _coldct_ok(x, n0: int) -> bool:
    """K9's gate: float32 images, a leading axis whose flat image count
    is even (two images pair into one complex column transform), and a
    length the column kernel takes (even, as every such length is)."""
    if x.dtype != torch.float32 or x.ndim < 3:
        return False
    if x.shape[:-2].numel() % 2:
        return False
    return colfft.colfft_eligible(n0, x.shape[-1], x.dtype)


def _coldct(x, t: int, n: int, mode: int):
    """DCT-II/III over axis -2 through K9, the norm's scale and ortho
    row weights fused into the kernel: the ``2/n`` of the scaled modes,
    the DCT-II output weight and the DCT-III input weight of ortho."""
    if mode > 0:
        return colfft.scoldct(x, t, scale=2.0 / n)
    if mode == 0:
        return colfft.scoldct(x, t, w=_tab("weights", n, x)[t - 2])
    return colfft.scoldct(x, t)


def _run(table, t: int, x, axis: int, mode: int):
    _check_axis(x, axis)
    n = x.shape[axis]
    _check_length(n)
    # the column route is the DCT's: the DST cores (flips and signs
    # around the DCT's) keep the moved axis
    if (table is _FWD and t in (2, 3) and axis % x.ndim == x.ndim - 2
            and _coldct_ok(x, n)):
        return _coldct(x, t, n, mode)
    return _apply_axis(x, axis, lambda v: table[t](v, n, mode))


def _dct_impl(x, t: int, axis: int, norm: str, inverse: bool):
    fm, im = _norm_modes(norm)
    if inverse:
        return _run(_FWD, _INV_TYPE[t], x, axis, im)
    return _run(_FWD, t, x, axis, fm)


def _dst_impl(x, t: int, axis: int, norm: str, inverse: bool):
    fm, im = _norm_modes(norm)
    if inverse:
        return _run(_FWD_S, _INV_TYPE[t], x, axis, im)
    return _run(_FWD_S, t, x, axis, fm)


def dct(x, type: int = 2, axis: int = -1, norm: str = DEFAULT_NORM):
    """Forward DCT of the given type (1-8) along ``axis``.

    norm="fftpack" follows the reference pairing: the forward carries
    FFTPACK's full scale, 2/n for types 2, 3 and 4 (the DCT-III's is
    cosq1f's), and ``idct`` none (the DCT-II's unscaled side is cosq1b's);
    ``idct`` undoes ``dct`` for every norm.
    """
    return _dct_impl(_prep_real(x), _check_type(type), axis,
                     check_norm(norm), False)


def idct(x, type: int = 2, axis: int = -1, norm: str = DEFAULT_NORM):
    """Inverse DCT: idct(dct(x, type=t), type=t) == x for every norm."""
    return _dct_impl(_prep_real(x), _check_type(type), axis,
                     check_norm(norm), True)


def dst(x, type: int = 2, axis: int = -1, norm: str = DEFAULT_NORM):
    """Forward DST of the given type along ``axis``; under
    norm="fftpack" scaled as :func:`dct` (2/n for types 2, 3 and 4)."""
    return _dst_impl(_prep_real(x), _check_type(type), axis,
                     check_norm(norm), False)


def idst(x, type: int = 2, axis: int = -1, norm: str = DEFAULT_NORM):
    """Inverse DST: idst(dst(x, type=t), type=t) == x for every norm."""
    return _dst_impl(_prep_real(x), _check_type(type), axis,
                     check_norm(norm), True)


# ------------------------------------------------------------- N-D forms
# Separable 1-D passes per axis.  A DCT-II/III pass along axis -2 of an
# even number of float32 images takes the column kernel K9 in the
# natural layout (``_run``); every other pass moves its axis last
# (``config._apply_axis``).

def _norm_axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        return (axes,)
    return tuple(int(a) for a in axes)


def _nd(impl, x, type, axes, norm, inverse: bool):
    x = _prep_real(x)
    t = _check_type(type)
    norm = check_norm(norm)
    for ax in _norm_axes(x, axes):
        x = impl(x, t, ax, norm, inverse)
    return x


def dctn(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    """N-D DCT: separable 1-D passes per axis.  ``dctn(x, 3, axes=(-2,
    -1))`` is the reference's ``dct_2d_forward``; ``idctn`` its
    inverse."""
    return _nd(_dct_impl, x, type, axes, norm, False)


def idctn(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    return _nd(_dct_impl, x, type, axes, norm, True)


def dstn(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    return _nd(_dst_impl, x, type, axes, norm, False)


def idstn(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    return _nd(_dst_impl, x, type, axes, norm, True)
