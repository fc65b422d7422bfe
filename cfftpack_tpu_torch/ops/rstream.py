"""K7: the real-stream transforms (r2c, c2r, DCT-II, DCT-III) for
n = 128*m, and the launch of K8 (the DCT-IV stream tail).

Counterpart of ``cfftpack_tpu/ops/pallas_rstream.py``.  Two adjacent
real rows of a (B, n) batch, B even, run as one complex row
z = x[2p] + i*x[2p+1] through the stream passes (K2's, natural ->
permuted, X[k2 + m*k1] at [k2, k1]); the conjugate-mirror merge
U = (Z + conj(Zm))/2, V = -i(Z - conj(Zm))/2 separates the two real
rows' spectra.  DCT-II rides the same pair through the Makhoul
permutation v = [x_even, reversed x_odd] and the phase Re(ph*U);
DCT-III runs the mirror image of it through the inverse.

The CUDA kernel (``csrc/rstream_fft.cu``) fuses the merge, the
gathers and scatters and the phase into the passes' loads and stores.
At m = 128 .. 1024 (``stream_fft._CLUSTER_M``) K7's four modes and K8
(at n = 2*128*m) run in one pass on a thread-block cluster
(``csrc/cluster_pass.cuh``), with the norm's scale (and the ortho weight
of bin 0 of DCT-II's output and DCT-III's input, and K8's DST-IV flip
and sign) in the kernel; at other m the two stage-loop passes run and
the wrapper applies them.  Launch plans are cached per (mode, n,
device), K8's pre-rotation and post-phase tables with them.  The plain
versions below keep the reference's separate passes, built on
``stream_fft.stream_plain``.  On a CPU tensor each wrapper runs its
plain version; on a CUDA tensor it launches the kernel or raises, each
launch counted in ``utils.profiling.launches`` (K8 is launched from
``dct.py`` through :func:`launch`).  The four wrappers are differentiable
(``_adjoint``), each backward one call of another mode: rfft's is the
irfft of the cotangent with bins 1 .. n/2-1 halved, irfft's the rfft of
the cotangent with those bins doubled, DCT-II's the DCT-III and back.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import plan
from ..utils import profiling
from . import _adjoint, _build, stream_fft

__all__ = ["rstream_eligible", "srfft_stream", "sirfft_stream",
           "sdct2_stream", "sdct3_stream"]

_N1 = stream_fft._N1
_H = _N1 // 2            # lanes below 64 hold every bin below Nyquist

_MODES = ("rfft", "irfft", "dct2", "dct3", "dct4")
_KERNEL = {"rfft": "K7", "irfft": "K7", "dct2": "K7", "dct3": "K7",
           "dct4": "K8"}


def rstream_eligible(n: int, dtype, flat_batch: int) -> bool:
    """A pairable batch and a stream length: float32, an even flat batch
    of at least 2, n = 128*m with m a 5-smooth multiple of 16 up to the
    cap."""
    if flat_batch % 2 or flat_batch < 2:
        return False
    return stream_fft.stream_eligible(n, dtype)


# ------------------------------------------------------ plain versions

def _mirror_perm(t):
    """Conjugate-mirror index map on a permuted (P, m, 128) plane:
    out[k2, k1] = t[(m - k2) % m, lane], lane = (128 - k1) % 128 on row
    0 and 127 - k1 elsewhere."""
    R = t.flip((1, 2))                          # rows m-1..0, lanes flipped
    r0 = torch.roll(R[:, -1:], 1, dims=2)       # row 0: lane (128-k1)%128
    return torch.cat([r0, R[:, :-1]], dim=1)


def _merge_uv(Zr, Zi):
    """Permuted pair spectrum -> (U, V), the full permuted spectra of the
    two real rows."""
    Zmr = _mirror_perm(Zr)
    Zmi = _mirror_perm(Zi)
    return (0.5 * (Zr + Zmr), 0.5 * (Zi - Zmi),
            0.5 * (Zi + Zmi), 0.5 * (Zmr - Zr))


def _nat_low(t, m: int):
    """Permuted plane -> natural bins 0..n/2-1 (lanes < 64)."""
    return t[:, :, :_H].transpose(1, 2).reshape(t.shape[0], _H * m)


def _rfft_plain(x, n: int, scale: float = 1.0):
    """(B, n) real, B even -> natural packed (B, n/2 + 1) pair, times
    ``scale``."""
    m = n // _N1
    x3 = x.reshape(-1, 2, m, _N1)
    Zr, Zi = stream_fft.stream_plain(x3[:, 0], x3[:, 1], n, "fwd")
    Ur, Ui, Vr, Vi = _merge_uv(Zr, Zi)
    nyq_r = torch.stack([Ur[:, 0, _H], Vr[:, 0, _H]], dim=1)[..., None]
    lows = [_nat_low(t, m) for t in (Ur, Vr, Ui, Vi)]
    yr = torch.cat([torch.stack(lows[:2], dim=1), nyq_r], dim=-1)
    yi = torch.cat([torch.stack(lows[2:], dim=1), torch.zeros_like(nyq_r)],
                   dim=-1)
    # imag(DC) is (Zi - Zmi)/2 at the self-mirror bin 0, an exact zero
    B = x.shape[0]
    yr, yi = yr.reshape(B, -1), yi.reshape(B, -1)
    if scale != 1.0:
        yr, yi = yr * scale, yi * scale
    return yr, yi


def _irfft_plain(yr, yi, n: int, scale: float = 1.0):
    """Natural packed (B, n/2 + 1) pair -> (B, n) real times n*scale."""
    m = n // _N1
    h = n // 2
    ar = yr.reshape(-1, 2, h + 1)
    ai = yi.reshape(-1, 2, h + 1)
    Ur, Vr = ar[:, 0], ar[:, 1]
    Ui, Vi = ai[:, 0], ai[:, 1]
    # natural Z: bins 0..h, then the conjugate tail from bin n - k
    Zr = torch.cat([Ur - Vi, (Ur[:, 1:h] + Vi[:, 1:h]).flip(-1)], dim=-1)
    Zi = torch.cat([Ui + Vr, (Vr[:, 1:h] - Ui[:, 1:h]).flip(-1)], dim=-1)
    # natural -> permuted: flat k = k2 + m*k1 is the (128, m) view
    # transposed
    Zr = Zr.reshape(-1, _N1, m).transpose(1, 2)
    Zi = Zi.reshape(-1, _N1, m).transpose(1, 2)
    zr, zi = stream_fft.stream_plain(Zr, Zi, n, "inv")
    out = torch.stack([zr, zi], dim=1).reshape(-1, n)
    return out * scale if scale != 1.0 else out


@functools.lru_cache(maxsize=32)
def _dct_phase_perm(n: int):
    """ph_k = exp(-i pi k / (2n)) laid out in the permuted (k2, k1) tile,
    built in float64, as float32 planes."""
    m = n // _N1
    k2 = np.arange(m)[:, None]
    k1 = np.arange(_N1)[None, :]
    ph = np.exp(-1j * np.pi * (k2 + m * k1) / (2 * n))
    return ph.real.astype(np.float32), ph.imag.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_phase(n: int, device):
    return tuple(torch.from_numpy(t).to(device) for t in _dct_phase_perm(n))


@functools.lru_cache(maxsize=32)
def _dct_phase_nat(n: int):
    """ph_k = exp(-i pi k / (2n)) in natural order (the cluster route's
    loads and stores run on the natural index), float32 planes."""
    ph = np.exp(-1j * np.pi * np.arange(n) / (2 * n))
    return ph.real.astype(np.float32), ph.imag.astype(np.float32)


def _dct4_phases(n: int):
    """Even n: K8's pre-rotation e^{-i pi p/n} and post-phase
    e^{-i pi (2p + 1/2)/(2n)}, p < n/2, as complex f64."""
    p = np.arange(n // 2)
    return (np.exp(-1j * np.pi * p / n),
            np.exp(-1j * np.pi * (2 * p + 0.5) / (2 * n)))


def _dct4_post_perm(n: int):
    """K8's post-phase in the permuted (m, 128) layout of the stage-loop
    route (post[k2 + m*k1] at [k2, k1]) as (re, im) f64."""
    _, post = _dct4_phases(n)
    m = n // 2 // _N1
    k2 = np.arange(m)[:, None]
    k1 = np.arange(_N1)[None, :]
    pp = post[(k2 + m * k1).reshape(-1)].reshape(m, _N1)
    return pp.real, pp.imag


def _scaled(y, scale: float, w0: float):
    """y times ``scale``, its first entry on the last axis times ``w0``
    as well (the DCT-II output and DCT-III input weights of ortho)."""
    if w0 != 1.0:
        y = y.clone()
        y[..., 0] *= w0
    return y * scale if scale != 1.0 else y


def _dct2_plain(x, n: int, scale: float = 1.0, w0: float = 1.0):
    """(B, n) real, B even -> DCT-II in natural order, times ``scale``,
    bin 0 times ``w0`` as well."""
    m = n // _N1
    B = x.shape[0]
    v = torch.cat([x[:, 0::2], x[:, 1::2].flip(-1)], dim=-1)
    v3 = v.reshape(-1, 2, m, _N1)
    Zr, Zi = stream_fft.stream_plain(v3[:, 0], v3[:, 1], n, "fwd")
    Ur, Ui, Vr, Vi = _merge_uv(Zr, Zi)
    phr, phi = _device_phase(n, x.device)
    yU = Ur * phr - Ui * phi                 # Re(ph * U), all n bins
    yV = Vr * phr - Vi * phi
    out = torch.stack([yU.transpose(1, 2), yV.transpose(1, 2)], dim=1)
    return _scaled(out.reshape(B, n), scale, w0)


def _dct3_plain(y, n: int, scale: float = 1.0, w0: float = 1.0):
    """(B, n), B even -> DCT-III (``dct._dct3_core``) of y with y_0 times
    ``w0``, in natural order, times ``scale``."""
    y = _scaled(y, 1.0, w0)
    m = n // _N1
    B = y.shape[0]
    y3 = y.reshape(-1, 2, _N1, m)
    phr, phi = _device_phase(n, y.device)
    k2 = torch.arange(m, device=y.device)[:, None]
    k1 = torch.arange(_N1, device=y.device)[None, :]
    dc = (k2 == 0) & (k1 == 0)
    ny = (k2 == 0) & (k1 == _H)

    def spectrum(t):
        # w_k = ph_k U_k has y_k = Re(w_k), y_{n-k} = -Im(w_k), so
        # U_k = conj(ph_k)(y_k - i y_{(n-k)%n}); self-mirror fix-ups
        # U_0 = y_0, U_{n/2} = sqrt(2) y_{n/2}
        tm = _mirror_perm(t)
        Ur = t * phr - tm * phi
        Ui = -(t * phi + tm * phr)
        Ur = torch.where(dc, t, torch.where(ny, float(np.sqrt(2.0)) * t, Ur))
        Ui = torch.where(dc | ny, torch.zeros_like(Ui), Ui)
        return Ur, Ui

    Ur, Ui = spectrum(y3[:, 0].transpose(1, 2))
    Vr, Vi = spectrum(y3[:, 1].transpose(1, 2))
    zr, zi = stream_fft.stream_plain(Ur - Vi, Ui + Vr, n, "inv")
    # the inverse returns n*v; dct3(dct2(x)) = (n/2) x, so halve, then
    # undo the Makhoul permutation
    v = torch.stack([zr, zi], dim=1).reshape(B, n) * 0.5
    h = n // 2
    out = torch.empty_like(v)
    out[:, 0::2] = v[:, :h]
    out[:, 1::2] = v[:, h:].flip(-1)
    return out * scale if scale != 1.0 else out


# ------------------------------------------------------------ launch

def _rows(x, width: int):
    """x as (rows, width) with unit lane stride and rows at least
    `width` apart (a view where the layout allows; else one copy)."""
    x2 = x.reshape(-1, width)
    if x2.stride(-1) != 1 or (x2.shape[0] > 1 and x2.stride(0) < width):
        with profiling.span("cfftpack.pack"):
            x2 = x2.contiguous()
    return x2


@dataclass(frozen=True)
class _LaunchPlan:
    """What a launch of one (mode, n, device) passes to
    ``rstream_fft_f32`` besides the data: the outer twiddle, the stage
    plans' tables and C arrays, the mode's phase tables (``pa``: DCT-II
    and III's phase or K8's pre-rotation; ``pb``: K8's post-phase), the
    register pass twiddles, the route (cluster blocks or stage-loop
    lanes), and the tensors behind the pointers."""
    tables: tuple
    pa: tuple
    pb: tuple
    reg: tuple
    cluster: int
    lshift: int
    keep: tuple
    version: int


def _launch_plan(mode: str, n: int, device) -> _LaunchPlan:
    """The cached plan of (mode, n, device), rebuilt when ``plan.VERSION``
    moves (a device table replaced or cleared)."""
    return plan.launch_plan((_build_plan, mode, n, device), mode, n, device)


def _build_plan(mode: str, n: int, device) -> _LaunchPlan:
    f32 = torch.float32
    N = n // 2 if mode == "dct4" else n
    m = N // _N1
    cluster = (stream_fft._cluster_size(m)
               if m in stream_fft._CLUSTER_M else 0)
    # the cluster route runs the inverse as the conjugated forward
    t1r, t1i = stream_fft._device_outer(
        N, not cluster and mode in ("irfft", "dct3"), device)
    ct = plan.device_tables(m, f32, device)
    rt = plan.device_tables(_N1, f32, device)
    keep = (t1r, t1i, ct, rt)
    tables = (t1r.data_ptr(), t1i.data_ptr(), ct.twr.data_ptr(),
              ct.twi.data_ptr(), len(ct.factors), _build.ints(ct.factors),
              _build.ints(ct.offs[:-1]), rt.twr.data_ptr(),
              rt.twi.data_ptr(), len(rt.factors), _build.ints(rt.factors),
              _build.ints(rt.offs[:-1]))
    pa = pb = (None, None)
    if mode in ("dct2", "dct3"):
        ph = (tuple(torch.from_numpy(t).to(device) for t in _dct_phase_nat(n))
              if cluster else _device_phase(n, device))
        pa = tuple(t.data_ptr() for t in ph)
        keep += ph
    if mode == "dct4":
        # the cluster route's store runs on the natural index, the stage
        # loop's on the permuted one
        pre, post = _dct4_phases(n)
        post = (post.real, post.imag) if cluster else _dct4_post_perm(n)
        ph = tuple(plan.to_device(t, f32, device)
                   for t in (pre.real, pre.imag) + post)
        pa = tuple(t.data_ptr() for t in ph[:2])
        pb = tuple(t.data_ptr() for t in ph[2:])
        keep += ph
    reg = (None, None)
    if cluster:
        cptw = plan.to_device(plan.reg_twiddles(m), f32, device)
        rptw = plan.to_device(plan.reg_twiddles(_N1), f32, device)
        reg = (cptw.data_ptr(), rptw.data_ptr())
        keep += (cptw, rptw)
    return _LaunchPlan(tables, pa, pb, reg, cluster,
                       stream_fft._col_lanes(m).bit_length() - 1, keep,
                       plan.VERSION)


def launch(mode: str, n: int, x, xi=None, *, scale: float = 1.0,
           w0: float = 1.0, dst: bool = False):
    """One mode of K7 (rfft, irfft, dct2, dct3) or K8 (dct4) through the
    CUDA kernel: one kernel on the cluster route, both passes on the
    stage loop.

    ``x`` is (..., n) real rows; for irfft ``(x, xi)`` is the packed
    (..., n/2 + 1) pair.  Rows are read in place through their stride.
    K7's modes take an even row count; K8 takes n = 2*128*m.  The result
    is times ``scale``; dct2's bin 0 and dct3's input y_0 are times
    ``w0`` as well (K7 only); ``dst`` makes K8 the DST-IV,
    (-1)^k dct4(flip(x))[k].  Returns the (re, im) packed pair for rfft,
    else the (rows, n) output.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if (xi is not None) != (mode == "irfft"):
        raise ValueError("mode irfft, and only it, takes an im plane xi")
    if mode == "dct4" and w0 != 1.0:
        raise ValueError("mode dct4 takes no w0")
    if dst and mode != "dct4":
        raise ValueError("only mode dct4 takes dst")
    ins = [x] if xi is None else [x, xi]
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"the real-stream kernel takes float32 rows, got "
                        f"{[t.dtype for t in ins]}")
    if not all(t.is_cuda and t.device == x.device for t in ins):
        raise ValueError(f"the real-stream kernel needs its input on one "
                         f"CUDA device, got {[t.device for t in ins]}")
    N = n // 2 if mode == "dct4" else n
    if n % 2 or not stream_fft.stream_eligible(N, torch.float32):
        raise ValueError(f"the real-stream kernel does not take n={n} in "
                         f"mode {mode}")
    width = n // 2 + 1 if mode == "irfft" else n
    if x.shape[-1] != width or (xi is not None and xi.shape != x.shape):
        raise ValueError(f"mode {mode} takes rows of {width}, got "
                         f"{tuple(x.shape)}")
    x2 = _rows(x, width)
    rows = x2.shape[0]
    if mode == "irfft":
        xi2 = _rows(xi, width)
        if xi2.stride(0) != x2.stride(0):
            with profiling.span("cfftpack.pack"):
                x2, xi2 = x2.contiguous(), xi2.contiguous()
    if mode != "dct4" and rows % 2:
        raise ValueError(f"mode {mode} pairs rows: the row count must be "
                         f"even, got {rows}")
    dev = x.device
    f32 = torch.float32
    if mode == "rfft":
        yr = torch.empty((rows, n // 2 + 1), dtype=f32, device=dev)
        yi = torch.empty_like(yr)
    else:
        yr = torch.empty((rows, n), dtype=f32, device=dev)
        yi = None
    if rows == 0:
        return (yr, yi) if mode == "rfft" else yr
    m = N // _N1
    b = rows if mode == "dct4" else rows // 2
    lp = _launch_plan(mode, n, dev)
    if lp.cluster:
        scratch = (None, None)
    else:
        sr = torch.empty((b, m, _N1), dtype=f32, device=dev)
        si = torch.empty_like(sr)
        scratch = (sr.data_ptr(), si.data_ptr())
        if mode == "dct3" and w0 != 1.0:
            x2 = _scaled(x2, 1.0, w0)
        if dst:
            x2 = x2.flip(-1)
    err = _build.call(
        _KERNEL[mode], _build.load().rstream_fft_f32, dev, x2.data_ptr(),
        None if xi is None else xi2.data_ptr(),
        x2.stride(0) if rows > 1 else width, yr.data_ptr(),
        None if yi is None else yi.data_ptr(), *scratch, *lp.tables, *lp.pa,
        *lp.pb, *lp.reg, b, m, _MODES.index(mode), lp.cluster, lp.lshift,
        scale if lp.cluster else 1.0, w0 if lp.cluster else 1.0,
        int(dst) if lp.cluster else 0)
    if err != 0:
        raise RuntimeError(f"real-stream kernel launch failed at n={n}, "
                           f"rows={rows}, mode={mode}: CUDA error {err}")
    if not lp.cluster and dst:
        yr[:, 1::2].neg_()
    if not lp.cluster and (scale != 1.0 or w0 != 1.0):
        with profiling.span("cfftpack.scale"):
            if mode == "rfft":
                yr.mul_(scale)
                yi.mul_(scale)
            else:
                if mode == "dct2" and w0 != 1.0:
                    yr[:, 0] *= w0
                yr.mul_(scale)
    return (yr, yi) if mode == "rfft" else yr


# ---------------------------------------------------------- adjoints

@functools.lru_cache(maxsize=32)
def _bin_weights(n: int, device):
    """Float32 weights of the n/2 + 1 packed bins: (1, 2, ..., 2, 1), each
    interior bin of a real row's spectrum standing for itself and its
    mirror; its inverse; and the inverse with bins 0 and n/2 zero."""
    w = torch.full((n // 2 + 1,), 2.0, dtype=torch.float32, device=device)
    w[0] = w[-1] = 1.0
    half = 1.0 / w
    half_im = half.clone()
    half_im[0] = half_im[-1] = 0.0
    return w, half, half_im


def _rfft_adjoint(gr, gi, n: int, scale: float):
    """The adjoint of ``srfft_stream(., n, scale)``: y_k = scale * sum_t
    x_t e^{-2i pi kt/n}, k = 0 .. n/2, so x_t = scale * sum_k (gr_k cos -
    gi_k sin), which is the c2r of g with bins 1 .. n/2-1 halved (the c2r
    counts each twice) and the imaginary parts of bins 0 and n/2 dropped
    (the forward's are exact zeros that depend on no input)."""
    _, half, half_im = _bin_weights(n, gr.device)
    return sirfft_stream(gr * half, gi * half_im, n, scale)


def _irfft_adjoint(g, n: int, scale: float):
    """The adjoint of ``sirfft_stream(., ., n, scale)``: x_t = scale *
    (Y_0 + (-1)^t Y_{n/2} + 2 sum_{0<k<n/2} Re(Y_k e^{2i pi kt/n})), so the
    real planes' gradient is scale * (1, 2, ..., 2, 1) * rfft(g).  The
    forward decodes rows 2p and 2p+1 from one complex row, Z = U + iV, so
    the imaginary parts of bins 0 and n/2 (which a real row's spectrum
    does not have) cross the pair: row 2p takes -Im V there, row 2p+1
    Im U, and their gradients are scale * rfft(g[2p+1]) and
    -scale * rfft(g[2p]) at those bins."""
    h = n // 2
    w = _bin_weights(n, g.device)[0]
    Gr, Gi = srfft_stream(g, n, scale)
    ends = Gr[..., ::h].reshape(-1, 2, 2)      # (pairs, rows, bins 0 and h)
    cross = torch.stack([ends[:, 1], -ends[:, 0]], dim=1).reshape(
        Gr.shape[:-1] + (2,))
    gi = torch.cat([cross[..., :1], Gi[..., 1:h] * 2.0, cross[..., 1:]],
                   dim=-1)
    return Gr * w, gi


# ---------------------------------------------------------- wrappers

def srfft_stream(x, n: int, scale: float = 1.0):
    """``core.srfft`` contract (r2c, natural packed n/2 + 1 bins) through
    K7, times ``scale``.  Needs ``rstream_eligible``."""
    if _adjoint.needs_grad(x):
        return _adjoint.linear(
            lambda v: srfft_stream(v, n, scale),
            lambda gr, gi: _rfft_adjoint(gr, gi, n, scale), x)
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        yr, yi = _rfft_plain(x.reshape(-1, n), n, scale)
    else:
        yr, yi = launch("rfft", n, x, scale=scale)
    h1 = n // 2 + 1
    return yr.reshape(lead + (h1,)), yi.reshape(lead + (h1,))


def sirfft_stream(yr, yi, n: int, scale: float = 1.0):
    """``core.sirfft`` contract (c2r: returns n*scale*x) through K7."""
    if _adjoint.needs_grad(yr, yi):
        return _adjoint.linear(
            lambda a, b: sirfft_stream(a, b, n, scale),
            lambda g: _irfft_adjoint(g, n, scale), yr, yi)
    lead = yr.shape[:-1]
    if yr.device.type == "cpu":
        h1 = n // 2 + 1
        out = _irfft_plain(yr.reshape(-1, h1), yi.reshape(-1, h1), n, scale)
    else:
        out = launch("irfft", n, yr, yi, scale=scale)
    return out.reshape(lead + (n,))


def sdct2_stream(x, n: int, scale: float = 1.0, w0: float = 1.0):
    """``dct._dct2_core`` contract (DCT-II, natural order) through K7,
    times ``scale``, bin 0 times ``w0`` as well.  With C2[k, j] =
    cos(pi k (2j+1)/(2n)) and the DCT-III core C3 = C2^T diag(1/2, 1, ...,
    1), the adjoint of scale * diag(w0, 1, ...) C2 is the DCT-III with
    y_0 times 2*w0."""
    if _adjoint.needs_grad(x):
        return _adjoint.linear(
            lambda v: sdct2_stream(v, n, scale, w0),
            lambda g: sdct3_stream(g, n, scale, 2.0 * w0), x)
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        out = _dct2_plain(x.reshape(-1, n), n, scale, w0)
    else:
        out = launch("dct2", n, x, scale=scale, w0=w0)
    return out.reshape(lead + (n,))


def sdct3_stream(y, n: int, scale: float = 1.0, w0: float = 1.0):
    """``dct._dct3_core`` contract (DCT-III, natural order) through K7 of
    y with y_0 times ``w0``, times ``scale``.  The adjoint is the DCT-II
    with bin 0 times w0/2 (see :func:`sdct2_stream`)."""
    if _adjoint.needs_grad(y):
        return _adjoint.linear(
            lambda v: sdct3_stream(v, n, scale, w0),
            lambda g: sdct2_stream(g, n, scale, 0.5 * w0), y)
    lead = y.shape[:-1]
    if y.device.type == "cpu":
        out = _dct3_plain(y.reshape(-1, n), n, scale, w0)
    else:
        out = launch("dct3", n, y, scale=scale, w0=w0)
    return out.reshape(lead + (n,))
