"""K6 and K9: transforms over axis -2 in the natural layout.

Counterpart of ``cfftpack_tpu/ops/pallas_colfft.py`` (K6, the column
FFT) and of the column DCT cores ``_coldct2_core``/``_coldct3_core`` of
``cfftpack_tpu/ops/dct.py`` (K9).  Planes are (..., n0, n1); the
transform runs down the columns (axis -2) with no transposing copy
around it.

K6 (:func:`scolfft`) is the length-n0 DFT with the norm scale fused
into its store.  K9 (:func:`scoldct`) is the unscaled DCT-II or DCT-III
of an even number of images: two images pair into (re, im), the Makhoul
permutation runs down the column, one column FFT, and the conjugate
mirror merges with the half phase.  The CUDA kernel
(``csrc/col_fft.cu``) does the gathers, the merge, the phase, the scale
and the row weights in its loads and stores; the plain versions below
keep the reference's separate passes over :func:`colfft_plain`.  At
n0 = 512, 1024, 2048 and 4096 the kernel runs register passes
(``csrc/regfft.cuh``) in one shared buffer, lanes fastest; every other
length takes the stage loop (:func:`_route`).  A launch's arguments are
built once per (mode, n0, n1, device) (:func:`_launch_plan`).

The transform length keeps the reference's rule (float32, n0 a 5-smooth
multiple of 16 up to 4096), so both packages take the column route at
the same lengths.  The reference's ``n1 % 128 == 0`` is its lane tile
and does not apply: the kernel masks its last lane group, so any
n1 >= 1 runs.  On a CPU tensor each wrapper runs its plain version; on
a CUDA tensor it launches the kernel or raises, each launch counted in
``utils.profiling.launches``.  Both wrappers are differentiable
(``_adjoint``): K6's backward is the other direction, K9's the other
DCT type with the row weight moved across (:func:`_dct_adjoint_weight`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import plan
from . import _adjoint, _build, fused_fft, stream_fft

__all__ = ["colfft_eligible", "colfft_plain", "scolfft", "coldct2_plain",
           "coldct3_plain", "coldct_plain", "scoldct"]

_MODES = ("fwd", "inv", "dct2", "dct3")
_KERNEL = {"fwd": "K6", "inv": "K6", "dct2": "K9", "dct3": "K9"}


def colfft_eligible(n0: int, n1: int, dtype) -> bool:
    """The column kernel's gate: float32, n0 = 16 * 2^a 3^b 5^c up to
    4096 (the reference's stage-plan rule), any n1 >= 1."""
    if dtype != torch.float32:
        return False
    return (n1 >= 1 and n0 <= stream_fft._MAX_M
            and stream_fft._stage_ok(n0))


def _col_lanes(n0: int, n1: int) -> int:
    """Lanes L of one stage-loop block, a power of two: the stream column
    pass's rule (``stream_fft._col_lanes``: the widest L up to 32 whose
    two buffers fit 64 KB, so three blocks share an SM, and at least 2),
    no wider than n1 needs.  Measured at (64, n0, 1024) on an NVIDIA H100
    80GB HBM3, 700 W, before the register route took these lengths
    (chip_smoke.py phase 19, PERF.md): room for three blocks on an SM
    beat a full 32-byte sector a row (n0 = 1024: L = 4 1.24 ms, L = 8
    1.64 ms)."""
    return _narrow(stream_fft._col_lanes(n0), n1)


# The register route's lengths (col_fft.cu's CfRegCol), lanes a block and
# blocks a thread-block cluster (1: none); see _reg_lanes.
REG_N0 = (512, 1024, 2048, 4096)
_REG_LANES = {512: 16, 1024: 8, 2048: 8, 4096: 4}
_REG_CLUSTER = {512: 1, 1024: 1, 2048: 1, 4096: 4}
_REG_ELEMS = 16


def _reg_lanes(n0: int, n1: int) -> int:
    """Lanes L of one register-route block (n0/16 threads a lane, one
    buffer of 8*(n0 + n0/16)*L bytes), no wider than n1 needs.

    Swept on an NVIDIA H100 80GB HBM3, 700 W (chip_smoke.py phase 25,
    device time; PERF.md): n0 = 512 at (64, 512, 1024), K6: L = 8 / 16 /
    32 243 / 219 / 237 us.  n0 = 1024 at (64, 1024, 1024): K6 L = 4 / 8 /
    16 1492 / 477 / 470 us, K9 dct2 688 / 314 / 369 us and dct3 740 /
    302 / 320 us, so 8.  n0 = 2048 at (64, 2048, 1024), K6: L = 4 / 8
    3263 / 1067 us.  n0 = 4096 at (16, 4096, 1024), K6: L = 2 / 4 2321 /
    1337 us, 4 the most that 1024 threads hold; at 4 with C = 2 / 4 / 8
    blocks a cluster 1048 / 1028 / 1070 us (:func:`_reg_cluster`).
    Clusters of 2 at n0 = 1024 and 2048 moved K6 by 1% or less."""
    return _narrow(_REG_LANES[n0], n1)


def _reg_cluster(n0: int, n1: int) -> int:
    """Blocks a cluster on the register route: neighbouring lane groups
    of one transform launched together, so that the blocks sharing a
    32-byte sector of a row read it at the same time (L2 hits); no more
    than a transform's groups need."""
    groups = -(-n1 // _reg_lanes(n0, n1))
    return _narrow(_REG_CLUSTER[n0], groups)


def _narrow(count: int, need: int) -> int:
    """``count`` (a power of two) halved while its half still covers
    ``need``."""
    while count > 1 and count // 2 >= need:
        count //= 2
    return count


def _route(n0: int, n1: int):
    """("reg", lanes) at the compiled lengths, else ("stage", lanes)."""
    if n0 in REG_N0:
        return "reg", _reg_lanes(n0, n1)
    return "stage", _col_lanes(n0, n1)


@functools.lru_cache(maxsize=64)
def _phase(n0: int, mode: str, device):
    """K9's phase as (n0,) float32 planes, built in float64:
    exp(-i pi k/(2 n0))/2 for dct2 (the merge's halves folded in),
    exp(+i pi k/(2 n0)) for dct3."""
    k = np.arange(n0)
    if mode == "dct2":
        ph = 0.5 * np.exp(-1j * np.pi * k / (2 * n0))
    else:
        ph = np.exp(1j * np.pi * k / (2 * n0))
    return (plan.to_device(ph.real, torch.float32, device),
            plan.to_device(ph.imag, torch.float32, device))


# ------------------------------------------------------ plain versions

def colfft_plain(xr, xi, inverse: bool = False, scale: float = 1.0):
    """K6's plain version on any device: the mixed-radix Stockham of
    ``fused_fft._stockham`` run over axis -2 of (..., n0, n1) planes from
    the same plan tables, times ``scale``."""
    shape = xr.shape
    n0, n1 = shape[-2], shape[-1]
    t = plan.device_tables(n0, xr.dtype, xr.device)
    Sr = xr.reshape(-1, 1, n0 * n1)
    Si = xi.reshape(-1, 1, n0 * n1)
    B = Sr.shape[0]
    L, m = 1, n0
    for s, p in enumerate(t.factors):
        mn = m // p
        Ur, Ui = fused_fft._butterfly(Sr.reshape(B, L, p, mn * n1),
                                      Si.reshape(B, L, p, mn * n1), p,
                                      inverse, t.dense.get(p))
        if mn > 1:
            twr = t.twr[t.offs[s]: t.offs[s + 1]].view(p, mn, 1)
            twi = t.twi[t.offs[s]: t.offs[s + 1]].view(p, mn, 1)
            if inverse:
                twi = -twi
            Ur = Ur.reshape(B, L, p, mn, n1)
            Ui = Ui.reshape(B, L, p, mn, n1)
            Ur, Ui = Ur * twr - Ui * twi, Ur * twi + Ui * twr
        Sr = Ur.reshape(B, L, p, mn * n1).transpose(1, 2).reshape(
            B, L * p, mn * n1)
        Si = Ui.reshape(B, L, p, mn * n1).transpose(1, 2).reshape(
            B, L * p, mn * n1)
        L *= p
        m = mn
    yr, yi = Sr.reshape(shape), Si.reshape(shape)
    if scale != 1.0:
        yr = yr * scale
        yi = yi * scale
    return yr, yi


def coldct2_plain(x, n: int):
    """K9's plain version, DCT-II: ``dct._dct2_core``'s contract
    (unscaled) over axis -2 of (..., n, n1) with an even flat image
    count, the reference's ``_coldct2_core`` pass for pass."""
    n1 = x.shape[-1]
    xp = x.reshape(-1, 2, n, n1)
    # Makhoul permutation down the column: v = [x_even; reversed x_odd]
    v = torch.cat([xp[..., 0::2, :], xp[..., 1::2, :].flip(-2)], dim=-2)
    Zr, Zi = colfft_plain(v[:, 0], v[:, 1])
    # conjugate mirror over the transform axis: Zm[k] = Z[(n-k)%n]
    Zmr = torch.cat([Zr[:, :1], Zr[:, 1:].flip(1)], dim=1)
    Zmi = torch.cat([Zi[:, :1], Zi[:, 1:].flip(1)], dim=1)
    phr, phi = (t[:, None] for t in _phase(n, "dct2", x.device))
    # A = (Z + conj(Zm))/2, B = -i(Z - conj(Zm))/2; y = Re(ph * .)
    # (halves folded into the phase tables)
    ya = (Zr + Zmr) * phr - (Zi - Zmi) * phi
    yb = (Zi + Zmi) * phr + (Zr - Zmr) * phi
    return torch.stack([ya, yb], dim=1).reshape(x.shape)


def coldct3_plain(x, n: int):
    """K9's plain version, DCT-III: ``dct._dct3_core``'s contract
    (unscaled) over axis -2, the reference's ``_coldct3_core`` pass for
    pass."""
    n1 = x.shape[-1]
    xp = x.reshape(-1, 2, n, n1)
    a, b = xp[:, 0], xp[:, 1]
    z0 = torch.zeros_like(a[:, :1])
    # x[(n-k)%n] with x_n := 0
    am = torch.cat([z0, a[:, 1:].flip(1)], dim=1)
    bm = torch.cat([z0, b[:, 1:].flip(1)], dim=1)
    phr, phi = (t[:, None] for t in _phase(n, "dct3", x.device))
    # Va = ph*(a - i am), Vb = ph*(b - i bm); Z = Va + i Vb
    Zr = phr * a + phi * am - (phi * b - phr * bm)
    Zi = phi * a - phr * am + (phr * b + phi * bm)
    zr, zi = colfft_plain(Zr, Zi, inverse=True, scale=0.5)
    # un-permute down the column: y[2j] = v[j], y[2j+1] = v[n-1-j]
    h = n // 2

    def unperm(v):
        return torch.stack([v[:, :h], v[:, h:].flip(1)],
                           dim=2).reshape(-1, n, n1)

    return torch.stack([unperm(zr), unperm(zi)], dim=1).reshape(x.shape)


def coldct_plain(x, t: int, w=None, scale: float = 1.0):
    """:func:`scoldct`'s contract through the plain cores:
    ``scale * w[:, None] * dct2(x)`` or ``scale * dct3(w[:, None] * x)``."""
    n0 = x.shape[-2]
    if t == 2:
        y = coldct2_plain(x, n0)
        if w is not None:
            y = y * w[:, None]
    else:
        y = coldct3_plain(x if w is None else x * w[:, None], n0)
    return y if scale == 1.0 else y * scale


# ------------------------------------------------------------ launch

@dataclass(frozen=True)
class _LaunchPlan:
    """What a launch of one (mode, n0, n1, device) passes to
    ``col_fft_f32`` besides the data: the stage plan's tables and C
    arrays, the register route's pass twiddles and pass lengths (None,
    0 and an empty array on the stage loop), the K9 phase, the lane
    shift and blocks a cluster, and the tensors behind the pointers."""
    tables: tuple
    lshift: int
    csize: int
    keep: tuple
    version: int


def _launch_plan(mode: str, n0: int, n1: int, device) -> _LaunchPlan:
    """The cached plan of (mode, n0, n1, device), rebuilt when
    ``plan.VERSION`` moves (a device table replaced or cleared)."""
    return plan.launch_plan((_build_plan, mode, n0, n1, device), mode, n0,
                            n1, device)


def _build_plan(mode: str, n0: int, n1: int, device) -> _LaunchPlan:
    ct = plan.device_tables(n0, torch.float32, device)
    keep = (ct,)
    route, lanes = _route(n0, n1)
    if route == "reg":
        passes = plan.reg_passes(n0)
        ptw = plan.to_device(plan.reg_twiddles(n0), torch.float32, device)
        keep += (ptw,)
        reg = (ptw.data_ptr(), len(passes),
               _build.ints([len(q) for q in passes]))
    else:
        reg = (None, 0, _build.ints([]))
    ph = (None, None)
    if mode in ("dct2", "dct3"):
        pt = _phase(n0, mode, device)
        keep += pt
        ph = tuple(t.data_ptr() for t in pt)
    tables = (ct.twr.data_ptr(), ct.twi.data_ptr(), len(ct.factors),
              _build.ints(ct.factors), _build.ints(ct.offs[:-1]), *reg, *ph)
    return _LaunchPlan(tables, lanes.bit_length() - 1,
                       _reg_cluster(n0, n1) if route == "reg" else 1, keep,
                       plan.VERSION)


def _launch(mode: str, x, xi=None, w=None, scale: float = 1.0):
    """One mode through the CUDA kernel on contiguous (B, n0, n1)
    float32 planes: ``(x, xi)`` the (re, im) pair for fwd/inv; for
    dct2/dct3 ``x`` holds an even number B of real images, ``w`` the
    (n0,) row weight or None, in :func:`scoldct`'s contract.  Returns
    the output plane(s)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    dct = mode in ("dct2", "dct3")
    if (xi is None) != dct:
        raise ValueError("fwd and inv take an (re, im) pair, dct2 and dct3 "
                         "one real plane")
    ins = [x] if dct else [x, xi]
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"the column kernel takes float32 planes, got "
                        f"{[t.dtype for t in ins]}")
    if not all(t.is_cuda and t.device == x.device for t in ins):
        raise ValueError(f"the column kernel needs its input on one CUDA "
                         f"device, got {[t.device for t in ins]}")
    if x.dim() != 3 or any(t.shape != x.shape or not t.is_contiguous()
                           for t in ins):
        raise ValueError(f"the column kernel takes contiguous (B, n0, n1) "
                         f"planes, got {[tuple(t.shape) for t in ins]}")
    B, n0, n1 = x.shape
    if not colfft_eligible(n0, n1, x.dtype):
        raise ValueError(f"the column kernel does not take n0={n0}, n1={n1}")
    if dct and B % 2:
        raise ValueError(f"mode {mode} pairs images: the image count must "
                         f"be even, got {B}")
    dev = x.device
    if w is not None and (w.dtype != torch.float32 or w.device != dev
                          or tuple(w.shape) != (n0,)
                          or not w.is_contiguous()):
        raise ValueError(f"the row weight must be a contiguous float32 "
                         f"({n0},) tensor on {dev}")
    yr = torch.empty_like(x)
    yi = None if dct else torch.empty_like(x)
    if B == 0:
        return yr if dct else (yr, yi)
    lp = _launch_plan(mode, n0, n1, dev)
    if mode == "dct3":
        scale = 0.5 * scale          # the core's 1/2 rides in the store
    err = _build.call(
        _KERNEL[mode], _build.load().col_fft_f32, dev, x.data_ptr(),
        None if dct else xi.data_ptr(), yr.data_ptr(),
        None if dct else yi.data_ptr(), *lp.tables,
        None if w is None else w.data_ptr(), B // 2 if dct else B, n0, n1,
        _MODES.index(mode), lp.lshift, lp.csize, float(scale))
    if err != 0:
        raise RuntimeError(f"column kernel launch failed at shape "
                           f"{tuple(x.shape)}, mode={mode}: CUDA error {err}")
    return yr if dct else (yr, yi)


# ---------------------------------------------------------- wrappers

def _check(n0: int, n1: int, *planes) -> None:
    if any(t.dtype != torch.float32 for t in planes):
        raise TypeError(f"the column transforms take float32 planes, got "
                        f"{[t.dtype for t in planes]}")
    if not colfft_eligible(n0, n1, torch.float32):
        raise ValueError(f"the column transforms do not take n0={n0}, "
                         f"n1={n1} (n0 must be a 5-smooth multiple of 16 up "
                         f"to {stream_fft._MAX_M})")


def scolfft(xr, xi, inverse: bool = False, scale: float = 1.0):
    """DFT over axis -2 of split (re, im) planes of shape (..., n0, n1)
    through K6: natural order, no transposes, the output multiplied by
    ``scale`` in the kernel's store.  Needs ``colfft_eligible``.  A view
    that is not contiguous is copied first.  The adjoint is the other
    direction times ``scale``."""
    if _adjoint.needs_grad(xr, xi):
        return _adjoint.linear(
            lambda a, b: scolfft(a, b, inverse, scale),
            lambda a, b: scolfft(a, b, not inverse, scale), xr, xi)
    shape = xr.shape
    n0, n1 = shape[-2], shape[-1]
    _check(n0, n1, xr, xi)
    if xr.device.type == "cpu":
        return colfft_plain(xr, xi, inverse, scale)
    yr, yi = _launch("inv" if inverse else "fwd",
                     xr.reshape(-1, n0, n1).contiguous(),
                     xi.reshape(-1, n0, n1).contiguous(), scale=scale)
    return yr.reshape(shape), yi.reshape(shape)


def _dct_adjoint_weight(w, n0: int, t: int, device):
    """The row weight of the adjoint of :func:`scoldct` type ``t`` with
    weight ``w`` (ones when None).  The DCT-III core is C3 = C2^T diag(1/2,
    1, ..., 1), C2 the DCT-II's matrix, so the adjoint of diag(w) C2 (type
    2, w on the output) is C3 diag(2 w_0, w_1, ...) (type 3, w on the
    input) and that of C3 diag(w) is diag(w_0/2, w_1, ...) C2."""
    v = (torch.ones(n0, dtype=torch.float32, device=device) if w is None
         else w.clone())
    v[0] *= 2.0 if t == 2 else 0.5
    return v


def scoldct(x, t: int, w=None, scale: float = 1.0):
    """DCT-II (``t == 2``) or DCT-III (``t == 3``) over axis -2 of real
    (..., n0, n1) images through K9, the flat image count even:
    ``scale * w[:, None] * dct2(x)`` or ``scale * dct3(w[:, None] * x)``
    with the unscaled cores of ``dct._dct2_core``/``_dct3_core`` and
    ``w`` an (n0,) row weight or None."""
    if t not in (2, 3):
        raise ValueError(f"the column DCT is type 2 or 3, got {t}")
    if _adjoint.needs_grad(x):
        return _adjoint.linear(
            lambda v: scoldct(v, t, w, scale),
            lambda g: scoldct(g, 5 - t, _dct_adjoint_weight(
                w, g.shape[-2], t, g.device), scale), x)
    shape = x.shape
    n0, n1 = shape[-2], shape[-1]
    _check(n0, n1, x)
    if shape[:-2].numel() % 2:
        raise ValueError(f"the column DCT pairs images: the flat image "
                         f"count must be even, got {shape[:-2].numel()}")
    if x.device.type == "cpu":
        return coldct_plain(x, t, w, scale)
    y = _launch(f"dct{t}", x.reshape(-1, n0, n1).contiguous(), w=w,
                scale=scale)
    return y.reshape(shape)
