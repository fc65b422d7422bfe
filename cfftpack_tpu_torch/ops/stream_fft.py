"""K2, K3, K4, K5 and K11: the streaming four-step FFT for n = 128*m.

Counterpart of ``cfftpack_tpu/ops/pallas_stream.py`` (the Pallas kernel
``_make_kernel`` in its five modes, and the wrappers around it).  For
n = 128*m with m a 5-smooth multiple of 16 and m <= 4096, the natural
tile x[q, r] (flat j = 128*q + r) transforms as

    X[k2 + m*k1] = sum_r W_128^{r k1} * W_n^{r k2} * sum_q x[q, r] W_m^{q k2}

K2 runs it natural -> permuted (X[k2 + m*k1] at [k2, k1] of an
(m, 128) tile) and back; K3 natural -> natural, with the transpose done
on chip and the norm scale in its store; K4 is the inverse with a
spectral multiply fused into its load.  K3 takes one of three routes by
m alone (:func:`_k3_route`): one pass on a thread-block cluster at
m = 128 .. 1024 (``csrc/cluster_pass.cuh``), K5's two register-pass
kernels at s = 1 at m = 2048 and 4096, and the two stage-loop passes
elsewhere; the first two run the inverse as the conjugated forward.
K4 runs one pass on the same cluster engine at m = 128 .. 1024, in its
rows-first order (the 128-point DFT of each permuted row first), with
the norm's scale in its store and its output written through a row
stride (``sfilter_stream``'s paired rows), and the two stage-loop
passes elsewhere.  K2 (:func:`_k2_route`) runs its forward as K3's
(one cluster pass at m = 128 .. 1024, the two register-pass kernels at
2048 and 4096), storing the permuted rows as they lie and reading its
input through a row stride (``sfilter_stream``'s paired rows, with no
copy), and its inverse as K4's without the filter; other m keep the
two stage-loop passes.
K5 (:func:`sfft_stream_split`, :func:`sfilter_stream`) splits lengths
past m = 4096 s = 2 or 4 ways: mode "split" of the same passes,
with the s-point DFT and the split twiddle in the column pass's load and
the digit riffle (natural order), the norm scale and an optional filter
in the row pass's store; the inverse is the conjugated forward.  The
CUDA kernels live in ``csrc/stream_fft.cu``; each K5 call, and K2 and
K4 off the cluster, is two passes there (an m-point column pass and a
128-point row pass through scratch planes).

K11 (:func:`sfft_mm2`, :func:`sfft_mm2_permuted`; the reference's
``_mm2_2d``) computes the same formula for any integer 2 <= m <= 256
with both DFTs as dense matrix products, ``csrc/mm2_fft.cu``.  No
dispatch picks it: it is reached through its own functions only.

On a CPU tensor every wrapper runs the plain PyTorch version
(:func:`stream_plain`, built from ``fused_fft._stockham`` and a float32
matmul; :func:`sfft_mm2_plain`, two float32 matmuls); on a CUDA tensor
it launches the kernel or raises, each C call counted by K-name in
``utils.profiling.launches``.  Each wrapper is differentiable
(``_adjoint``): its backward is the other direction on the same kernel
(natural <-> permuted for K2 and K11), and K4's is the filter with the
conjugate spectrum, plus, for the filter, one forward transform of the
input's and the cotangent's row pairs (K3, or K5 past the cap).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import plan
from ..utils import profiling
from . import _adjoint, _build, fused_fft

__all__ = ["stream_eligible", "stream_filter_eligible", "stream_plain",
           "sfft_stream", "sfft_stream_permuted", "sfilter_stream",
           "sfft_stream_split", "mm2_eligible", "sfft_mm2",
           "sfft_mm2_permuted", "sfft_mm2_plain"]

_N1 = 128          # lanes: the outer DFT length
_TAIL = 16
_MAX_M = 4096      # the reference's whole-transform cap, kept so the
                   # eligible lengths, split factors and layouts agree

# Shared memory one block may use on sm_90 (227 KB).  A column-pass
# block takes the widest lane group (up to 32 floats, one 128-byte
# segment per row) whose buffers fit 64 KB, so three blocks share an SM
# (measured faster than one wide block at m = 512 and 1024, PERF.md),
# and at least 2 lanes (128 KB at m = 4096, faster there than 1).
_SMEM_BUDGET = 232448
_SMEM_TARGET = 64 * 1024
_MIN_LANES = 2
_MAX_LANES = 32

_MODES = ("fwd", "inv", "fwd_nat", "inv_nat", "filter")
_NAT_MODES = ("fwd_nat", "inv_nat")      # K3
# K5's modes (the C entry stream_split_f32): the forward, the inverse as
# conj(fft(conj(x))) and the conjugated forward conj(fft(x)) of the split
# filter; the value is the entry's conj flags (1 conjugates the load, 2
# the store)
_SPLIT_MODES = {"split": 0, "split_inv": 3, "split_conj": 2}
# K5's column pass at these m runs in register passes (the engine of
# K1, csrc/regfft.cuh, compiled for them alone): lanes a block (1024
# threads, 16 elements each); other m take the stage loop
_REG_LANES = {2048: 8, 4096: 4}
# K3 and K7 run in one pass on a thread-block cluster at these m
# (csrc/cluster_pass.cuh, compiled for them alone)
_CLUSTER_M = (128, 256, 512, 1024)
_CLUSTER_MAX = 16      # past the portable 8: the kernels opt in


def _cluster_size(m: int) -> int:
    """Blocks of K3's and K7's cluster at m: m/16 up to 16, so 128
    threads a block at m = 128 and 256, 256 at 512, 512 at 1024 (17 to
    70 KB of shared memory): the smallest blocks the kernels take from
    m = 256 on, which ran fastest on an H100 (``chip_smoke.py`` phase 25c
    sweeps C at m = 512)."""
    return min(_CLUSTER_MAX, m // 16)


def _filter_cluster_size(m: int) -> int:
    """Blocks of K4's cluster at m, from a sweep of C on an H100
    (``chip_smoke.py`` phase 25c repeats it; PERF.md §6): 2 at m = 128
    and 256 (512 and 1024 threads a block), 16 at 512 and 1024.  Unlike the
    columns-first kernels, the rows-first order ran fastest with the
    largest blocks at small m.  At C = 16 (8 lanes a block) every warp's
    access to the rows-first row layout (``cl_rf_row`` in
    ``csrc/cluster_pass.cuh``) hits 32 banks; at C = 2 a column-phase
    warp reads 32 lanes of one row and puts two threads on 3 banks."""
    return 2 if m <= 256 else _CLUSTER_MAX


def _k3_route(m: int):
    """K3's route at m = n/128, by m alone: ("cluster", C) one kernel on
    clusters of C blocks, ("reg", lanes) K5's two register-pass kernels at
    s = 1, or ("stage", lanes) the two stage-loop passes."""
    if m in _CLUSTER_M:
        return "cluster", _cluster_size(m)
    if m in _REG_LANES:
        return "reg", _REG_LANES[m]
    return "stage", _col_lanes(m)


def _k2_route(m: int, inverse: bool):
    """K2's route at m = n/128, as K3's: ("cluster", C) one kernel on
    clusters of C blocks, the forward columns first at K3's C, the inverse
    rows first at K4's; ("reg", lanes) the forward's two register-pass
    kernels at m = 2048 and 4096; or ("stage", lanes) the two stage-loop
    passes.  A sweep of C on an H100 (``chip_smoke.py`` phase 25c; PERF.md
    §6) found both rules the fastest or within 2% of it for K2 too."""
    if m in _CLUSTER_M:
        return "cluster", (_filter_cluster_size(m) if inverse
                           else _cluster_size(m))
    if m in _REG_LANES and not inverse:
        return "reg", _REG_LANES[m]
    return "stage", _col_lanes(m)


def _stage_ok(m: int) -> bool:
    """m = 16 * 2^a * 3^b * 5^c: the row counts the reference's
    ``_stage_plan`` accepts."""
    return m % _TAIL == 0 and plan.is_smooth(m // _TAIL)


def stream_eligible(n: int, dtype) -> bool:
    if dtype != torch.float32:
        return False
    return _length_ok(n, _MAX_M)


@functools.lru_cache(maxsize=1024)
def _length_ok(n: int, cap: int) -> bool:
    return n % _N1 == 0 and n // _N1 <= cap and _stage_ok(n // _N1)


def _filter_split_factor(n: int):
    """Smallest split s (1, 2, 4) putting the inner transform within the
    kernel's cap, or None."""
    if n % _N1:
        return None
    for s in (1, 2, 4):
        if n % (s * _N1) == 0:
            m = n // (s * _N1)
            if m <= _MAX_M and _stage_ok(m):
                return s
    return None


def stream_filter_eligible(n: int, dtype) -> bool:
    if dtype != torch.float32:
        return False
    return _filter_split_factor(n) is not None


@functools.lru_cache(maxsize=64)
def _tables(n: int, inverse: bool):
    """Outer twiddle W_n^{r k2} (conjugate for the inverse) as (m, 128)
    float32 planes, built in float64."""
    m = n // _N1
    sgn = 2j * np.pi if inverse else -2j * np.pi
    k2 = np.arange(m)[:, None]
    r = np.arange(_N1)[None, :]
    t1 = np.exp(sgn * k2 * r / n)
    return t1.real.astype(np.float32), t1.imag.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _split_twiddle(n: int, s: int):
    """Split twiddle W_n^{k1 j2} as (s, m, 128) float32 planes (j2 natural
    rows: j2 = 128 q + r)."""
    n_in = n // s
    k1 = np.arange(s)[:, None]
    j2 = np.arange(n_in)[None, :]
    t = np.exp(-2j * np.pi * k1 * j2 / n).reshape(s, n_in // _N1, _N1)
    return t.real.astype(np.float32), t.imag.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_outer(n: int, inverse: bool, device):
    with profiling.planning():
        return tuple(torch.from_numpy(t).to(device)
                     for t in _tables(n, inverse))


@functools.lru_cache(maxsize=16)
def _device_split(n: int, s: int, device):
    with profiling.planning():
        return tuple(torch.from_numpy(t).to(device)
                     for t in _split_twiddle(n, s))


def _col_lanes(m: int) -> int:
    """Lanes L of one column-pass block (a power of two): two buffers of
    both planes take 16*m*L bytes."""
    lanes = _MAX_LANES
    while lanes > _MIN_LANES and 16 * m * lanes > _SMEM_TARGET:
        lanes //= 2
    return lanes


# ------------------------------------------------------ plain version

def _dft128(yr, yi, inverse: bool):
    """128-point DFT over the last axis as a float32 matmul (the
    reference's outer DFT; D is symmetric)."""
    Dr, Di = plan._dense_dft(_N1, inverse, yr.dtype, yr.device)
    return (torch.matmul(yr, Dr) - torch.matmul(yi, Di),
            torch.matmul(yr, Di) + torch.matmul(yi, Dr))


def _dft_rows(xr, xi, m: int, inverse: bool):
    """m-point DFT over axis 1 of (b, m, 128) planes."""
    yr, yi = fused_fft._stockham(xr.transpose(1, 2).contiguous(),
                                 xi.transpose(1, 2).contiguous(), m, inverse)
    return yr.transpose(1, 2), yi.transpose(1, 2)


def _split_plain(xr, xi, n: int, mode: str, fr, fi, scale: float, out):
    """K5's plain version: the split twiddle after the s-point DFT, K2's
    plain version at s-fold batch, the riffle, then the filter, the scale
    and the conjugation of the mode."""
    s = _filter_split_factor(n)
    n_in = n // s
    m = n_in // _N1
    b = xr.shape[0]
    if mode == "split_inv":
        xi = -xi
    zr, zi = _split_pre(xr.reshape(b, s, n_in), xi.reshape(b, s, n_in), n, s)
    Cr, Ci = stream_plain(zr.reshape(b * s, m, _N1),
                          zi.reshape(b * s, m, _N1), n_in, "fwd")
    # natural order: X[k1 + s*k2 + s*m*lane] -> (b, lane, k2, k1)
    yr = Cr.reshape(b, s, m, _N1).permute(0, 3, 2, 1).reshape(b, n)
    yi = Ci.reshape(b, s, m, _N1).permute(0, 3, 2, 1).reshape(b, n)
    if fr is not None:
        yr, yi = fused_fft._cmul_tab(yr, yi, fr, fi)
    if scale != 1.0:
        yr, yi = yr * scale, yi * scale
    if mode != "split":
        yi = -yi
    if out is None:
        return yr, yi
    out[0].copy_(yr)
    out[1].copy_(yi)
    return out


def stream_plain(xr, xi, n: int, mode: str, fr=None, fi=None, *,
                 scale: float = 1.0, out=None):
    """The plain PyTorch version of every mode, on any device.

    Planes are (b, m, 128), except the natural spectrum of fwd_nat's
    output and inv_nat's input, (b, 128, m).  ``(fr, fi)`` is the
    (s, m, 128) permuted filter of mode "filter"; batch row i takes
    slice i % s.  ``scale`` multiplies the result (K3's modes fwd_nat
    and inv_nat, K4's and K5's); mode "filter" writes into ``out`` (two
    planes of b rows of n) when given.  K5's modes take (b, n) planes
    of the full length n and give natural-order (b, n) planes (into
    ``out`` when given):
    "split" scale * fft(x) * F, "split_inv" scale * conj(fft(conj(x))),
    "split_conj" conj(scale * fft(x) * F), F the natural n-bin filter
    ``(fr, fi)`` or 1.
    """
    if mode in _SPLIT_MODES:
        return _split_plain(xr, xi, n, mode, fr, fi, scale, out)
    if scale != 1.0 or out is not None:
        yr, yi = stream_plain(xr, xi, n, mode, fr, fi)
        if scale != 1.0:
            yr, yi = yr * scale, yi * scale
        if out is None:
            return yr, yi
        out[0].copy_(yr.reshape(out[0].shape))
        out[1].copy_(yi.reshape(out[1].shape))
        return out
    m = n // _N1
    if mode in ("fwd", "fwd_nat"):
        t1r, t1i = _device_outer(n, False, xr.device)
        sr, si = _dft_rows(xr, xi, m, False)
        zr, zi = _dft128(*fused_fft._cmul_tab(sr, si, t1r, t1i), False)
        if mode == "fwd_nat":
            zr, zi = zr.transpose(1, 2), zi.transpose(1, 2)
        return zr.contiguous(), zi.contiguous()
    if mode == "inv_nat":
        xr, xi = xr.transpose(1, 2), xi.transpose(1, 2)
    elif mode == "filter":
        rows = torch.arange(xr.shape[0], device=xr.device) % fr.shape[0]
        xr, xi = fused_fft._cmul_tab(xr, xi, fr[rows], fi[rows])
    t1r, t1i = _device_outer(n, True, xr.device)
    yr, yi = _dft128(xr, xi, True)
    sr, si = _dft_rows(*fused_fft._cmul_tab(yr, yi, t1r, t1i), m, True)
    return sr.contiguous(), si.contiguous()


# ------------------------------------------------------------ launch

@dataclass(frozen=True)
class _LaunchPlan:
    """What a launch of one (stream length, direction, split, device)
    passes to a C entry besides the data: the column pass's table
    pointers and C arrays, then the row pass's (s = 1) or K5's split
    twiddle and register-pass tables (s > 1); the column pass's lanes;
    at s = 1 K3's route and the tables of ``stream_nat_f32`` (``nat``,
    also those of K2's and K4's cluster and register routes); and the
    tensors behind the pointers."""
    col: tuple
    rest: tuple
    lshift: int
    keep: tuple
    version: int
    route: tuple = ()
    nat: tuple = ()


def _launch_plan(n_in: int, inverse: bool, s: int, device) -> _LaunchPlan:
    return plan.launch_plan((_build_plan, n_in, inverse, s, device), n_in,
                            inverse, s, device)


def _build_plan(n_in: int, inverse: bool, s: int, device) -> _LaunchPlan:
    m = n_in // _N1
    t1r, t1i = _device_outer(n_in, inverse, device)
    ct = plan.device_tables(m, torch.float32, device)
    col = (t1r.data_ptr(), t1i.data_ptr(), ct.twr.data_ptr(),
           ct.twi.data_ptr(), len(ct.factors), _build.ints(ct.factors),
           _build.ints(ct.offs[:-1]))
    keep = (t1r, t1i, ct)
    rptw = plan.to_device(plan.reg_twiddles(_N1), torch.float32, device)
    ptw = (plan.to_device(plan.reg_twiddles(m), torch.float32, device)
           if m in _REG_LANES or m in _CLUSTER_M else None)
    keep += (rptw, ptw)
    route, nat = (), ()
    if s == 1:
        rt = plan.device_tables(_N1, torch.float32, device)
        rest = (rt.twr.data_ptr(), rt.twi.data_ptr(), len(rt.factors),
                _build.ints(rt.factors), _build.ints(rt.offs[:-1]))
        keep += (rt,)
        route = _k3_route(m)
        # the cluster and register routes run the inverse as the
        # conjugated forward: the forward outer twiddle
        f1r, f1i = (_device_outer(n_in, False, device)
                    if route[0] != "stage" else (t1r, t1i))
        keep += (f1r, f1i)
        nat = ((f1r.data_ptr(), f1i.data_ptr()) + col[2:] + rest
               + (None if ptw is None else ptw.data_ptr(),
                  rptw.data_ptr()))
    else:
        spr, spi = _device_split(n_in * s, s, device)
        rest = (spr.data_ptr(), spi.data_ptr(), s,
                None if ptw is None else ptw.data_ptr(), rptw.data_ptr())
        keep += (spr, spi)
    return _LaunchPlan(col, rest, _col_lanes(m).bit_length() - 1, keep,
                       plan.VERSION, route, nat)


def _check_dtype(xr, xi):
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"the stream kernel takes float32 planes, got "
                        f"{xr.dtype} and {xi.dtype}")


def _check_device(xr, xi, what: str):
    if not (xr.is_cuda and xi.is_cuda) or xr.device != xi.device:
        raise ValueError(f"the stream kernel needs both {what} planes on one "
                         f"CUDA device, got {xr.device} and {xi.device}")


def _row_stride(xr, xi, b: int, n: int):
    """The row stride of two planes of b rows of n floats, (b, n) or
    (b, n/128, 128), with unit element stride and one row stride of at
    least n: the layout that K2's forward and K5 read, and K4 and K5
    write, through a row stride.  None for any other layout."""
    if tuple(xr.shape) == (b, n):
        unit = xr.stride(1) == 1
    elif tuple(xr.shape) == (b, n // _N1, _N1):
        unit = xr.stride(2) == 1 and xr.stride(1) == _N1
    else:
        return None
    rs = xr.stride(0) if b > 1 else n
    if (not unit or xi.shape != xr.shape or xi.stride() != xr.stride()
            or rs < n):
        return None
    return rs


def _rows(xr, xi, n: int):
    """Planes in :func:`_row_stride`'s layout and their row stride, copied
    only when they are not in it."""
    rs = _row_stride(xr, xi, xr.shape[0], n)
    if rs is None:
        with profiling.span("cfftpack.pack"):
            xr, xi, rs = xr.contiguous(), xi.contiguous(), n
    return xr, xi, rs


def _split_launch(xr, xi, n: int, mode: str, fr, fi, scale: float, out):
    """K5: both passes of one split mode."""
    s = _filter_split_factor(n)
    _check_dtype(xr, xi)
    if s not in (2, 4):
        raise ValueError(f"K5 does not take n={n}")
    _check_device(xr, xi, "input")
    b = xr.shape[0]
    if xr.dim() != 2 or tuple(xr.shape) != (b, n) or xi.shape != xr.shape:
        raise ValueError(f"mode {mode} takes (b, {n}) planes, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if fr is not None and (
            fi is None or tuple(fr.shape) != (n,) or fi.shape != fr.shape
            or fr.dtype != torch.float32 or fi.dtype != torch.float32
            or fr.device != xr.device or fi.device != xr.device):
        raise ValueError(f"mode {mode} takes a float32 ({n},) filter on "
                         f"{xr.device}")
    if out is None:
        out = (torch.empty((b, n), dtype=xr.dtype, device=xr.device),
               torch.empty((b, n), dtype=xr.dtype, device=xr.device))
    yr, yi = out
    _check_dtype(yr, yi)
    _check_device(yr, yi, "output")
    if tuple(yr.shape) != (b, n) or yi.shape != yr.shape:
        raise ValueError(f"mode {mode} writes (b, {n}) planes, got "
                         f"{tuple(yr.shape)} and {tuple(yi.shape)}")
    ys = _row_stride(yr, yi, b, n)
    if ys is None:
        raise ValueError(f"mode {mode} writes planes with unit element "
                         f"stride and one row stride of at least {n}")
    if b == 0:
        return out
    xr, xi, in_rs = _rows(xr, xi, n)
    fptr = (None, None)
    if fr is not None:
        with profiling.span("cfftpack.pack"):
            fr, fi = fr.contiguous(), fi.contiguous()
        fptr = (fr.data_ptr(), fi.data_ptr())
    n_in = n // s
    m = n_in // _N1
    sr = torch.empty((b * s, m, _N1), dtype=xr.dtype, device=xr.device)
    si = torch.empty_like(sr)
    lp = _launch_plan(n_in, False, s, xr.device)
    err = _build.call(
        "K5", _build.load().stream_split_f32, xr.device, xr.data_ptr(),
        xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), sr.data_ptr(),
        si.data_ptr(), *lp.col, *lp.rest, *fptr, b, m, lp.lshift, in_rs,
        ys, scale, _SPLIT_MODES[mode])
    if err != 0:
        raise RuntimeError(f"K5 launch failed at n={n}, b={b}, mode={mode}: "
                           f"CUDA error {err}")
    return out


def _nat_launch(xr, xi, n: int, inverse: bool, scale: float):
    """K3 (modes fwd_nat, inv_nat) through ``stream_nat_f32``: one
    kernel a call on the cluster route, two on the others; the scale in
    the store, or one multiply after the stage-loop route."""
    b = xr.shape[0]
    m = n // _N1
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    if b == 0:
        return yr, yi
    lp = _launch_plan(n, inverse, 1, xr.device)
    route, arg = lp.route
    if route == "cluster":
        scratch = (None, None)
    else:
        sr = torch.empty((b, n), dtype=xr.dtype, device=xr.device)
        si = torch.empty_like(sr)
        scratch = (sr.data_ptr(), si.data_ptr())
    err = _build.call(
        "K3", _build.load().stream_nat_f32, xr.device, xr.data_ptr(),
        xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), *scratch, *lp.nat, b, m,
        int(inverse), arg if route == "cluster" else 0,
        arg.bit_length() - 1 if route == "stage" else 0,
        1.0 if route == "stage" else scale)
    if err != 0:
        raise RuntimeError(f"K3 launch failed at n={n}, b={b}, "
                           f"inverse={inverse}, route={route}: CUDA error "
                           f"{err}")
    if route == "stage" and scale != 1.0:
        with profiling.span("cfftpack.scale"):
            yr.mul_(scale)
            yi.mul_(scale)
    return yr, yi


def _launch(xr, xi, n: int, mode: str, fr=None, fi=None, *,
            scale: float = 1.0, out=None):
    """One mode through the CUDA kernels, in :func:`stream_plain`'s
    contract."""
    if mode in _SPLIT_MODES:
        return _split_launch(xr, xi, n, mode, fr, fi, scale, out)
    _check_dtype(xr, xi)
    if not stream_eligible(n, xr.dtype):
        raise ValueError(f"the stream kernel does not take n={n}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES + tuple(_SPLIT_MODES)}"
                         f", got {mode!r}")
    if ((out is not None and mode != "filter")
            or (scale != 1.0 and mode not in _NAT_MODES + ("filter",))):
        raise ValueError(f"mode {mode} takes no output planes (only mode "
                         f"filter does), and a scale only in modes "
                         f"{_NAT_MODES + ('filter',)}")
    _check_device(xr, xi, "input")
    m = n // _N1
    b = xr.shape[0]
    shape_in = (b, _N1, m) if mode == "inv_nat" else (b, m, _N1)
    if tuple(xr.shape) != shape_in or tuple(xi.shape) != shape_in:
        raise ValueError(f"mode {mode} takes planes of shape {shape_in}, "
                         f"got {tuple(xr.shape)}")
    nfilt = 1
    fptr = (None, None)
    if mode == "filter":
        if (fr is None or fi is None or fr.dim() != 3
                or tuple(fr.shape[1:]) != (m, _N1) or fi.shape != fr.shape
                or fr.dtype != torch.float32 or fi.dtype != torch.float32
                or fr.device != xr.device or fi.device != xr.device):
            raise ValueError(f"mode filter takes float32 (s, {m}, {_N1}) "
                             f"filter planes on {xr.device}")
        with profiling.span("cfftpack.pack"):
            fr = fr.contiguous()
            fi = fi.contiguous()
        nfilt = fr.shape[0]
        fptr = (fr.data_ptr(), fi.data_ptr())
    if mode in ("fwd", "inv"):
        return _perm_launch(xr, xi, n, mode == "inv")
    with profiling.span("cfftpack.pack"):
        xr = xr.contiguous()
        xi = xi.contiguous()
    if mode in _NAT_MODES:
        yr, yi = _nat_launch(xr.view(b, n), xi.view(b, n), n,
                             mode == "inv_nat", scale)
        shape_out = (b, _N1, m) if mode == "fwd_nat" else (b, m, _N1)
        return yr.view(shape_out), yi.view(shape_out)
    return _filter_launch(xr, xi, n, fptr, nfilt, scale, out)


def _perm_launch(xr, xi, n: int, inverse: bool):
    """K2 (modes fwd, inv) through ``stream_fft_f32`` on
    :func:`_k2_route`: one kernel a call on the cluster route, two on the
    others.  The forward off the stage loop reads its input through its
    row stride, as it is (:func:`_row_stride`'s layout, which the wrappers
    give it), and refuses any other; the stage loop takes contiguous
    planes."""
    b = xr.shape[0]
    m = n // _N1
    dev = xr.device
    route, arg = _k2_route(m, inverse)
    if route == "stage" or inverse:
        with profiling.span("cfftpack.pack"):
            xr, xi, in_rs = xr.contiguous(), xi.contiguous(), n
    else:
        in_rs = _row_stride(xr, xi, b, n)
        if in_rs is None:
            raise ValueError(f"K2's forward reads two planes of {b} rows of "
                             f"{n} floats with unit element stride and one "
                             f"row stride of at least {n}, got "
                             f"{xr.stride()} and {xi.stride()}")
    yr = torch.empty((b, m, _N1), dtype=xr.dtype, device=dev)
    yi = torch.empty_like(yr)
    if b == 0:
        return yr, yi
    lp = _launch_plan(n, inverse, 1, dev)
    if route == "stage":
        tabs = lp.col + lp.rest + (None, None)
    else:
        tabs = lp.nat
    if route == "cluster":
        scratch = (None, None)
    else:
        sr = torch.empty((b, n), dtype=xr.dtype, device=dev)
        si = torch.empty_like(sr)
        scratch = (sr.data_ptr(), si.data_ptr())
    err = _build.call(
        "K2", _build.load().stream_fft_f32, dev, xr.data_ptr(), xi.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), *scratch, *tabs, None, None, 1, b, m,
        _MODES.index("inv" if inverse else "fwd"),
        arg if route == "cluster" else 0, lp.lshift, in_rs, n, 1.0)
    if err != 0:
        raise RuntimeError(f"K2 launch failed at n={n}, b={b}, inverse="
                           f"{inverse}, route={route}: CUDA error {err}")
    return yr, yi


def _out_planes(out, b: int, n: int, device):
    """K4's output planes: two float32 planes on ``device`` of b rows of n
    floats each, (b, n) or (b, n/128, 128), with unit element stride and
    one row stride of at least n; returns that stride."""
    yr, yi = out
    _check_dtype(yr, yi)
    _check_device(yr, yi, "output")
    ys = _row_stride(yr, yi, b, n)
    if ys is None or yr.device != device:
        raise ValueError(f"mode filter writes two planes of {b} rows of {n} "
                         f"floats with unit element stride and one row "
                         f"stride of at least {n}, got {tuple(yr.shape)} "
                         f"{yr.stride()} and {tuple(yi.shape)} "
                         f"{yi.stride()}")
    return ys


def _filter_launch(xr, xi, n: int, fptr, nfilt: int, scale: float, out):
    """K4 through ``stream_fft_f32``: one kernel in the cluster engine's
    rows-first order at m = 128 .. 1024, the scale and the output's row
    stride in its store, no scratch; elsewhere the two stage-loop passes
    into fresh planes, then one copy into ``out`` times ``scale``."""
    b = xr.shape[0]
    m = n // _N1
    dev = xr.device
    if out is None:
        out = (torch.empty((b, m, _N1), dtype=xr.dtype, device=dev),
               torch.empty((b, m, _N1), dtype=xr.dtype, device=dev))
    ys = _out_planes(out, b, n, dev)
    if b == 0:
        return out
    lp = _launch_plan(n, True, 1, dev)
    lib = _build.load()
    if m in _CLUSTER_M:
        err = _build.call(
            "K4", lib.stream_fft_f32, dev, xr.data_ptr(), xi.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), None, None, *lp.nat,
            *fptr, nfilt, b, m, _MODES.index("filter"),
            _filter_cluster_size(m), 0, n, ys, scale)
        yr = yi = None
    else:
        yr = torch.empty((b, m, _N1), dtype=xr.dtype, device=dev)
        yi = torch.empty_like(yr)
        sr = torch.empty_like(yr)
        si = torch.empty_like(yr)
        err = _build.call(
            "K4", lib.stream_fft_f32, dev, xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), sr.data_ptr(), si.data_ptr(),
            *lp.col, *lp.rest, None, None, *fptr, nfilt, b, m,
            _MODES.index("filter"), 0, lp.lshift, n, n, 1.0)
    if err != 0:
        raise RuntimeError(f"K4 launch failed at n={n}, b={b}: CUDA error "
                           f"{err}")
    if yr is not None:
        with profiling.span("cfftpack.unpack"):
            for dst, src in zip(out, (yr, yi)):
                src = src.view(dst.shape)
                if scale != 1.0:
                    torch.mul(src, scale, out=dst)
                else:
                    dst.copy_(src)
    return out


def _run(xr, xi, n: int, mode: str, fr=None, fi=None, **kw):
    if xr.device.type == "cpu":
        return stream_plain(xr, xi, n, mode, fr, fi, **kw)
    return _launch(xr, xi, n, mode, fr, fi, **kw)


# ---------------------------------------------------------- wrappers

def sfft_stream_permuted(xr, xi, n: int, inverse: bool):
    """Permuted-layout FFT over the last axis (K2): forward natural ->
    permuted, X[k2 + m*k1] at flat [k2*128 + k1]; inverse permuted ->
    natural (unscaled).  Rows in any layout: copied only where K2 does
    not read them as they are.  The adjoint of each direction is the
    other."""
    if _adjoint.needs_grad(xr, xi):
        return _adjoint.linear(
            lambda a, b: sfft_stream_permuted(a, b, n, inverse),
            lambda a, b: sfft_stream_permuted(a, b, n, not inverse), xr, xi)
    shape = xr.shape
    m = n // _N1
    xr, xi, _ = _rows(xr.reshape(-1, n), xi.reshape(-1, n), n)
    yr, yi = _run(xr.view(-1, m, _N1), xi.view(-1, m, _N1), n,
                  "inv" if inverse else "fwd")
    return yr.reshape(shape), yi.reshape(shape)


def sfft_stream(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    """Natural-order FFT over the last axis (K3): the ``core.sfft``
    contract times ``scale``, the permuted <-> natural transpose and the
    scale done in the kernel.  The adjoint is the other direction times
    ``scale``."""
    if _adjoint.needs_grad(xr, xi):
        return _adjoint.linear(
            lambda a, b: sfft_stream(a, b, n, inverse, scale),
            lambda a, b: sfft_stream(a, b, n, not inverse, scale), xr, xi)
    shape = xr.shape
    m = n // _N1
    if inverse:
        yr, yi = _run(xr.reshape(-1, _N1, m), xi.reshape(-1, _N1, m), n,
                      "inv_nat", scale=scale)
    else:
        yr, yi = _run(xr.reshape(-1, m, _N1), xi.reshape(-1, m, _N1), n,
                      "fwd_nat", scale=scale)
    return yr.reshape(shape), yi.reshape(shape)


def _stream_filter_inv(xr, xi, fpr, fpi, n: int, scale: float = 1.0,
                       out=None):
    """Inverse with the filter multiply fused (K4): permuted (b, m, 128)
    spectrum and permuted (s, m, 128) filter -> natural (b, m, 128) times
    ``scale`` (into ``out``, two planes of b rows of n, when given); batch
    row i takes filter slice i % s."""
    return _run(xr, xi, n, "filter", fpr, fpi, scale=scale, out=out)


def _split_pre(zr, zi, n: int, s: int):
    """s-point DFT over axis 1 of (b, s, n/s) planes, then the split
    twiddle W_n^{k1 j2}."""
    zr, zi = fused_fft._butterfly(zr, zi, s, inverse=False)
    twr, twi = _device_split(n, s, zr.device)
    return fused_fft._cmul_tab(zr, zi, twr.reshape(s, -1),
                               twi.reshape(s, -1))


def sfilter_stream(x, ffr, ffi, n: int, scale: float = 1.0):
    """``sirfft(srfft(x) * F)`` (n times the filtered x) times ``scale``
    for real x with an even flat batch.

    ``(ffr, ffi)`` is the full n-bin conjugate-symmetric extension of the
    filter.  Adjacent rows pack as z = x[2p] + i*x[2p+1]; since the
    extension is conjugate-symmetric, the filtered pair decodes to the
    filtered rows exactly.  Within the kernel's cap this is K2 forward to
    the permuted spectrum, reading the paired rows through their row
    stride (no copy where K2 runs one pass or its register kernels; rows
    without unit element stride, as of a transposed x, are copied first),
    and K4, whose load multiplies by the permuted filter and whose store
    writes the two filtered planes straight into the paired rows, times
    ``scale``.  Past it (m > 4096, e.g. the 2^20 pricer grid) it is two
    K5 calls: Y = conj(fft(z) * F), the filter in the first call's store,
    then conj(scale * fft(Y)) = scale * ifft(fft(z) * F) written straight
    into the rows; both read and write the pairs through their row
    stride.

    Differentiable in ``x`` and in the filter (:func:`_filter_adjoint`).
    """
    if _adjoint.needs_grad(x, ffr, ffi):
        return _adjoint.bilinear(
            lambda v, fr, fi: sfilter_stream(v, fr, fi, n, scale),
            lambda g, saved, needs: _filter_adjoint(g[0], *saved, needs, n,
                                                    scale), x, ffr, ffi)
    lead = x.shape[:-1]
    B = lead.numel()
    if B % 2:
        raise ValueError("sfilter_stream: flat batch must be even")
    s = _filter_split_factor(n)
    if s is None:
        raise ValueError(f"sfilter_stream: n={n} not eligible")
    P = B // 2
    xp = x.reshape(P, 2, n)
    out = torch.empty((P, 2, n), dtype=x.dtype, device=x.device)
    if s > 1:
        yr, yi = _run(xp[:, 0], xp[:, 1], n, "split_conj", ffr, ffi)
        _run(yr, yi, n, "split_conj", scale=scale, out=(out[:, 0], out[:, 1]))
        return out.reshape(lead + (n,))
    m = n // _N1
    zr, zi, _ = _rows(xp[:, 0], xp[:, 1], n)
    Zr, Zi = _run(zr.view(P, m, _N1), zi.view(P, m, _N1), n, "fwd")
    # the filter in the permuted layout: k = k2 + m*lane -> (1, m, 128)
    fpr = ffr.reshape(1, _N1, m).transpose(1, 2).contiguous()
    fpi = ffi.reshape(1, _N1, m).transpose(1, 2).contiguous()
    _stream_filter_inv(Zr, Zi, fpr, fpi, n, scale, (out[:, 0], out[:, 1]))
    return out.reshape(lead + (n,))


def _filter_adjoint(g, x, ffr, ffi, needs, n: int, scale: float):
    """The gradients of :func:`sfilter_stream` for the cotangent ``g``.

    Per row pair the filter maps z = x[2p] + i*x[2p+1] to
    w = scale * ifft(F * fft(z)) (unnormalized inverse), whose halves are
    the output rows; a complex-linear map, so its adjoint is the same
    filter with conj(F): ``sfilter_stream(g, ffr, -ffi)``.  With
    Z = fft(z) and H = fft(h), h = g[2p] + i*g[2p+1], the loss
    sum_p Re(<h, w>) = scale * sum_p sum_k Re(conj(H_k) F_k Z_k) gives
    d/dFr = scale * sum_p Re(conj(H) Z), d/dFi = -scale * sum_p
    Im(conj(H) Z) at every bin.  For a conjugate-symmetric F the terms
    that mix a pair's two rows cancel between a bin and its mirror once
    the caller folds the mirror bins back; those of the imaginary parts
    of bins 0 and n/2 stay, as the forward mixes the pair there."""
    gx = gfr = gfi = None
    if needs[0]:
        gx = sfilter_stream(g, ffr, -ffi, n, scale)
    if needs[1] or needs[2]:
        P = x.shape[:-1].numel() // 2
        xp = x.reshape(P, 2, n)
        gp = g.reshape(P, 2, n)
        Zr, Zi = sfft_stream_split(xp[:, 0], xp[:, 1], n, False)
        Hr, Hi = sfft_stream_split(gp[:, 0], gp[:, 1], n, False)
        if needs[1]:
            gfr = scale * (Hr * Zr + Hi * Zi).sum(0)
        if needs[2]:
            gfi = scale * (Hi * Zr - Hr * Zi).sum(0)
    return gx, gfr, gfi


def sfft_stream_split(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    """Natural-order FFT for n past the kernel's cap (K5): n = s * n_in
    with s = ``_filter_split_factor(n)``; the s-point DFT and the split
    twiddle in the column pass's load, the riffle and ``scale`` in the
    row pass's store, two kernels a call.  The ``core.sfft`` contract
    times ``scale``; s = 1 is K3, which takes the scale down."""
    s = _filter_split_factor(n)
    if s is None:
        raise ValueError(
            f"sfft_stream_split: n={n} is not stream-split eligible (needs "
            f"n = s*128*m with s in {{1,2,4}}, m <= {_MAX_M} a 5-smooth "
            f"multiple of {_TAIL})")
    if s == 1:
        return sfft_stream(xr, xi, n, inverse, scale)
    if _adjoint.needs_grad(xr, xi):
        return _adjoint.linear(
            lambda a, b: sfft_stream_split(a, b, n, inverse, scale),
            lambda a, b: sfft_stream_split(a, b, n, not inverse, scale),
            xr, xi)
    shape = xr.shape
    yr, yi = _run(xr.reshape(-1, n), xi.reshape(-1, n), n,
                  "split_inv" if inverse else "split", scale=scale)
    return yr.reshape(shape), yi.reshape(shape)


# --------------------------------------------- two-matmul kernel (K11)
#
# The same formula as the stream kernels, n = 128*m with the natural
# tile x[q, r], for any integer m: S = D_m . x over q, Y = S * W_n^{r k2},
# X = Y . D_128 over r, each a dense complex product in four real ones.
# The inverse mirrors it: the conjugate outer product, the conjugate
# twiddle, the conjugate inner product.  The dense form does 20-40 times a
# fast transform's operations, so the tensor cores' rate bounds it: the
# kernel (csrc/mm2_fft.cu) runs both products in the float32-accurate
# 3xTF32 split of csrc/cgemm.cuh, up to m = 64 in one pass with the
# transform held in shared memory (16 bytes an element moved), past that
# in two passes through scratch planes (32 bytes).

_MM2_MAX_M = 256          # the reference's contraction-length cap for D_m
_MM2_ONE_PASS_MAX_M = 64  # a block holds the transform (MM2_ONE_MAX_M)


def mm2_eligible(n: int, dtype) -> bool:
    return (dtype == torch.float32 and n % _N1 == 0
            and 2 <= n // _N1 <= _MM2_MAX_M)


def _mm2_one_pass(m: int) -> bool:
    """Whether K11 runs m in one kernel, with no scratch."""
    return m <= _MM2_ONE_PASS_MAX_M


def _mm2_device_tables(n: int, inverse: bool, device):
    """(D_m re, im, D_128 re, im, t1 re, im) in the transform's sign."""
    return (plan._dense_dft(n // _N1, inverse, torch.float32, device)
            + plan._dense_dft(_N1, inverse, torch.float32, device)
            + _device_outer(n, inverse, device))


def _cmatmul(ar, ai, br, bi):
    return (torch.matmul(ar, br) - torch.matmul(ai, bi),
            torch.matmul(ar, bi) + torch.matmul(ai, br))


def sfft_mm2_plain(xr, xi, n: int, inverse: bool, natural: bool = True):
    """K11's plain PyTorch version on any device: (b, n) float32 planes
    in and out, the same tables as the kernel.  ``natural`` is the
    spectrum's layout (the forward's output, the inverse's input):
    natural order, or permuted [k2, k1]."""
    m = n // _N1
    b = xr.shape[0]
    dmr, dmi, d1r, d1i, t1r, t1i = _mm2_device_tables(n, inverse, xr.device)
    if not inverse:
        sr, si = _cmatmul(dmr, dmi, xr.reshape(b, m, _N1),
                          xi.reshape(b, m, _N1))
        zr, zi = _cmatmul(*fused_fft._cmul_tab(sr, si, t1r, t1i), d1r, d1i)
        if natural:
            zr, zi = zr.transpose(1, 2), zi.transpose(1, 2)
        return zr.reshape(b, n), zi.reshape(b, n)
    if natural:
        xr = xr.reshape(b, _N1, m).transpose(1, 2)
        xi = xi.reshape(b, _N1, m).transpose(1, 2)
    else:
        xr, xi = xr.reshape(b, m, _N1), xi.reshape(b, m, _N1)
    yr, yi = _cmatmul(xr, xi, d1r, d1i)
    zr, zi = _cmatmul(dmr, dmi, *fused_fft._cmul_tab(yr, yi, t1r, t1i))
    return zr.reshape(b, n), zi.reshape(b, n)


def _mm2_launch(xr, xi, n: int, inverse: bool, natural: bool):
    """One direction through the CUDA kernel (both products: one pass,
    or two through scratch past ``_MM2_ONE_PASS_MAX_M``)."""
    if not (xr.is_cuda and xi.is_cuda) or xr.device != xi.device:
        raise ValueError(f"K11 needs both planes on one CUDA device, got "
                         f"{xr.device} and {xi.device}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"K11 takes float32 planes, got {xr.dtype} and "
                        f"{xi.dtype}")
    if not mm2_eligible(n, xr.dtype):
        raise ValueError(f"K11 does not take n={n}")
    if tuple(xr.shape[1:]) != (n,) or xi.shape != xr.shape:
        raise ValueError(f"K11 takes (b, {n}) planes, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    with profiling.span("cfftpack.pack"):
        xr = xr.contiguous()
        xi = xi.contiguous()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    b = xr.shape[0]
    if b == 0:
        return yr, yi
    if _mm2_one_pass(n // _N1):
        scratch = (None, None)
    else:
        sr = torch.empty_like(xr)
        si = torch.empty_like(xi)
        scratch = (sr.data_ptr(), si.data_ptr())
    tabs = _mm2_device_tables(n, inverse, xr.device)
    err = _build.call(
        "K11", _build.load().mm2_fft_f32, xr.device, xr.data_ptr(),
        xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), *scratch,
        *(t.data_ptr() for t in tabs), b, n // _N1, int(inverse),
        int(natural))
    if err != 0:
        raise RuntimeError(f"K11 launch failed at n={n}, b={b}, "
                           f"inverse={inverse}, natural={natural}: CUDA "
                           f"error {err}")
    return yr, yi


def _mm2_run(xr, xi, n: int, inverse: bool, natural: bool):
    """K11 in either direction and layout; the adjoint is the other
    direction in the same layout."""
    if _adjoint.needs_grad(xr, xi):
        return _adjoint.linear(
            lambda a, b: _mm2_run(a, b, n, inverse, natural),
            lambda a, b: _mm2_run(a, b, n, not inverse, natural), xr, xi)
    shape = xr.shape
    xr2 = xr.reshape(-1, n)
    xi2 = xi.reshape(-1, n)
    if xr.device.type == "cpu":
        yr, yi = sfft_mm2_plain(xr2, xi2, n, inverse, natural)
    else:
        yr, yi = _mm2_launch(xr2, xi2, n, inverse, natural)
    return yr.reshape(shape), yi.reshape(shape)


def sfft_mm2(xr, xi, n: int, inverse: bool):
    """Natural-order two-matmul FFT over the last axis (K11): the
    ``core.sfft`` contract, natural in and out; the caller guarantees
    ``mm2_eligible(n, dtype)``."""
    return _mm2_run(xr, xi, n, inverse, True)


def sfft_mm2_permuted(xr, xi, n: int, inverse: bool):
    """Permuted-spectrum two-matmul FFT (K11), the layout of
    :func:`sfft_stream_permuted`: forward natural -> permuted,
    X[k2 + m*k1] at flat [k2*128 + k1]; inverse permuted -> natural
    (unscaled)."""
    return _mm2_run(xr, xi, n, inverse, False)
