"""K1: the whole mixed-radix Stockham DFT of each row in one kernel.

Counterpart of ``cfftpack_tpu/ops/pallas_fft.py`` (the Pallas kernel
``_make_kernel`` behind ``sfft_pallas``).  A block of the CUDA kernel
in ``csrc/stockham_fft.cu`` holds whole rows on chip and runs every
stage there, so the transform reads and writes device memory once, and
applies an optional scale in its store.  Eligible: n > 1 with no prime
factor above 32, float32 or float64, and two ping-pong buffers of both
planes of one row within the shared memory one block may use.

The lengths of ``plan.REG_LENGTHS`` run the register-pass kernel: the
stages of ``plan.factor(n)`` grouped into passes (``plan.reg_passes``)
that a thread runs in registers, one shared-memory exchange a pass.
Every other length runs the stage loop.  The choice is by length alone.

On a CPU tensor :func:`sfft_fused` runs the plain PyTorch version
(:func:`_stockham`, the same stage schedule and tables); on a CUDA
tensor it launches the kernel or raises.  Its gradient is the adjoint
transform, the other direction at the same scale, through the same
wrapper (``_adjoint``).  A launch plan per (n, dtype,
inverse, device), cached by ``plan.launch_plan``, holds what the C
entry takes besides the data, so a launch is the checks, two
``torch.empty`` and one C call, counted in
``utils.profiling.launches["K1"]``.  The other kernels' plain versions
build on :func:`_stockham`, :func:`_butterfly` and :func:`_cmul_tab`.

The real route of ``core.srfft`` and ``core.sirfft`` (even n with n/2 in
``plan.REG_LENGTHS``, :func:`real_eligible`) runs K1's two real modes at
the half length: :func:`srfft_real` (r2c: the pair load, the forward
passes, the packed merge as a table FMA in the store, the scale) and
:func:`sirfft_real` (c2r: the unmerge as it loads, the inverse passes,
the scale and the interleave in the store), one launch each
(``k1_real_f32``/``f64``, counted as K1).  Each reads one table set of
``plan.device_tables(n).real`` (8 coefficients a bin, float64-built),
and the adjoint of either map is the other mode with the transposed set
at the same scale, so each enters ``_adjoint.linear`` as one map.  On a
CPU tensor :func:`real_plain` runs the same glue in PyTorch
(:func:`_real_merge`, :func:`_real_unmerge`, :func:`_interleave`).
``utils.profiling.real_maps`` counts the maps by direction.

The complex API's route (``core.complex_pass``: a complex64 or complex128
tensor, the transform on its last axis, n in ``plan.REG_LENGTHS`` of its
real dtype, :func:`cplx_eligible`) runs K1's interleaved complex mode,
:func:`cfft_interleaved`: one launch of ``k1_cplx_f32``/``f64`` (counted
as K1) reads the rows as the tensor holds them, (re, im) pairs, and
writes the scaled pairs of a new complex tensor, so neither the planes'
copies nor ``torch.complex`` run.  Rows with the conjugate or negative
bit, or not contiguous at stride n on a base aligned for the pair loads,
are copied once under ``cfftpack.pack`` first.  Its adjoint is the same
mode in the other direction at the same scale.  On a CPU tensor the same
route runs K1's plain version on the ``view_as_real`` planes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import plan
from ..utils import profiling
from . import _adjoint, _build

__all__ = ["fused_eligible", "sfft_fused", "sfft_plain", "real_eligible",
           "srfft_real", "sirfft_real", "real_plain", "cplx_eligible",
           "cfft_interleaved"]

# Shared memory one block may use on sm_90 (227 KB).
_SMEM_BUDGET = 232448
# The stage loop: rows per block are sized to this much, so two blocks
# share an SM.
_SMEM_TARGET = 96 * 1024
_THREADS = 512

# The register kernel (at ``plan.REG_LENGTHS``): the elements a thread
# holds in a pass.
_REG_ELEMS = 16
_REG_MAX_THREADS = {torch.float32: 512, torch.float64: 256}


def fused_eligible(n: int, dtype: torch.dtype) -> bool:
    if n <= 1 or plan.needs_bluestein(n):
        return False
    if dtype not in (torch.float32, torch.float64):
        return False
    return 4 * n * dtype.itemsize <= _SMEM_BUDGET


def _tile_rows(n: int, dtype: torch.dtype) -> int:
    """Rows T per block of the stage loop: floor(target / (2 buffers *
    2 planes * n * size))."""
    per_row = 4 * n * dtype.itemsize
    return max(1, min(_SMEM_BUDGET, _SMEM_TARGET) // per_row)


def _reg_threads_per_row(n: int) -> int:
    return -(-n // _REG_ELEMS)


def _reg_tile_rows(n: int, dtype: torch.dtype) -> int:
    """Rows a block of the register kernel: one, or two where a row is one
    warp (n = 512).  Measured on an H100 at 2^22 elements, 1, 2 and 4
    rows a block (``chip_smoke.py`` phase 25c, PERF.md): one was fastest
    or within 2% at every length in both dtypes but 512 float32 (32.5
    against 34.0 us)."""
    return 2 if _reg_threads_per_row(n) == 32 else 1


# Rows a block of the real modes, by half length: measured on an H100 at
# 2^26 (float32) and 2^25 (float64) elements, 1, 2 and 4 rows a block,
# the fastest sum of the two modes (PERF.md).  A block shares its rows'
# reads of the coefficient table.
_REAL_TILE_ROWS = {
    torch.float32: {480: 4, 512: 4, 960: 2, 1024: 4, 2048: 2, 4096: 1,
                    8192: 1},
    torch.float64: {480: 4, 512: 4, 960: 4, 1024: 4, 2048: 2, 4096: 1}}


# ------------------------------------------------------ plain version

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


def sfft_plain(xr, xi, n: int, inverse: bool):
    """K1's plain PyTorch version on any device (rows of the last axis)."""
    return _stockham(xr, xi, n, inverse)


@dataclass(frozen=True)
class LaunchPlan:
    """What a K1 launch of one (n, dtype, inverse, device) passes to the
    C entry besides the data: the C function, the table pointers, the C
    arrays of the stage schedule and of the register passes (``passes``
    empty for the stage loop), rows a block and threads."""
    fn: object
    tables: tuple
    passes: tuple
    tile_rows: int
    threads: int
    keep: tuple
    version: int


def launch_plan(n: int, dtype: torch.dtype, inverse: bool,
                device) -> LaunchPlan:
    """The cached launch plan of (n, dtype, inverse, device)."""
    return plan.launch_plan((_build_plan, n, dtype, inverse, device), n,
                            dtype, device)


def _build_plan(n: int, dtype: torch.dtype, device) -> LaunchPlan:
    t = plan.device_tables(n, dtype, device)
    lib = _build.load()
    fn = lib.cfft_stockham_f32 if dtype == torch.float32 else \
        lib.cfft_stockham_f64
    keep = (t,)
    if n in plan.REG_LENGTHS[dtype]:
        passes = plan.reg_passes(n)
        ptw = plan.to_device(plan.reg_twiddles(n), dtype, device)
        keep += (ptw,)
        tb = _reg_tile_rows(n, dtype)
        threads = tb * _reg_threads_per_row(n)
        reg = (ptw.data_ptr(), passes, len(passes),
               _build.ints([len(q) for q in passes]))
    else:
        tb, threads = _tile_rows(n, dtype), _THREADS
        reg = (None, (), 0, _build.ints([]))
    tables = (t.twr.data_ptr(), t.twi.data_ptr(), t.dr.data_ptr(),
              t.di.data_ptr(), reg[0])
    stages = (len(t.factors), _build.ints(t.factors),
              _build.ints(t.offs[:-1]), _build.ints(t.dense_offs), reg[2],
              reg[3])
    return LaunchPlan(fn, tables + stages, reg[1], tb, threads, keep,
                      plan.VERSION)


def _check(xr, xi, n: int) -> None:
    if not (xr.is_cuda and xi.is_cuda) or xr.device != xi.device:
        raise ValueError(f"K1 needs both planes on one CUDA device, got "
                         f"{xr.device} and {xi.device}")
    if xr.dtype not in (torch.float32, torch.float64) or xi.dtype != xr.dtype:
        raise TypeError(f"K1 takes float32 or float64 planes of one dtype, "
                        f"got {xr.dtype} and {xi.dtype}")
    if not fused_eligible(n, xr.dtype):
        raise ValueError(f"K1 does not take n={n} in {xr.dtype}")
    rows = xr.shape[0]
    if rows >= 2 ** 31:
        raise ValueError(f"K1 takes fewer than 2^31 rows, got {rows}")


def _launch(xr, xi, n: int, inverse: bool, scale: float):
    _check(xr, xi, n)
    rows = xr.shape[0]
    with profiling.span("cfftpack.pack"):
        xr = xr.contiguous()
        xi = xi.contiguous()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if rows == 0:
        return yr, yi
    lp = launch_plan(n, xr.dtype, inverse, xr.device)
    err = _build.call("K1", lp.fn, xr.device, xr.data_ptr(), xi.data_ptr(),
                      yr.data_ptr(), yi.data_ptr(), *lp.tables[:5], rows, n,
                      *lp.tables[5:], int(inverse), lp.tile_rows, lp.threads,
                      scale)
    if err != 0:
        raise RuntimeError(f"K1 launch failed at n={n}, rows={rows}, "
                           f"{xr.dtype}: CUDA error {err}")
    return yr, yi


def sfft_fused(xr, xi, n: int, inverse: bool, scale: float = 1.0):
    """DFT over the last axis through K1, times ``scale`` (applied in the
    kernel's store).

    Same contract as ``core.sfft``; the caller guarantees
    ``fused_eligible(n, dtype)``.  Differentiable: the adjoint of the DFT
    times ``scale`` is the other direction times ``scale``.
    """
    if _adjoint.needs_grad(xr, xi):
        return _adjoint.linear(
            lambda a, b: sfft_fused(a, b, n, inverse, scale),
            lambda a, b: sfft_fused(a, b, n, not inverse, scale), xr, xi)
    shape = xr.shape
    xr2 = xr.reshape(-1, n)
    xi2 = xi.reshape(-1, n)
    if xr.device.type == "cpu":
        yr, yi = sfft_plain(xr2, xi2, n, inverse)
        if scale != 1.0:
            yr, yi = yr * scale, yi * scale
    else:
        yr, yi = _launch(xr2, xi2, n, inverse, scale)
    return yr.reshape(shape), yi.reshape(shape)


# ------------------------------------------------------- the real modes
#
# A table set of ``plan.device_tables(n).real`` names its mode: r2c sets
# have h + 1 rows, c2r sets h; the adjoint of a set's map is the other
# mode with the transposed set.
_REAL_MODE = {"rfft": "r2c", "irfft_adj": "r2c", "irfft": "c2r",
              "rfft_adj": "c2r"}
_REAL_ADJOINT = {"rfft": "rfft_adj", "rfft_adj": "rfft",
                 "irfft": "irfft_adj", "irfft_adj": "irfft"}


def real_eligible(n: int, dtype: torch.dtype) -> bool:
    """Whether the real transforms of length ``n`` take K1's real modes:
    n even with n/2 a register length of ``dtype``."""
    return n % 2 == 0 and n // 2 in plan.REG_LENGTHS.get(dtype, ())


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


def real_plain(a, b, n: int, mode: str, tab, scale: float = 1.0):
    """A real mode's plain PyTorch version on any device: the real
    route's glue around K1's plain version, over the table set ``tab``
    ((h + 1, 8) for r2c of rows ``a``, (h, 8) for c2r of the packed
    planes ``a``, ``b``), times ``scale``."""
    h = n // 2
    if mode == "r2c":
        Zr, Zi = sfft_plain(a[..., 0::2], a[..., 1::2], h, False)
        yr, yi = _real_merge(Zr, Zi, tab)
        return (yr * scale, yi * scale) if scale != 1.0 else (yr, yi)
    Zr, Zi = _real_unmerge(a, b, tab)
    zr, zi = sfft_plain(Zr, Zi, h, True)
    x = _interleave(zr, zi)
    return x * scale if scale != 1.0 else x


def _real_plain_rows(a, b, n: int, tables: str, scale: float):
    """:func:`real_plain` of the set ``tables`` on rows of any device, in
    :func:`_real_launch`'s form."""
    mode = _REAL_MODE[tables]
    width = n if mode == "r2c" else n // 2 + 1
    tab = plan.device_tables(n, a.dtype, a.device).real[tables]
    return real_plain(a.reshape(-1, width),
                      None if b is None else b.reshape(-1, width), n, mode,
                      tab, scale)


def real_plan(n: int, dtype: torch.dtype, tables: str,
              device) -> LaunchPlan:
    """The cached launch plan of a real mode: K1's register schedule at
    n/2 and the table set ``tables`` of n."""
    return plan.launch_plan((_build_real_plan, n, dtype, tables, device), n,
                            dtype, tables, device)


def _build_real_plan(n: int, dtype: torch.dtype, tables: str,
                     device) -> LaunchPlan:
    h = n // 2
    t = plan.device_tables(h, dtype, device)
    tab = plan.device_tables(n, dtype, device).real[tables]
    lib = _build.load()
    fn = lib.k1_real_f32 if dtype == torch.float32 else lib.k1_real_f64
    passes = plan.reg_passes(h)
    ptw = plan.to_device(plan.reg_twiddles(h), dtype, device)
    tb = _REAL_TILE_ROWS[dtype][h]
    args = (tab.data_ptr(), ptw.data_ptr(), len(t.factors),
            _build.ints(t.factors), len(passes),
            _build.ints([len(q) for q in passes]))
    return LaunchPlan(fn, args, passes, tb, tb * _reg_threads_per_row(h),
                      (t, tab, ptw), plan.VERSION)


def _real_rows(t, width: int):
    """``t`` as contiguous rows of ``width`` on a base aligned for the pair
    loads; a copy under ``cfftpack.pack`` where it is not."""
    if not t.is_contiguous() or t.data_ptr() % (2 * t.element_size()):
        with profiling.span("cfftpack.pack"):
            t = t.clone(memory_format=torch.contiguous_format)
    return t.reshape(-1, width)


def _real_check(planes, n: int) -> None:
    a = planes[0]
    if not all(t.is_cuda and t.device == a.device for t in planes):
        raise ValueError(f"K1's real modes need their planes on one CUDA "
                         f"device, got {[t.device for t in planes]}")
    if a.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != a.dtype for t in planes):
        raise TypeError(f"K1's real modes take float32 or float64 planes "
                        f"of one dtype, got {[t.dtype for t in planes]}")
    if not real_eligible(n, a.dtype):
        raise ValueError(f"K1's real modes do not take n={n} in {a.dtype}")


def _real_launch(a, b, n: int, tables: str, scale: float):
    """One launch of the real mode of ``tables`` on CUDA rows: r2c of the
    real rows ``a`` -> the packed pair, c2r of the packed planes ``a``,
    ``b`` -> the real rows."""
    mode = _REAL_MODE[tables]
    _real_check((a,) if b is None else (a, b), n)
    h = n // 2
    width = n if mode == "r2c" else h + 1
    a2 = _real_rows(a, width)
    b2 = None if b is None else _real_rows(b, width)
    rows = a2.shape[0]
    if rows >= 2 ** 31:
        raise ValueError(f"K1 takes fewer than 2^31 rows, got {rows}")
    if mode == "r2c":
        out = (torch.empty((rows, h + 1), dtype=a.dtype, device=a.device),
               torch.empty((rows, h + 1), dtype=a.dtype, device=a.device))
    else:
        out = (torch.empty((rows, n), dtype=a.dtype, device=a.device), None)
    if rows:
        lp = real_plan(n, a.dtype, tables, a.device)
        err = _build.call(
            "K1", lp.fn, a.device, int(mode == "c2r"), a2.data_ptr(),
            None if b2 is None else b2.data_ptr(), out[0].data_ptr(),
            None if out[1] is None else out[1].data_ptr(), *lp.tables[:2],
            rows, h, *lp.tables[2:], lp.tile_rows, lp.threads, scale)
        if err != 0:
            raise RuntimeError(f"K1 {mode} launch failed at n={n}, "
                               f"rows={rows}, {a.dtype}: CUDA error {err}")
    return out if mode == "r2c" else out[0]


def srfft_real(x, n: int, scale: float = 1.0, tables: str = "rfft"):
    """``core.srfft`` of the (..., n) real rows ``x`` through K1's r2c
    mode with the table set ``tables`` (``rfft``, or ``irfft_adj`` as the
    adjoint of c2r), times ``scale``: the packed (re, im) pair of n/2 + 1
    bins.  The caller guarantees ``real_eligible(n, dtype)``.
    Differentiable: the adjoint is :func:`sirfft_real` with the transposed
    set at the same scale."""
    if _adjoint.needs_grad(x):
        adj = _REAL_ADJOINT[tables]
        return _adjoint.linear(
            lambda v: srfft_real(v, n, scale, tables),
            lambda gr, gi: sirfft_real(gr, gi, n, scale, adj), x)
    profiling.real_maps["r2c"] += 1
    lead = x.shape[:-1]
    run = _real_plain_rows if x.device.type == "cpu" else _real_launch
    yr, yi = run(x, None, n, tables, scale)
    h1 = n // 2 + 1
    return yr.reshape(lead + (h1,)), yi.reshape(lead + (h1,))


def sirfft_real(yr, yi, n: int, scale: float = 1.0, tables: str = "irfft"):
    """``core.sirfft`` of the packed (..., n/2 + 1) pair through K1's c2r
    mode with the table set ``tables`` (``irfft``, or ``rfft_adj`` as the
    adjoint of r2c): the (..., n) real rows times n * ``scale``.  The
    imaginary parts of bins 0 and n/2 are read as the JAX package's c2r
    reads them.  Differentiable: the adjoint is :func:`srfft_real` with
    the transposed set at the same scale."""
    if _adjoint.needs_grad(yr, yi):
        adj = _REAL_ADJOINT[tables]
        return _adjoint.linear(
            lambda a, b: sirfft_real(a, b, n, scale, tables),
            lambda g: srfft_real(g, n, scale, adj), yr, yi)
    profiling.real_maps["c2r"] += 1
    lead = yr.shape[:-1]
    run = _real_plain_rows if yr.device.type == "cpu" else _real_launch
    return run(yr, yi, n, tables, scale).reshape(lead + (n,))


# ------------------------------------------- the interleaved complex mode

def cplx_eligible(n: int, dtype: torch.dtype) -> bool:
    """Whether complex rows of length ``n`` and ``dtype`` take K1's
    interleaved mode: complex64 or complex128 with n a register length of
    the real dtype."""
    if dtype not in (torch.complex64, torch.complex128):
        return False
    return n in plan.REG_LENGTHS[dtype.to_real()]


def _cplx_rows(x, n: int):
    """``x`` as contiguous rows of n (re, im) pairs on a base aligned for
    the pair loads, with no conjugate or negative bit; one copy under
    ``cfftpack.pack`` where it is not so."""
    if (x.is_conj() or x.is_neg() or not x.is_contiguous()
            or x.data_ptr() % x.element_size()):
        with profiling.span("cfftpack.pack"):
            x = x.clone(memory_format=torch.contiguous_format)
    return x.reshape(-1, n)


def cplx_plan(n: int, dtype: torch.dtype, device) -> LaunchPlan:
    """The cached launch plan of the interleaved mode at (n, complex
    ``dtype``): K1's register schedule at n."""
    return plan.launch_plan((_build_cplx_plan, n, dtype, device), n,
                            dtype.to_real(), device)


def _build_cplx_plan(n: int, dtype: torch.dtype, device) -> LaunchPlan:
    t = plan.device_tables(n, dtype, device)
    lib = _build.load()
    fn = lib.k1_cplx_f32 if dtype == torch.float32 else lib.k1_cplx_f64
    passes = plan.reg_passes(n)
    ptw = plan.to_device(plan.reg_twiddles(n), dtype, device)
    tb = _reg_tile_rows(n, dtype)
    args = (ptw.data_ptr(), len(t.factors), _build.ints(t.factors),
            len(passes), _build.ints([len(q) for q in passes]))
    return LaunchPlan(fn, args, passes, tb, tb * _reg_threads_per_row(n),
                      (t, ptw), plan.VERSION)


def _cplx_check(x2, n: int) -> None:
    if not x2.is_cuda:
        raise ValueError(f"K1 needs a CUDA tensor, got {x2.device}")
    if not cplx_eligible(n, x2.dtype):
        raise ValueError(f"K1's interleaved mode does not take n={n} in "
                         f"{x2.dtype}")
    if x2.shape[0] >= 2 ** 31:
        raise ValueError(f"K1 takes fewer than 2^31 rows, got "
                         f"{x2.shape[0]}")


def _cplx_launch(x2, n: int, inverse: bool, scale: float):
    """One launch of the interleaved mode on the CUDA rows ``x2``."""
    _cplx_check(x2, n)
    rows = x2.shape[0]
    y = torch.empty_like(x2)
    if rows:
        lp = cplx_plan(n, x2.dtype, x2.device)
        err = _build.call("K1", lp.fn, x2.device, x2.data_ptr(),
                          y.data_ptr(), lp.tables[0], rows, n,
                          *lp.tables[1:], int(inverse), lp.tile_rows,
                          lp.threads, scale)
        if err != 0:
            raise RuntimeError(f"K1 interleaved launch failed at n={n}, "
                               f"rows={rows}, {x2.dtype}: CUDA error {err}")
    return y


def _cplx_plain(x2, n: int, inverse: bool, scale: float):
    """The interleaved mode's plain version: K1's plain one on the
    ``view_as_real`` planes of the rows ``x2``, joined into pairs."""
    v = torch.view_as_real(x2)
    yr, yi = sfft_plain(v[..., 0], v[..., 1], n, inverse)
    if scale != 1.0:
        yr, yi = yr * scale, yi * scale
    return torch.complex(yr, yi)


def cfft_interleaved(x, n: int, inverse: bool, scale: float = 1.0):
    """The DFT over the last axis of the complex tensor ``x`` through K1's
    interleaved mode, times ``scale`` (applied in the store): a new
    contiguous complex tensor of ``x``'s shape.  The caller guarantees
    ``cplx_eligible(n, x.dtype)``.  Differentiable: the adjoint is the
    other direction at the same scale."""
    if _adjoint.needs_grad(x):
        return _adjoint.linear(
            lambda v: cfft_interleaved(v, n, inverse, scale),
            lambda g: cfft_interleaved(g, n, not inverse, scale), x)
    x2 = _cplx_rows(x, n)
    run = _cplx_plain if x2.device.type == "cpu" else _cplx_launch
    return run(x2, n, inverse, scale).reshape(x.shape)
