"""Transform planning: factorization, twiddle tables, fast sizes.

Counterpart of ``cfftpack_tpu/plan.py``, whose numpy code it copies:
importing ``cfftpack_tpu.plan`` would load JAX through the package's
``__init__``.  Everything here is host numpy in float64, except
:func:`device_tables`, which turns one length's tables into tensors of
the working dtype on the working device and caches them.

* ``factor`` mirrors FFTPACK's greedy factorization (``factor_``):
  radices 4, 2, 3, 5 first, then ascending odd trial factors.
* ``stage_twiddles`` holds the per-Stockham-stage twiddles as dense
  (p, m/p) arrays.
* ``fft_next_fast_size`` and friends mirror cfftextra.c:20-82.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .utils import profiling

# Largest prime factor handled by a direct in-line DFT stage; beyond it
# Bluestein's chirp-z algorithm runs.
MAX_DIRECT_RADIX = 32
# The largest radix of a register pass (K1 and K5, csrc/regfft.cuh): a
# thread holds one pass's R elements of a butterfly in registers.
REG_MAX_RADIX = 16
# The lengths the register kernels are compiled for (K1 in
# ``csrc/stockham_fft.cu``), by dtype: :func:`reg_passes` schedules them.
REG_LENGTHS = {torch.float32: (480, 512, 960, 1024, 2048, 4096, 8192),
               torch.float64: (480, 512, 960, 1024, 2048, 4096)}


def _factor_py(n: int) -> tuple[int, ...]:
    """Greedy factorization into radices (4,2,3,5, then odd primes)."""
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")
    fac = []
    while n % 4 == 0:
        fac.append(4)
        n //= 4
    for p in (2, 3, 5):
        while n % p == 0:
            fac.append(p)
            n //= p
    p = 7
    while n > 1:
        while n % p == 0:
            fac.append(p)
            n //= p
        p += 2
        if p * p > n and n > 1:
            fac.append(n)
            break
    return tuple(fac)


@functools.lru_cache(maxsize=4096)
def factor(n: int) -> tuple[int, ...]:
    return _factor_py(n)


def max_prime_factor(n: int) -> int:
    return max(factor(n)) if n > 1 else 1


def is_smooth(n: int, primes: Sequence[int] = (2, 3, 5)) -> bool:
    if n < 1:
        return False
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def needs_bluestein(n: int) -> bool:
    """True when n has a prime factor too large for a direct DFT stage."""
    return n > 1 and max_prime_factor(n) > MAX_DIRECT_RADIX


def fft_next_fast_size(n: int) -> int:
    """Next 5-smooth size >= n (cfftextra.c:20-38 behavior)."""
    n = max(n, 2)
    while not is_smooth(n):
        n += 1
    return n


def fft_next_fast_even_size(n: int) -> int:
    """Next even 5-smooth size >= n (cfftextra.c:40-46)."""
    n = max(n, 2)
    if n % 2:
        n += 1
    while not is_smooth(n):
        n += 2
    return n


def fft_next_fast_size_2nm1(n: int) -> int:
    """Next n >= given such that 2n-1 is 5-smooth (cfftextra.c:48-62)."""
    n = max(n, 2)
    while not is_smooth(2 * n - 1):
        n += 1
    return n


def fft_next_fast_size_2np1(n: int) -> int:
    """Next n >= given such that 2n+1 is 5-smooth (cfftextra.c:64-82)."""
    n = max(n, 1)
    while not is_smooth(2 * n + 1):
        n += 1
    return n


def next_stream_size(x: int, max_m: int = 4096) -> int | None:
    """Smallest N = 128*m >= x with m a 5-smooth multiple of 16 and
    m <= max_m: the shape the streaming four-step kernels (K2, K3, K4 in
    ``ops/stream_fft.py``) take.  None when x exceeds that cap."""
    if x > 128 * max_m:
        return None
    m = max(16, -(-x // 128))
    m += (-m) % 16
    while m <= max_m and not is_smooth(m):
        m += 16
    if m > max_m:
        return None
    return 128 * m


@functools.lru_cache(maxsize=1024)
def stage_twiddles(n: int) -> tuple[np.ndarray, ...]:
    """Per-stage Stockham twiddle tables for length ``n``.

    Stage s with radix p and remaining sub-length m (product of factors
    s..end) uses ``tw[k, j] = exp(-2j*pi*k*j/m)`` of shape (p, m//p).
    The forward transform multiplies by ``tw``; the inverse by
    ``conj(tw)``.
    """
    out = []
    m = n
    for p in factor(n):
        mn = m // p
        k = np.arange(p).reshape(p, 1)
        j = np.arange(mn).reshape(1, mn)
        out.append(np.exp((-2j * np.pi / m) * (k * j)))
        m = mn
    return tuple(out)


@functools.lru_cache(maxsize=256)
def dft_matrix(p: int) -> np.ndarray:
    """Dense p x p forward DFT matrix D[k, j] = exp(-2j*pi*k*j/p)."""
    k = np.arange(p).reshape(p, 1)
    j = np.arange(p).reshape(1, p)
    return np.exp((-2j * np.pi / p) * (k * j))


@functools.lru_cache(maxsize=64)
def _dense_dft(n1: int, inverse: bool, dtype, device):
    """:func:`dft_matrix` (conjugated for the inverse) as device planes."""
    D = dft_matrix(n1)
    if inverse:
        D = np.conj(D)
    return (to_device(D.real, dtype, device),
            to_device(D.imag, dtype, device))


def host_fft(x: np.ndarray) -> np.ndarray:
    """Host-side (numpy, float64) unscaled forward DFT on the same
    Stockham schedule as the device path; used only to build plan
    constants, so no external FFT is needed anywhere."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    if n == 1:
        return x.copy()
    S = x.reshape(-1, 1, n)
    L, m = 1, n
    for p, tw in zip(factor(n), stage_twiddles(n)):
        mn = m // p
        T = S.reshape(-1, L, p, mn)
        U = np.einsum("kp,blpj->blkj", dft_matrix(p), T)
        U *= tw[None, None]
        S = U.transpose(0, 2, 1, 3).reshape(-1, L * p, mn)
        L *= p
        m = mn
    return S.reshape(x.shape)


@functools.lru_cache(maxsize=512)
def bluestein_tables(n: int, m: int | None = None
                     ) -> tuple[int, np.ndarray, np.ndarray]:
    """Host tables (m, chirp, bq) for Bluestein's chirp-z FFT of length
    ``n``: m is the 5-smooth convolution length >= 2n-1, chirp[j] =
    exp(-1j*pi*j^2/n), and bq the unscaled length-m forward DFT of the
    circular chirp-conjugate kernel."""
    if m is None:
        m = fft_next_fast_size(2 * n - 1)
    elif m < 2 * n - 1 or not is_smooth(m):
        raise ValueError(f"bluestein pad m={m} must be a 5-smooth "
                         f"size >= 2n-1 = {2 * n - 1}")
    # exponent j^2 mod 2n keeps the angle exact for large n
    jsq = (np.arange(n, dtype=np.int64) ** 2) % (2 * n)
    chirp = np.exp((-1j * np.pi / n) * jsq)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(chirp)
    b[m - n + 1:] = np.conj(chirp[1:][::-1])
    bq = host_fft(b)
    return m, chirp, bq


# ------------------------------------------------ real transforms' tables
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
    of 8 coefficients a bin (``fused_fft._real_merge``,
    ``fused_fft.srfft_real``): ``rfft``, the r2c form of ``rfft_merge``
    over bins 0 .. h, DC = Zr + Zi and Nyquist = Zr - Zi of Z[0] with zero
    imaginary rows; ``irfft``, the c2r form, ``irfft_merge`` by bin; with
    ``adjoint``, ``rfft_adj`` and ``irfft_adj``, their transposes, the
    other form each."""
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


def _rfilter_tables(n: int):
    """Host tables c1..c4 (complex, h bins) for the fused real filter.

    Derivation: compose srfft's packed merge Y = Ze + w*Zo, the
    spectral multiply V = F*Y, and sirfft's un-merge Z' = (1+i*conj(w))V
    + (1-i*conj(w))*conj(V_mirror) into Z' = P*Z + Q*conj(Z_mirror)
    with P = c1*F + c3*conj(Fm), Q = c2*F + c4*conj(Fm): the filter
    then needs no packed (n/2+1)-bin spectrum at all.
    """
    h = n // 2
    k = np.arange(h)
    w = np.exp(-2j * np.pi * k / n)
    A = 1 + 1j * np.conj(w)
    B = 1 - 1j * np.conj(w)
    return (A * (1 - 1j * w) / 2, A * (1 + 1j * w) / 2,
            B * (1 + 1j * w) / 2, B * (1 - 1j * w) / 2)


# ------------------------------------------------------- device plans

def host_tables(n: int) -> dict:
    """Every host table a length-``n`` transform reads, as numpy f64.

    Keys: ``factors``; ``twiddles`` (stage tables); ``dense`` ({p:
    dft_matrix(p)} for radices 7..31); ``bluestein`` ((m, chirp, bq)
    or None); ``rfft_merge``, ``irfft_merge`` (8 real tables each) and
    ``rfilter`` (4 complex tables), None for odd n.  A ``source`` dict
    given to :func:`device_tables` has the same keys.
    """
    facs = factor(n)
    even = n > 1 and n % 2 == 0
    return {
        "factors": facs,
        "twiddles": stage_twiddles(n),
        "dense": {p: dft_matrix(p) for p in set(facs)
                  if 5 < p <= MAX_DIRECT_RADIX},
        "bluestein": bluestein_tables(n) if needs_bluestein(n) else None,
        "rfft_merge": _rfft_merge_tables(n) if even else None,
        "irfft_merge": _irfft_merge_tables(n) if even else None,
        "rfilter": _rfilter_tables(n) if even else None,
    }


@dataclass(frozen=True)
class DeviceTables:
    """One length's plan as tensors of one dtype on one device.

    ``twr``/``twi`` are the flat stage twiddles (forward sign) with
    stage s at ``offs[s]:offs[s+1]``; ``dr``/``di`` the dense DFT
    matrices of the radices 7..31, stage s at ``dense_offs[s]`` (0
    for closed-form radices).  ``dense`` maps p to (Dr, Di) views.
    ``bluestein`` is (m, chirp_r, chirp_i, bq_r, bq_i); ``real`` (even
    n) maps the real transforms' table sets (:func:`real_tables`,
    built in float64 from ``rfft_merge`` and ``irfft_merge``, the
    transposed sets where n/2 has a register schedule, so K1's real modes
    run) to (bins, 8) tensors;
    ``rfilter`` is a tuple of h-bin tensors.
    """
    n: int
    factors: tuple[int, ...]
    offs: tuple[int, ...]
    twr: torch.Tensor
    twi: torch.Tensor
    dense_offs: tuple[int, ...]
    dr: torch.Tensor
    di: torch.Tensor
    dense: dict
    bluestein: tuple | None
    real: dict | None
    rfilter: tuple | None


@functools.lru_cache(maxsize=None)
def reg_passes(n: int) -> tuple[tuple[int, ...], ...]:
    """:func:`factor`'s stages grouped, in order, into the passes of the
    register kernels (``csrc/regfft.cuh``): each pass takes stages while
    their radices multiply to at most ``REG_MAX_RADIX``."""
    passes, cur = [], []
    for p in factor(n):
        if cur and math.prod(cur) * p > REG_MAX_RADIX:
            passes.append(tuple(cur))
            cur = []
        cur.append(p)
    passes.append(tuple(cur))
    return tuple(passes)


def reg_twiddles(n: int) -> np.ndarray:
    """The register kernels' pass twiddles, float64 (re, im) pairs.

    For each pass of sub-radices q_1..q_g (R = q_1*...*q_g) with
    MN = n / (L*R) > 1, L the product of the earlier passes' radices: for
    j < MN, digit i < g and 1 <= d < q_i, the forward W_{R*MN}^{d*h_i*j}
    with h_i = q_1*...*q_{i-1}; pass after pass.  A butterfly's twiddle
    for output u = sum_i d_i*h_i is the product of its digits' entries,
    so it reads sum(q_i - 1) pairs instead of R - 1.
    """
    out, L = [], 1
    for q in reg_passes(n):
        R = math.prod(q)
        mn = n // (L * R)
        if mn > 1:
            k = np.array([d * math.prod(q[:i]) for i, qi in enumerate(q)
                          for d in range(1, qi)])
            j = np.arange(mn)[:, None]
            out.append(np.exp(-2j * np.pi * j * k[None, :] / (R * mn)).ravel())
        L *= R
    w = np.concatenate(out) if out else np.zeros(1, dtype=np.complex128)
    return np.stack([w.real, w.imag], axis=-1)


_DEVICE_TABLES: dict = {}
# Bumped whenever a cached plan is replaced or dropped, so that launch
# plans holding pointers into the tables (:func:`launch_plan`) know to
# rebuild.
VERSION = 0
_LAUNCH_PLANS: dict = {}


def clear_device_tables() -> None:
    global VERSION
    _DEVICE_TABLES.clear()
    VERSION += 1


def to_device(a, dtype, device) -> torch.Tensor:
    """A float64 numpy table as a tensor of ``dtype`` on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
    return t.to(dtype).to(device)


def _flat_twiddles(tabs):
    """(offsets, re, im): stage tables concatenated as K1 reads them,
    stage s at ``[offsets[s], offsets[s+1])`` (f64 host)."""
    offs = [0]
    for t in tabs:
        offs.append(offs[-1] + t.size)
    flat = (np.concatenate([t.ravel() for t in tabs]) if len(tabs)
            else np.zeros(0, dtype=np.complex128))
    return tuple(offs), flat.real.copy(), flat.imag.copy()


def _build(n: int, tabs: dict, dtype, device) -> DeviceTables:
    facs = tuple(int(p) for p in tabs["factors"])
    offs, twr, twi = _flat_twiddles(tabs["twiddles"])
    dense_offs, blocks, pos = [], [], 0
    for p in facs:
        if 5 < p <= MAX_DIRECT_RADIX:
            dense_offs.append(pos)
            blocks.append(np.asarray(tabs["dense"][p]).ravel())
            pos += p * p
        else:
            dense_offs.append(0)
    dflat = (np.concatenate(blocks) if blocks
             else np.zeros(0, dtype=np.complex128))
    dr = to_device(dflat.real, dtype, device)
    di = to_device(dflat.imag, dtype, device)
    dense = {}
    for p, o in zip(facs, dense_offs):
        if 5 < p <= MAX_DIRECT_RADIX:
            dense[p] = (dr[o:o + p * p].view(p, p),
                        di[o:o + p * p].view(p, p))
    blu = tabs["bluestein"]
    if blu is not None:
        m, chirp, bq = blu
        blu = (int(m),) + tuple(to_device(a, dtype, device) for a in (
            chirp.real, chirp.imag, bq.real, bq.imag))

    real = None
    if tabs["rfft_merge"] is not None:
        # the transposed sets only where K1's real modes run
        real = {k: to_device(t, dtype, device) for k, t in real_tables(
            tabs["rfft_merge"], tabs["irfft_merge"],
            n // 2 in REG_LENGTHS.get(dtype, ())).items()}
    rfl = tabs["rfilter"]
    if rfl is not None:
        rfl = tuple(to_device(part, dtype, device)
                    for c in rfl for part in (c.real, c.imag))
    return DeviceTables(
        n=n, factors=facs, offs=offs, twr=to_device(twr, dtype, device),
        twi=to_device(twi, dtype, device), dense_offs=tuple(dense_offs),
        dr=dr, di=di, dense=dense, bluestein=blu,
        real=real, rfilter=rfl)


def device_tables(n: int, dtype: torch.dtype, device, source: dict | None
                  = None) -> DeviceTables:
    """Cached device plan of length ``n`` in ``dtype`` on ``device``.

    ``source`` is a dict with the keys of :func:`host_tables` holding
    numpy tables from elsewhere (the JAX package's own, for instance).
    The plan built from it replaces the cached one for this key, so
    every transform that follows reads it; :func:`clear_device_tables`
    drops it again.
    """
    global VERSION
    device = torch.device(device)
    key = (n, dtype, device)
    if source is None:
        hit = _DEVICE_TABLES.get(key)
        if hit is not None:
            return hit
    elif key in _DEVICE_TABLES:
        VERSION += 1
    with profiling.planning():
        tables = _build(n, host_tables(n) if source is None else source,
                        dtype, device)
    _DEVICE_TABLES[key] = tables
    return tables


def launch_plan(key: tuple, *args):
    """The kernels' one cache of launch plans: the plan under ``key``, a
    tuple whose first entry is the function that builds it from ``args``
    (so two kernels' keys never meet).  Built on first use and again once
    :data:`VERSION` has moved past the plan's ``version``, each build
    under :func:`utils.profiling.planning`."""
    lp = _LAUNCH_PLANS.get(key)
    if lp is None or lp.version != VERSION:
        with profiling.planning():
            lp = _LAUNCH_PLANS[key] = key[0](*args)
    return lp
