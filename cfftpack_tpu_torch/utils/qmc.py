"""Quasi-Monte-Carlo utilities: normal CDF and its inverse, Halton, BS.

Counterpart of ``cfftpack_tpu/utils/qmc.py`` (the reference's scalar
helpers of test/util.c, vectorized): Acklam's inverse-normal
approximation with one Halley refinement (util.c:55-105), the Halton
sequence over the first primes (util.c:108-168) on the host
(:func:`halton`) and on the device (:func:`halton_batch`), and the
Black-Scholes closed form (util.c:171-180).  The reference's xorshift
PRNG is replaced by seeded ``torch.Generator`` draws where a model
needs random numbers.

The tensor functions keep a tensor's device; any other array-like goes
to the default device (``config.as_tensor``).  ``primes``, ``halton``
and ``black_scholes_option`` are host numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import as_tensor, resolve_device

__all__ = ["normal_cdf", "normal_icdf", "halton", "halton_batch", "primes",
           "black_scholes_option"]

_SQRT2 = float(np.sqrt(2.0))
_SQRT2PI = float(np.sqrt(2.0 * np.pi))


def _float(x):
    x = as_tensor(x)
    return x if x.dtype.is_floating_point else x.to(torch.float64)


def normal_cdf(x):
    """Standard normal CDF, 0.5 * (1 + erf(x / sqrt 2))."""
    x = _float(x)
    return 0.5 * (1.0 + torch.special.erf(x / _SQRT2))


# Acklam's rational approximations (coefficients are published constants)
_A = (-3.969683028665376e+01, 2.209460984245205e+02,
      -2.759285104469687e+02, 1.383577518672690e+02,
      -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02,
      -1.556989798598866e+02, 6.680131188771972e+01,
      -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01,
      -2.400758277161838e+00, -2.549732539343734e+00,
      4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01,
      2.445134137142996e+00, 3.754408661907416e+00)


def _poly(coefs, t):
    acc = coefs[0]
    for c in coefs[1:]:
        acc = acc * t + c
    return acc


def normal_icdf(p):
    """Inverse standard normal CDF: Acklam + one Halley step.

    Branch-free (``torch.where``) form of util.c:55-105; absolute error
    below about 1e-15 in float64 after the refinement.
    """
    p = _float(p)
    q = torch.minimum(p, 1.0 - p)
    qc = torch.clamp(q, 1e-300, 0.5)
    # central region
    u_ = qc - 0.5
    t_ = u_ * u_
    central = u_ * _poly(_A, t_) / (_poly(_B, t_) * t_ + 1.0)
    # tail region
    t2 = torch.sqrt(-2.0 * torch.log(qc))
    tail = _poly(_C, t2) / (_poly(_D, t2) * t2 + 1.0)
    u = torch.where(qc > 0.02425, central, tail)
    # one Halley refinement to machine precision
    err = normal_cdf(u) - qc
    f_over_df = err * _SQRT2PI * torch.exp(u * u / 2.0)
    u = u - f_over_df / (1.0 + u * f_over_df / 2.0)
    u = torch.where(p > 0.5, -u, u)
    u = torch.where(p <= 0.0, -torch.inf, u)
    return torch.where(p >= 1.0, torch.inf, u)


def primes(k: int) -> np.ndarray:
    """First k primes (sieve; the reference hardcodes 512,
    util.c:110-137)."""
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    # upper bound via p_k < k (ln k + ln ln k) for k >= 6
    n = 15 if k < 6 else int(k * (np.log(k) + np.log(np.log(k))) + 3)
    sieve = np.ones(n + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(n ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p:: p] = False
    return np.flatnonzero(sieve)[:k].astype(np.int64)


def halton(index, dimensions: int) -> np.ndarray:
    """Halton points for the given index/indices (radical inverse per
    prime base), host numpy.  ``index`` scalar -> (dimensions,); array
    (B,) -> (B, dimensions).  Matches util.c:147-168 with any dimension
    count."""
    idx = np.atleast_1d(np.asarray(index, dtype=np.int64))
    ps = primes(dimensions)
    out = np.zeros((idx.size, dimensions))
    for d in range(dimensions):
        b = int(ps[d])
        k = idx.copy()
        f = 1.0
        h = np.zeros(idx.size)
        while np.any(k > 0):
            f /= b
            h += (k % b) * f
            k //= b
        out[:, d] = h
    if np.isscalar(index) or np.ndim(index) == 0:
        return out[0]
    return out


def halton_batch(start_index: int, count: int, dimensions: int,
                 dtype: torch.dtype = torch.float32, device=None):
    """Halton points ``start_index .. start_index + count - 1`` as a
    ``(count, dimensions)`` tensor, made on ``device`` (the card unless
    the caller names another, ``config.resolve_device``).

    All integer arithmetic on the device, in int64: digit j of index i
    in base b is ``(i // b^j) % b``, and the digits, reversed, form the
    numerator of the radical inverse ``sum_j d_j b^(k-1-j) / b^k`` (k
    the base-b digit count of the last index; both integers are exact
    in float64), so each point is that quotient rounded once to float64,
    then to ``dtype``.  The last index must be below 2**31, the
    reference's bound.
    """
    device = resolve_device(device)
    if count <= 0:
        return torch.zeros((0, dimensions), dtype=dtype, device=device)
    last = int(start_index) + int(count) - 1
    if last >= 1 << 31:
        raise ValueError(
            f"halton_batch: last index {last} >= 2**31 overflows the "
            "reference's int32 index arithmetic (split the sweep into "
            "blocks below 2**31)")
    b = [int(p) for p in primes(dimensions)]
    k = [1] * dimensions                   # base-b digit count of `last`
    for d, base in enumerate(b):
        while base ** k[d] <= last:
            k[d] += 1
    idx = torch.arange(int(start_index), last + 1, dtype=torch.int64,
                       device=device)[:, None]
    bt = torch.as_tensor(b, dtype=torch.int64, device=device)
    num = torch.zeros((int(count), dimensions), dtype=torch.int64,
                      device=device)
    # the bases ascend, so their digit counts do not: digit level j runs
    # on the columns [0, c) whose base still has a digit there
    for j in range(k[0]):
        c = sum(kd > j for kd in k)
        pw, wt = (torch.as_tensor(v, dtype=torch.int64, device=device)
                  for v in ([base ** j for base in b[:c]],
                            [base ** (kd - 1 - j) for base, kd
                             in zip(b[:c], k[:c])]))
        num[:, :c] += (idx // pw) % bt[:c] * wt
    den = torch.as_tensor([float(base ** kd) for base, kd in zip(b, k)],
                          dtype=torch.float64, device=device)
    return (num.to(torch.float64) / den).to(dtype)


def black_scholes_option(S, K, sigma, t, r, is_call=True):
    """Black-Scholes closed form (util.c:171-180), host float64,
    vectorized over S, K, t and r."""
    S, K, t, r = (np.asarray(v, dtype=np.float64) for v in (S, K, t, r))
    sqt = np.sqrt(t)
    df = np.exp(-r * t)
    d1 = (np.log(S / K) + t * (r + sigma * sigma * 0.5)) / (sigma * sqt)
    d2 = d1 - sigma * sqt
    cdf = normal_cdf(torch.as_tensor(np.stack(np.broadcast_arrays(d1, d2)),
                                     device="cpu")).numpy()
    C = S * cdf[0] - K * cdf[1] * df
    if is_call:
        return C
    return C - S + K * df
