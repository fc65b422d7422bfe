"""Scalar root finding: Brent's method.

Counterpart of ``cfftpack_tpu/utils/roots.py`` (a copy: that module
imports no JAX, but the port imports nothing of the JAX package).
Host-side root finder for the short-rate mesh calibration (the reference
uses QuantLib's Brent, test/shortrate.cpp:196-216).  The objective may
run device code; the bracketing and bisection stay scalar Python.
"""
from __future__ import annotations

__all__ = ["brent"]


def _bracket(f, guess, step, lo, hi, max_tries=60):
    """Expand outward from guess until f changes sign (QuantLib-style)."""
    a, fa = guess, f(guess)
    if fa == 0.0:
        return a, a, fa, fa
    d = step if step > 0 else 1e-4
    for _ in range(max_tries):
        b = min(a + d, hi)
        fb = f(b)
        if fa * fb <= 0:
            return a, b, fa, fb
        c = max(a - d, lo)
        fc = f(c)
        if fa * fc <= 0:
            return c, a, fc, fa
        d *= 2.0
        if a + d > hi and a - d < lo:
            break
    raise ValueError("brent: failed to bracket a root")


def brent(f, guess=0.0, step=0.5, lo=-1e6, hi=1e6, tol=1e-14,
          max_iter=200):
    """Find x with f(x) == 0 near ``guess``; auto-brackets then runs
    classic Brent (inverse quadratic / secant / bisection)."""
    a, b, fa, fb = _bracket(f, float(guess), float(step), lo, hi)
    if fa == 0.0:
        return a
    if fb == 0.0:
        return b
    c, fc = a, fa
    d = e = b - a
    for _ in range(max_iter):
        if fb * fc > 0:
            c, fc = a, fa
            d = e = b - a
        if abs(fc) < abs(fb):
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb
        tol1 = 2.0 * 2.22e-16 * abs(b) + 0.5 * tol
        xm = 0.5 * (c - b)
        if abs(xm) <= tol1 or fb == 0.0:
            return b
        if abs(e) >= tol1 and abs(fa) > abs(fb):
            s = fb / fa
            if a == c:
                p = 2.0 * xm * s
                q = 1.0 - s
            else:
                q = fa / fc
                r = fb / fc
                p = s * (2.0 * xm * q * (q - r) - (b - a) * (r - 1.0))
                q = (q - 1.0) * (r - 1.0) * (s - 1.0)
            if p > 0:
                q = -q
            p = abs(p)
            if 2.0 * p < min(3.0 * xm * q - abs(tol1 * q), abs(e * q)):
                e = d
                d = p / q
            else:
                d = xm
                e = d
        else:
            d = xm
            e = d
        a, fa = b, fb
        b = b + (d if abs(d) > tol1 else (tol1 if xm > 0 else -tol1))
        fb = f(b)
    return b
