"""Characteristic functions of the Levy processes used by the pricers.

A copy of ``cfftpack_tpu/models/chfun.py`` (numpy only): importing
that module would load JAX through its package.

Host-side (numpy complex128) — these are evaluated on fixed frequency
grids during setup and feed device code as split (re, im) constants.
Sources mirror the reference apps: GBM/BS and Variance-Gamma
(Hirsa & Madan 2001; test/vargamma.c:74-93), Normal, NIG
(Hainaut & MacGilchrist 2010; test/shortrate.cpp:267-283), alpha-stable
(test/shortrate.cpp:285-310).
"""
from __future__ import annotations

import numpy as np

__all__ = ["bs_cf", "vg_cf", "normal_cf", "nig_cf", "alpha_stable_cf",
           "heston_cf", "cf_moment_sigma"]


def bs_cf(u, t, sigma, r):
    """GBM characteristic function with risk-neutral drift."""
    u = np.asarray(u, dtype=np.float64)
    drift = r - 0.5 * sigma * sigma
    psi = -0.5 * sigma * sigma * u * u * t + 1j * u * t * drift
    return np.exp(psi)


def vg_cf(u, t, sigma, theta, kappa, r):
    """Variance-Gamma with the Hirsa-Madan risk-neutral drift."""
    u = np.asarray(u, dtype=np.float64)
    drift = r + (1.0 / kappa) * np.log(
        1.0 - sigma * sigma * kappa / 2.0 - theta * kappa)
    tmp = 1.0 + sigma * sigma * kappa * u * u / 2.0 - 1j * theta * kappa * u
    return np.power(tmp, -t / kappa) * np.exp(1j * drift * u * t)


def normal_cf(sigma):
    """Driftless normal: phi(u, dt) = exp(-sigma^2 u^2 dt / 2)."""
    def phi(u, dt):
        u = np.asarray(u, dtype=np.float64)
        return np.exp(-0.5 * sigma * sigma * u * u * dt) + 0j
    return phi


def nig_cf(alpha, beta, delta):
    """Normal-Inverse-Gaussian process characteristic function."""
    gamma = np.sqrt(alpha * alpha - beta * beta)

    def phi(u, dt):
        u = np.asarray(u, dtype=np.float64)
        a = gamma - np.sqrt(alpha * alpha - (beta + 1j * u) ** 2)
        return np.exp(delta * a * dt)
    return phi


def alpha_stable_cf(alpha, beta, c):
    """Alpha-stable Levy: alpha in (0,2], beta in [-1,1], scale c."""
    def phi(u, dt):
        u = np.asarray(u, dtype=np.float64)
        if abs(alpha - 1.0) < 1e-6:
            with np.errstate(divide="ignore"):
                Phi = -np.log(np.abs(u)) * 2.0 / np.pi
            Phi = np.where(np.isfinite(Phi), Phi, 0.0)
        else:
            Phi = np.tan(np.pi * alpha / 2.0)
        sgn = np.where(u >= 0, 1.0, -1.0)
        psi = -np.abs(c * u) ** alpha * (1.0 - 1j * beta * sgn * Phi)
        return np.exp(psi * dt)
    return phi


def cf_moment_sigma(phi, t, h: float = 0.1) -> float:
    """Finite-difference stddev estimate of a process over horizon t
    (the grid-sizing rule of thumb, vg_mc.cpp:46-52 /
    shortrate.cpp:111-128)."""
    fu = phi(h, t)
    fd = phi(-h, t)
    fm = phi(0.0, t)
    if abs(fm.real - 1) > 1e-12 or abs(fm.imag) > 1e-12:
        raise ValueError("characteristic function must satisfy phi(0) == 1")
    dphi = (fu - fd) / (2 * h)
    d2phi = (fu + fd - 2.0) / (h * h)
    var = (-d2phi + dphi * dphi).real
    return float(np.sqrt(var))


def heston_cf(u, t, v0, kappa, theta, sigma, rho, r):
    """Heston stochastic-volatility characteristic function of log S_t
    (the "little Heston trap" formulation, Albrecher et al 2007 — the
    numerically stable branch).  Not in the reference, but the standard
    companion model for the Carr-Madan conv pricer family."""
    u = np.asarray(u, dtype=np.float64)
    iu = 1j * u
    d = np.sqrt((rho * sigma * iu - kappa) ** 2 + sigma ** 2 * (iu + u * u))
    g = (kappa - rho * sigma * iu - d) / (kappa - rho * sigma * iu + d)
    ee = np.exp(-d * t)
    C = (r * iu * t
         + kappa * theta / sigma ** 2
         * ((kappa - rho * sigma * iu - d) * t
            - 2.0 * np.log((1.0 - g * ee) / (1.0 - g))))
    D = (kappa - rho * sigma * iu - d) / sigma ** 2 \
        * (1.0 - ee) / (1.0 - g * ee)
    return np.exp(C + D * v0)
