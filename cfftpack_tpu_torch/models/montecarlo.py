"""Monte-Carlo / quasi-Monte-Carlo spectral applications (PyTorch port).

Counterpart of ``cfftpack_tpu/models/montecarlo.py``:

* ``vg_mc_price`` / ``vg_mc_price_device``: back out the Variance-Gamma
  PDF from its characteristic function by FFT (a delta spike ->
  ``fft_split`` -> times conj(phi) -> ``ifft_split``), build the CDF,
  inverse-CDF sample it and price a call (test/vg_mc.cpp:27-114).  The
  draws ride one batch axis and the CDF lookup is one
  ``torch.searchsorted`` (the reference loops lower_bound per draw).
* ``brownian_paths_qmc`` / ``asian_option_qmc``: Brownian paths from
  Halton points through the inverse normal CDF and the orthonormal
  DCT-IV (the PCA-equivalent construction, Leobacher 2012;
  test/montecarlo.c:37-57), all samples as one (samples, steps) batch
  and one batched DCT-IV.

``jax.random`` cannot be reproduced in torch: uniform and normal draws
come from a ``torch.Generator`` on the run's device seeded with
``seed``.  Every function runs on ``device`` (the card unless the caller
names another, ``config.resolve_device``).  With ``mesh`` (a
``DeviceMesh``, ``parallel.make_mesh``) the draws are sharded over every
mesh axis: each rank runs on its own device, draws samples/D of them and
the means combine by one ``all_reduce``; every rank of the mesh calls
it and gets the price.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..parallel._comm import (all_axes_group, check_mesh, linear_index,
                              mesh_device)
from ..ops.cfft import fft_split, ifft_split
from ..ops.dct import dct
from ..ops.shift import fftshift, ifftshift
from ..utils.qmc import halton, halton_batch, normal_icdf
from .chfun import cf_moment_sigma, vg_cf

__all__ = ["vg_mc_price", "vg_mc_price_device", "asian_option_qmc",
           "asian_option_qmc_device", "brownian_paths_qmc"]


def _mesh_shard(mesh, samples: int):
    """(D, this rank's linear index, its device) of a sample-sharded
    pipeline; ``samples`` must be divisible by the mesh's rank count."""
    check_mesh(mesh)
    nd = mesh.size()
    if samples % nd:
        raise ValueError(f"samples={samples} must be divisible by the "
                         f"mesh device count {nd}")
    return nd, linear_index(mesh), mesh_device(mesh)


def _mesh_mean(local, mesh, nd: int) -> float:
    """The mean over every rank of the mesh of a 0-d tensor: one SUM
    ``all_reduce`` over all axes, then / D."""
    total = local.reshape(1).clone()
    dist.all_reduce(total, group=all_axes_group(mesh))
    return float(total[0]) / nd


def _vg_grid_setup(sigma, theta, kappa, r, t, n: int):
    """Host float64 grid setup shared by the VG paths: the grid spacing
    dx from the CF's finite-difference stddev and the conjugated
    characteristic-function table (vg_mc.cpp:44-54)."""
    N = int(n)
    N2 = N // 2

    def phi(u, dt=t):
        return vg_cf(u, dt, sigma, theta, kappa, r)

    vgsigma = cf_moment_sigma(lambda u, dt: phi(u), t)
    L = 2 * 10 * vgsigma
    dx = L / N
    du = 2 * np.pi / (dx * N)
    u = (np.arange(N) - N2) * du
    return dx, np.conj(phi(u))                # forward-in-time propagation


def _vg_pdf(n: int, phr, phi_):
    """The VG density on the grid: a delta spike at the center, FFT,
    times the shifted conj(phi), inverse FFT (vg_mc.cpp:56-77)."""
    spike = torch.zeros(n, dtype=phr.dtype, device=phr.device)
    spike[n // 2] = 1.0
    sr, si = fft_split(spike, torch.zeros_like(spike))
    sr, si = fftshift(sr), fftshift(si)
    tr = sr * phr - si * phi_
    ti = sr * phi_ + si * phr
    pdf, _ = ifft_split(ifftshift(tr), ifftshift(ti))
    return pdf


def _vg_tables(sigma, theta, kappa, r, t, n, dtype, device):
    dx, ph = _vg_grid_setup(sigma, theta, kappa, r, t, n)
    phr, phi_ = (torch.as_tensor(v, dtype=torch.float64).to(device=device,
                                                            dtype=dtype)
                 for v in (ph.real, ph.imag))
    return dx, phr, phi_


def vg_distribution_grid(sigma, theta, kappa, r, t, n: int = 2048,
                         device=None, dtype: torch.dtype = torch.float64):
    """(outcomes, pdf) as host float64 numpy for the VG log-return over
    [0, t], by FFT propagation of a delta distribution
    (vg_mc.cpp:38-77); the transform runs on ``device`` in ``dtype``."""
    device = resolve_device(device)
    N = int(n)
    dx, phr, phi_ = _vg_tables(sigma, theta, kappa, r, t, N, dtype, device)
    pdf = _vg_pdf(N, phr, phi_).cpu().double().numpy()
    outcomes = (np.arange(N) - N // 2) * dx
    return outcomes, pdf


def _uniform(samples: int, seed: int, dtype, device):
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(int(samples), generator=g, dtype=dtype, device=device)


def vg_mc_price(S=100.0, K=98.0, sigma=0.12, theta=-0.14, kappa=0.2,
                r=0.05, t=1.0, n: int = 2048, samples: int = 100000,
                seed: int = 0, device=None):
    """VG call by inverse-CDF Monte Carlo over the FFT-derived
    distribution (vg_mc.cpp end to end): the density and the float32
    draws on ``device``, the lookup and payoff on the host in float64."""
    device = resolve_device(device)
    outcomes, pdf = vg_distribution_grid(sigma, theta, kappa, r, t, n,
                                         device=device)
    cumdist = np.cumsum(pdf)
    p = _uniform(samples, seed, torch.float32, device).cpu().double().numpy()
    j = np.minimum(np.searchsorted(cumdist, p), len(outcomes) - 1)
    payoff = np.maximum(np.exp(outcomes[j]) * S - K, 0.0)
    return float(payoff.mean() * np.exp(-r * t))


def _vg_mc_body(draws, n: int, is_call: bool, params, phr, phi_, dx):
    """The device VG Monte-Carlo pipeline on given uniform ``draws``
    (vg_mc.cpp:56-108): the density (:func:`_vg_pdf`), its cumulative
    sum, the inverse-CDF lookup of every draw (nearest grid point at or
    above, clamped to n - 1, no interpolation) and the discounted mean
    payoff, as a 0-d tensor.  ``params`` is (S, K, r, t)."""
    S, K, r, t = params
    N2 = n // 2
    cdf = torch.cumsum(_vg_pdf(n, phr, phi_), dim=0)
    j = torch.clamp(torch.searchsorted(cdf, draws), max=n - 1)
    s_t = S * torch.exp((j.to(draws.dtype) - N2) * dx)
    pay = (torch.clamp(s_t - K, min=0.0) if is_call
           else torch.clamp(K - s_t, min=0.0))
    return pay.mean() * float(np.exp(-r * t))


def vg_mc_price_device(S=100.0, K=98.0, sigma=0.12, theta=-0.14, kappa=0.2,
                       r=0.05, t=1.0, n: int = 2048, samples: int = 100000,
                       seed: int = 0, is_call=True,
                       dtype: torch.dtype = torch.float32, mesh=None,
                       device=None):
    """VG call by inverse-CDF Monte Carlo with the whole pipeline on
    ``device`` in ``dtype``: distribution build, draws, CDF lookup and
    payoff mean; only the host float64 characteristic-function table
    and one scalar cross the host boundary.

    ``mesh``: rank d of D draws samples/D from a generator seeded
    ``seed*D + d`` (disjoint streams, as the JAX package's); the
    N-point distribution is built on every rank.  ``samples`` must be
    divisible by D."""
    if mesh is None:
        nd, d, device = 1, 0, resolve_device(device)
    else:
        nd, d, device = _mesh_shard(mesh, int(samples))
    dx, phr, phi_ = _vg_tables(sigma, theta, kappa, r, t, n, dtype, device)
    draws = _uniform(int(samples) // nd, seed * nd + d, dtype, device)
    price = _vg_mc_body(draws, int(n), bool(is_call), (S, K, r, t), phr,
                        phi_, float(dx))
    return float(price) if mesh is None else _mesh_mean(price, mesh, nd)


def brownian_paths_qmc(n_paths: int, steps: int, start_index: int = 1,
                       device=None, dtype: torch.dtype = torch.float64):
    """(n_paths, steps) standard-normal increments with QMC structure:
    host Halton points -> inverse normal CDF -> orthonormal DCT-IV
    (montecarlo.c:37-57; fft_ortho(dct4, true)), on ``device``."""
    device = resolve_device(device)
    pts = halton(np.arange(start_index, start_index + n_paths), steps)
    z = normal_icdf(torch.as_tensor(pts).to(device=device, dtype=dtype))
    return dct(z, type=4, norm="ortho")


def _asian_value(z, S, K, sigma, t, r, steps: int, is_call: bool):
    """Discounted mean payoff of the paths built from increments z."""
    dt = t / steps
    var = float(sigma * np.sqrt(dt))
    drift = float((r - 0.5 * sigma * sigma) * dt)
    s_path = S * torch.exp(torch.cumsum(z * var + drift, dim=-1))
    pay = (torch.clamp(s_path - K, min=0.0) if is_call
           else torch.clamp(K - s_path, min=0.0))
    return pay.mean(dim=-1).mean() * float(np.exp(-r * t))


def asian_option_qmc_device(S=100.0, K=98.0, sigma=0.17, t=0.25, r=0.02,
                            steps: int = 128, samples: int = 2000,
                            is_call=False, run_index: int = 0,
                            dtype: torch.dtype = torch.float32, mesh=None,
                            device=None):
    """Arithmetic-average Asian option with the whole QMC pipeline on
    ``device`` in ``dtype`` (vs ``asian_option_qmc``'s host Halton
    setup): Halton digits, inverse normal CDF, orthonormal DCT-IV path
    build, cumulative log-return walk and payoff mean; no host-to-device
    transfer scales with the sample count.

    ``mesh``: rank d of D draws the Halton indices start + d*S/D ..
    (start = samples*run_index + 1), so the mesh prices the same point
    set as the single-device call.  ``samples`` must be divisible by
    D."""
    if steps % 2:
        raise ValueError("steps must be even (DCT-IV path construction)")
    if mesh is None:
        nd, d, device = 1, 0, resolve_device(device)
    else:
        nd, d, device = _mesh_shard(mesh, int(samples))
    local = int(samples) // nd
    pts = halton_batch(samples * run_index + 1 + d * local, local, steps,
                       dtype, device)
    z = dct(normal_icdf(pts), type=4, norm="ortho")
    price = _asian_value(z, S, K, sigma, t, r, steps, is_call)
    return float(price) if mesh is None else _mesh_mean(price, mesh, nd)


def asian_option_qmc(S=100.0, K=98.0, sigma=0.17, t=0.25, r=0.02,
                     steps: int = 128, samples: int = 2000,
                     is_call=False, qmc=True, run_index: int = 0,
                     seed: int = 0, device=None):
    """Arithmetic-average Asian option in float64 (montecarlo.c:63-103):
    every sample path is a row; the path build, cumulative product and
    payoff average are single tensor ops.  ``qmc=False`` draws normals
    from a generator seeded with ``seed + run_index``."""
    if steps % 2:
        raise ValueError("steps must be even (DCT-IV path construction)")
    device = resolve_device(device)
    if qmc:
        z = brownian_paths_qmc(samples, steps, samples * run_index + 1,
                               device)
    else:
        g = torch.Generator(device=device).manual_seed(seed + run_index)
        z = torch.randn((samples, steps), generator=g, dtype=torch.float64,
                        device=device)
    return float(_asian_value(z, S, K, sigma, t, r, steps, is_call))
