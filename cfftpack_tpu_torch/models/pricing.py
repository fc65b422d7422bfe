"""Convolution option pricer (Lord et al 2008 / Carr-Madan family).

Counterpart of ``cfftpack_tpu/models/pricing.py``, the batched analog
of the reference's ``conv_bsvg_option`` (test/vargamma.c:42-106:
payoff grid -> rfft -> multiply by the characteristic function ->
irfft -> read the at-the-money point).  Strikes are a leading batch
axis, so one transform prices the whole strike ladder, and the
rfft -> multiply -> irfft chain runs as one ``rfilter_split``.
The default dtype is float64, the reference's double contract.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..parallel._comm import axis_index, axis_size, check_mesh, mesh_device
from ..ops.rfft import rfilter_split
from ..plan import fft_next_fast_even_size
from .chfun import bs_cf, vg_cf

__all__ = ["conv_option_price", "conv_bsvg_option"]


def conv_option_price(S, K, t, r, phi_fn, n: int = 1 << 14,
                      grid_sigma=None, is_call=True, mesh=None,
                      batch_axis_name: str = "data", device=None,
                      dtype: torch.dtype = torch.float64):
    """Price European options by FFT convolution.

    ``K`` may be a scalar or an array of strikes (batched).
    ``phi_fn(u)`` -> complex ndarray: characteristic function of the
    log-price increment over [0, t] including drift.
    ``grid_sigma`` sets the log-price grid width L = 20*sigma*sqrt(t)
    (the reference's rule of thumb, vargamma.c:52).  The transform runs
    on ``device`` (the card unless the caller names another,
    ``config.resolve_device``) in ``dtype``.

    ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``).  The strike
    ladder, padded to a multiple of ``mesh[batch_axis_name]``, is sharded
    over that axis: each rank prices its slice on its own device, and one
    ``all_gather_into_tensor`` on the axis's group returns the whole
    ladder on every rank.  Every rank of the mesh calls it.
    """
    if mesh is not None:
        check_mesh(mesh)
        device = mesh_device(mesh)
    else:
        device = resolve_device(device)
    K = np.atleast_1d(np.asarray(K, dtype=np.float64))
    N = fft_next_fast_even_size(n)
    N2 = N // 2
    if grid_sigma is None:
        raise ValueError("grid_sigma is required (sets the grid width)")
    L = 2 * 10 * grid_sigma * np.sqrt(t)
    ds = L / N
    du = 2 * np.pi / (ds * N)
    i = np.arange(N)
    s = np.log(S) + (N2 - i) * ds                  # (N,) log-price grid
    payoff = (np.maximum(np.exp(s)[None, :] - K[:, None], 0.0) if is_call
              else np.maximum(K[:, None] - np.exp(s)[None, :], 0.0))
    u = np.arange(N2 + 1) * du
    phi = np.asarray(phi_fn(u), dtype=np.complex128)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64).to(device=device,
                                                          dtype=dtype)

    if mesh is None:
        # standard packed layout: the factor is conj(phi)
        out = rfilter_split(dev(payoff), dev(phi.real), dev(-phi.imag))
        atm = out[:, N2]
    else:
        atm = _ladder_sharded(payoff, phi, N2, mesh, batch_axis_name, dev)
    value = atm[: len(K)].cpu().double().numpy() * np.exp(-r * t)
    return value if value.size > 1 else float(value[0])


def _ladder_sharded(payoff, phi, N2: int, mesh, batch_axis_name: str, dev):
    """This rank's slice of the padded ladder through ``rfilter_split``,
    then the at-the-money values of every rank, gathered."""
    nb = axis_size(mesh, batch_axis_name)
    pad = (-len(payoff)) % nb
    if pad:
        payoff = np.concatenate([payoff, payoff[:1].repeat(pad, 0)], 0)
    b = len(payoff) // nb
    i = axis_index(mesh, batch_axis_name)
    out = rfilter_split(dev(payoff[i * b:(i + 1) * b]), dev(phi.real),
                        dev(-phi.imag))
    local = out[:, N2].contiguous()
    atm = local.new_empty(nb * b)
    dist.all_gather_into_tensor(atm, local,
                                group=mesh.get_group(batch_axis_name))
    return atm


def conv_bsvg_option(n, S, K, sigma, theta, kappa, t, r,
                     is_call=True, is_bs=True, device=None,
                     dtype: torch.dtype = torch.float64):
    """Signature-compatible analog of the reference's conv_bsvg_option
    (vargamma.c:42): Black-Scholes or Variance-Gamma by flag."""
    if is_bs:
        phi_fn = lambda u: bs_cf(u, t, sigma, r)        # noqa: E731
    else:
        phi_fn = lambda u: vg_cf(u, t, sigma, theta, kappa, r)  # noqa: E731
    return conv_option_price(S, K, t, r, phi_fn, n=n, grid_sigma=sigma,
                             is_call=is_call, device=device, dtype=dtype)
