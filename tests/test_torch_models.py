"""The port's Monte-Carlo and short-rate models and their QMC and
root-finding utilities against the JAX package on the same inputs, and
against the reference binary's own anchors (tests/test_models.py):
the QMC Asian option (test/montecarlo.c), the VG distribution of
test/vg_mc.cpp and the short-rate lattice of test/shortrate.cpp."""
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import cfftpack_tpu.models as jm
import cfftpack_tpu.models.shortrate as jsr
import cfftpack_tpu.utils as ju
from cfftpack_tpu.models.chfun import normal_cf as j_normal_cf

from cfftpack_tpu_torch import models as pm
from cfftpack_tpu_torch import utils as pu
from cfftpack_tpu_torch.models import montecarlo, shortrate
from cfftpack_tpu_torch.models.chfun import alpha_stable_cf, normal_cf

from cfftpack_tpu_torch.parallel._comm import count_collectives

from torch_parity import one_rank_mesh, rel_err, to_np  # noqa: F401

torch.set_num_threads(1)

# the reference's variance-gamma benchmark (test/vargamma.c:108-121)
S, K, SIGMA, THETA, KAPPA, R, T = 100.0, 98.0, 0.12, -0.14, 0.2, 0.05, 1.0
VG_TARGET = 9.3424659413582116       # QuantLib (vargammaql.cpp)
CPU = {"device": "cpu"}


def test_normal_cdf_and_icdf_match_reference():
    p = np.concatenate([[0.0, 1e-300, 1e-12, 1e-6, 0.02, 0.02425, 0.3,
                         0.5, 0.7, 0.97575, 0.99, 1 - 1e-12, 1.0],
                        np.random.default_rng(3).random(200)])
    got = pu.normal_icdf(torch.from_numpy(p))
    want = np.asarray(ju.normal_icdf(jnp.asarray(p)))
    assert np.array_equal(np.isinf(to_np(got)), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(to_np(got)[fin] - want[fin]).max() < 1e-12 * \
        np.abs(want[fin]).max()
    assert got.dtype == torch.float64
    inner = p[(p > 1e-6) & (p < 1.0 - 1e-6)].astype(np.float32)
    g32 = pu.normal_icdf(torch.from_numpy(inner))
    assert g32.dtype == torch.float32
    w32 = np.asarray(ju.normal_icdf(jnp.asarray(inner)))
    assert rel_err(g32, w32) < 1e-5
    x = np.linspace(-8.0, 8.0, 161)
    assert rel_err(pu.normal_cdf(torch.from_numpy(x)),
                   ju.normal_cdf(jnp.asarray(x))) < 1e-12


def test_halton_and_primes_match_reference():
    assert np.array_equal(pu.primes(600), ju.primes(600))
    idx = np.arange(1, 400)
    assert np.array_equal(pu.halton(idx, 37), ju.halton(idx, 37))
    assert np.array_equal(pu.halton(17, 5), ju.halton(17, 5))


def _radical_inverse(i: int, b: int) -> Fraction:
    num, den = 0, 1
    while i:
        i, d = divmod(i, b)
        num, den = num * b + d, den * b
    return Fraction(num, den)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float64, jnp.float64),
                                          (torch.float32, jnp.float32)])
@pytest.mark.parametrize("start,count,dims", [(1, 300, 16), (10000, 64, 128),
                                              ((1 << 24) + 5, 40, 9)])
def test_halton_batch_is_exact(start, count, dims, dtype, jdtype):
    """Integer digits on the device: every point is the exact radical
    inverse rounded once to float64 (then to float32), and the JAX
    package's points (a float sum of up to 32 digit terms) are within a
    few roundings of them."""
    got = pu.halton_batch(start, count, dims, dtype, device="cpu")
    assert got.dtype == dtype and tuple(got.shape) == (count, dims)
    ps = pu.primes(dims)
    exact = np.array([[float(_radical_inverse(i, int(b))) for b in ps]
                      for i in range(start, start + count)])
    assert np.array_equal(to_np(got), exact.astype(to_np(got).dtype))
    want = np.asarray(ju.halton_batch(start, count, dims, jdtype))
    assert np.abs(to_np(got) - want).max() <= 4 * np.finfo(want.dtype).eps


def test_halton_batch_bounds_match_reference():
    for fn, kw in ((pu.halton_batch, CPU), (ju.halton_batch, {})):
        assert tuple(fn(5, 0, 3, **kw).shape) == (0, 3)
        with pytest.raises(ValueError, match="2\\*\\*31"):
            fn((1 << 31) - 10, 20, 3, **kw)
    last = pu.halton_batch((1 << 31) - 20, 20, 2, torch.float64, **CPU)
    assert np.abs(to_np(last) - pu.halton(
        np.arange((1 << 31) - 20, 1 << 31), 2)).max() < 1e-15


def test_halton_batch_keeps_digits_past_2_30():
    """Above 2^30 the reference drops digit levels whose base power
    passes 2^30 (ROADMAP.md queue 3, h): base 3's digit 19 at 3^19 + 5
    is lost there (2.87e-10); the port keeps every digit."""
    s = 3 ** 19 + 5
    exact = np.array([[float(_radical_inverse(i, b)) for b in (2, 3)]
                      for i in (s, s + 1)])
    got = pu.halton_batch(s, 2, 2, torch.float64, **CPU)
    assert np.array_equal(to_np(got), exact)
    ref = np.asarray(ju.halton_batch(s, 2, 2, jnp.float64))
    assert abs(ref[0, 1] - exact[0, 1]) > 2e-10


def test_black_scholes_matches_reference():
    ks = np.array([80.0, 98.0, 120.0])
    for call in (True, False):
        got = pu.black_scholes_option(S, ks, SIGMA, T, R, call)
        want = np.asarray(ju.black_scholes_option(S, ks, SIGMA, T, R, call))
        assert rel_err(got, want) < 1e-12
    c = float(pu.black_scholes_option(S, K, SIGMA, T, R, True))
    p = float(pu.black_scholes_option(S, K, SIGMA, T, R, False))
    assert abs(c - p - (S - K * np.exp(-R * T))) < 1e-10


def test_brent_matches_reference():
    for f, g in ((lambda x: x ** 2 - 4, 1.0), (np.cos, 1.0),
                 (lambda x: np.exp(x) - 3.0, -2.0)):
        assert pu.brent(f, guess=g) == ju.brent(f, guess=g)
    assert abs(pu.brent(lambda x: x ** 2 - 4, guess=1.0) - 2.0) < 1e-12
    assert abs(pu.brent(np.cos, guess=1.0) - np.pi / 2) < 1e-12
    with pytest.raises(ValueError, match="bracket"):
        pu.brent(lambda x: x * x + 1.0, lo=-1.0, hi=1.0)


def test_asian_qmc_matches_reference_binary():
    """The binary's anchors (samples=500, steps=128, tests/test_models.py)
    to 5e-14, and the JAX package's paths to 1e-12."""
    want = [1.331389466495620, 1.330757038060973, 1.326960062625530]
    got = [pm.asian_option_qmc(S=100.0, K=98.0, sigma=0.17, t=0.25, r=0.02,
                               steps=128, samples=500, is_call=False,
                               qmc=True, run_index=run, **CPU)
           for run in range(3)]
    np.testing.assert_allclose(got, want, atol=5e-14)
    z = pm.brownian_paths_qmc(64, 128, start_index=501, **CPU)
    assert rel_err(z, jm.brownian_paths_qmc(64, 128, start_index=501)) < 1e-12


@pytest.mark.parametrize("run_index", [0, 2])
def test_asian_device_form_matches_host_form(run_index):
    host = pm.asian_option_qmc(steps=128, samples=500, run_index=run_index,
                               **CPU)
    d64 = pm.asian_option_qmc_device(steps=128, samples=500,
                                     run_index=run_index,
                                     dtype=torch.float64, **CPU)
    d32 = pm.asian_option_qmc_device(steps=128, samples=500,
                                     run_index=run_index,
                                     dtype=torch.float32, **CPU)
    assert abs(d64 - host) < 1e-12 * abs(host)
    assert abs(d32 - host) < 2e-3
    ref = jm.asian_option_qmc_device(steps=128, samples=500,
                                     run_index=run_index, dtype=jnp.float64)
    assert abs(d64 - ref) < 1e-12 * abs(ref)


def test_asian_errors_and_pseudo_random_form():
    with pytest.raises(ValueError, match="even"):
        pm.asian_option_qmc(steps=7, **CPU)
    with pytest.raises(ValueError, match="even"):
        pm.asian_option_qmc_device(steps=7, **CPU)
    a = pm.asian_option_qmc(samples=4000, qmc=False, seed=3, **CPU)
    b = pm.asian_option_qmc(samples=4000, qmc=False, seed=3, **CPU)
    q = pm.asian_option_qmc(samples=4000, **CPU)
    assert a == b and abs(a - q) < 0.1


def test_vg_distribution_matches_reference_binary():
    """vg_mc.cpp's deterministic part at N = 2048: the CDF at the
    binary's quantiles (tests/test_models.py) to 2e-13."""
    out, pdf = montecarlo.vg_distribution_grid(SIGMA, THETA, KAPPA, R, T,
                                                2048, **CPU)
    cum = np.cumsum(pdf)
    want = {512: 0.000098313654346, 1024: 0.344910732462461,
            1536: 0.999999669680804, 2047: 1.000000000000000}
    for i, v in want.items():
        assert abs(cum[i] - v) < 2e-13, i
    from cfftpack_tpu.models.montecarlo import vg_distribution_grid
    jout, jpdf = vg_distribution_grid(SIGMA, THETA, KAPPA, R, T, 2048)
    assert np.array_equal(out, jout) and rel_err(pdf, jpdf) < 1e-12


@pytest.mark.parametrize("is_call", [True, False])
def test_vg_mc_body_on_the_reference_draws(is_call):
    """The device pipeline fed the JAX package's own draws gives its
    price (float64, 1e-6)."""
    n, samples, seed = 2048, 20000, 4
    draws = np.array(jax.random.uniform(jax.random.PRNGKey(seed),
                                          (samples,), jnp.float64))
    dx, ph = montecarlo._vg_grid_setup(SIGMA, THETA, KAPPA, R, T, n)
    got = float(montecarlo._vg_mc_body(
        torch.from_numpy(draws), n, is_call, (S, K, R, T),
        torch.from_numpy(ph.real.copy()), torch.from_numpy(ph.imag.copy()),
        dx))
    want = jm.vg_mc_price_device(S, K, SIGMA, THETA, KAPPA, R, T, n=n,
                                 samples=samples, seed=seed, is_call=is_call,
                                 dtype=jnp.float64)
    assert abs(got - want) < 1e-6


def test_vg_mc_prices_hit_the_target():
    host = pm.vg_mc_price(S, K, SIGMA, THETA, KAPPA, R, T, samples=200000,
                          seed=1, **CPU)
    dev = pm.vg_mc_price_device(S, K, SIGMA, THETA, KAPPA, R, T,
                                samples=200000, seed=1, **CPU)
    assert abs(host - VG_TARGET) < 0.2 and abs(dev - VG_TARGET) < 0.2
    # the same seed draws the same uniforms on both paths
    assert abs(dev - host) < 1e-3


def test_mesh_waits_for_the_parallel_layer(one_rank_mesh):
    """The sample-sharded pricers: a mesh that is not a DeviceMesh raises
    TypeError; on a one-rank gloo mesh each matches its mesh=None call
    with one all_reduce."""
    for fn, kw in ((pm.vg_mc_price_device, {"n": 256, "samples": 4096}),
                   (pm.asian_option_qmc_device, {"steps": 16,
                                                 "samples": 512})):
        with pytest.raises(TypeError, match="DeviceMesh"):
            fn(mesh=object())
        with count_collectives() as cc:
            got = fn(mesh=one_rank_mesh, **kw)
        assert cc["all_reduce"] == 1
        assert abs(got - fn(**kw, **CPU)) < 1e-12


def test_levy_maps_match_reference():
    x = np.linspace(-1.0, 1.0, 9)
    tx = torch.from_numpy(x)
    for name in ("exponential_levy", "linear_levy", "square_levy"):
        assert rel_err(getattr(shortrate, name)(tx, 0.3),
                       getattr(jsr, name)(jnp.asarray(x), 0.3)) < 1e-15
    assert rel_err(shortrate.shifted_exponential_levy(0.04)(tx, 0.3),
                   jsr.shifted_exponential_levy(0.04)(jnp.asarray(x),
                                                      0.3)) < 1e-15
    with pytest.raises(ValueError, match="conv"):
        pm.ShortRateMesh(64, np.linspace(0, 1, 5), normal_cf(0.01),
                         conv="cubic", **CPU)


@pytest.mark.parametrize("sigma,conv", [(0.01, "linear"),
                                        (0.275, "exponential")])
def test_shortrate_fit_matches_reference(sigma, conv):
    """The fitted gamma (1e-10 relative) and Arrow-Debreu prices (1e-10
    of each step's max |ad|) on test_models.py's grid, and the curve
    repriced."""
    times = np.linspace(0.0, 5.0, 41)
    disc = np.exp(-0.02 * times)
    mine = pm.ShortRateMesh(256, times, normal_cf(sigma),
                            mean_reversion=0.01, conv=conv, **CPU)
    ref = jm.ShortRateMesh(256, times, j_normal_cf(sigma),
                           mean_reversion=0.01, conv=conv)
    mine.fit(disc)
    ref.fit(disc)
    fitted = slice(0, len(times) - 1)
    assert np.abs(mine.gamma - ref.gamma)[fitted].max() < 1e-10 * \
        np.abs(ref.gamma[fitted]).max()
    err = np.abs(mine.ad - ref.ad).max(axis=1)
    assert np.all(err <= 1e-10 * np.abs(ref.ad).max(axis=1))
    for i in (5, 20, 40):
        np.testing.assert_allclose(mine.ad[i].sum(), disc[i], rtol=1e-8)


def test_shortrate_alpha_stable_fit():
    times = np.linspace(0.0, 3.0, 25)
    mesh = pm.ShortRateMesh(256, times, alpha_stable_cf(1.8, 0.0, 0.08),
                            mean_reversion=0.01, conv="shifted_exponential",
                            shift=0.02, **CPU)
    disc = np.exp(-0.02 * times)
    mesh.fit(disc)
    np.testing.assert_allclose(mesh.ad[-1].sum(), disc[-1], rtol=5e-7)


def test_callable_bond_demo_matches_reference():
    got = pm.callable_bond_demo(model=1, nstep=60, n_fft=256, maturity=5.0,
                                **CPU)
    want = jm.callable_bond_demo(model=1, nstep=60, n_fft=256, maturity=5.0)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    straight, pv_check, callable_pv = got
    np.testing.assert_allclose(pv_check, straight, rtol=1e-6)
    assert 0.5 * straight < callable_pv <= straight + 1e-6
