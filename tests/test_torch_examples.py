"""The port's demo and validation scripts on the CPU:
examples/torch_pricing_demo.py against the JAX package's models on the
same calls, examples/torch_sharded_demo.py on two gloo ranks, and
scripts/torch_validate.py against the golden vectors.

The deterministic tables (bsvg, strikes, the QMC rows, shortrate) are
held against the JAX package (x64 on, tests/conftest.py).  The
Monte-Carlo rows draw from ``torch.Generator``, not ``jax.random``, so
they are held against their anchors instead.
"""
import os
import sys

import numpy as np
import pytest
import torch

import cfftpack_tpu.models as jm

from torch_parity import rel_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# on sys.path (not loaded from a file spec): the sharded demo's spawned
# ranks unpickle its rank function by module name, and spawn hands the
# parent's sys.path to them
for _d in ("examples", "scripts"):
    if os.path.join(REPO, _d) not in sys.path:
        sys.path.insert(0, os.path.join(REPO, _d))

import torch_pricing_demo as pdemo  # noqa: E402
import torch_sharded_demo as sdemo  # noqa: E402
import torch_validate  # noqa: E402

torch.set_num_threads(1)

VG_TARGET = 9.3424659413582116       # QuantLib (vargammaql.cpp)
S, K, SIGMA, THETA, KAPPA, R, T = 100.0, 98.0, 0.12, -0.14, 0.2, 0.05, 1.0


def test_pricing_bsvg_matches_jax():
    rows = pdemo.demo_bsvg("cpu")
    assert [r[0] for r in rows] == [1 << k for k in range(7, 19)]
    for n, c_bs, _, c_vg, _, _ in rows[:6]:                # 128 .. 4096
        for is_bs, got in ((True, c_bs), (False, c_vg)):
            want = jm.conv_bsvg_option(n, S, K, SIGMA, THETA, KAPPA, T, R,
                                       True, is_bs)
            assert abs(got - want) < 1e-12 * abs(want), (n, is_bs, got, want)


def test_pricing_strikes_matches_jax():
    rows = pdemo.demo_strikes("cpu")
    strikes = np.array([r[0] for r in rows])
    np.testing.assert_array_equal(strikes, np.arange(85.0, 115.1, 2.5))
    want = jm.conv_option_price(100.0, strikes, 1.0 / 12.0, 0.03,
                                lambda u: jm.bs_cf(u, 1.0 / 12.0, 0.15, 0.03),
                                n=8192, grid_sigma=0.15)
    assert rel_err(np.array([r[2] for r in rows]), want) < 1e-12


def test_pricing_qmc_matches_jax_and_mc_stands_near_it():
    rows = pdemo.demo_qmc("cpu")
    assert [(r[0], r[1]) for r in rows] == [
        (s, q) for s in (500, 1000, 2000) for q in (True, False)]
    samples, qmc, _, _, vals = rows[0]
    assert (samples, qmc) == (500, True) and len(vals) == 10
    for i in (0, 1):
        want = jm.asian_option_qmc(samples=500, qmc=True, run_index=i,
                                   seed=11)
        assert abs(vals[i] - want) < 1e-12 * abs(want), (i, vals[i], want)
    for q, mc in zip(rows[0::2], rows[1::2]):
        assert abs(mc[2] - q[2]) < 0.2, (q, mc)
        assert np.mean(mc[4]) == pytest.approx(mc[2], abs=1e-15)


def test_pricing_vgmc_stands_near_the_quantlib_anchor():
    rows = dict(pdemo.demo_vgmc("cpu"))
    assert set(rows) == {"host", "device"}
    for way, price in rows.items():
        assert abs(price - VG_TARGET) < 0.2, (way, price)


@pytest.mark.parametrize("model", [1, 0, 5])
def test_pricing_shortrate_matches_jax(model, monkeypatch):
    monkeypatch.setattr(pdemo, "SHORTRATE_MODELS",
                        tuple(m for m in pdemo.SHORTRATE_MODELS
                              if m[0] == model))
    (row,) = pdemo.demo_shortrate("cpu")
    assert row[0] == model
    want = jm.callable_bond_demo(model=model, nstep=120, n_fft=512,
                                 maturity=10.0)
    for got, w in zip(row[1:], want):
        assert abs(got - w) < 1e-9 * abs(w), (model, row, want)


def test_pricing_main_picks_tables_and_needs_a_card(monkeypatch, capsys):
    res = pdemo.main(["strikes", "--device", "cpu"])
    assert list(res) == ["strikes"] and len(res["strikes"]) == 13
    assert "Strike ladder" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdemo.main(["strikes"])


def test_sharded_demo_on_two_gloo_ranks():
    res = sdemo.main(["--device", "cpu", "--ranks", "2"])
    assert list(res["rows"]) == [
        "batch-DP fft", "four-step 1-D", "sharded 2-D fft",
        "sharded 2-D rfft", "sharded 2-D dct", "sharded pricer",
        "mesh QMC asian", "mesh VG MC"]
    for line, (err, rel) in res["rows"].items():
        assert rel <= 1e-4, (line, err, rel)
    qn, _ = res["qmc"]
    want = jm.asian_option_qmc_device(samples=4096)
    assert abs(qn - want) < 1e-5, (qn, want)
    assert abs(res["vg"] - VG_TARGET) < 0.2


@pytest.mark.parametrize("ranks", [0, 3, 6, 32])
def test_sharded_demo_rejects_indivisible_ranks(ranks):
    with pytest.raises(ValueError, match="ranks"):
        sdemo.main(["--device", "cpu", "--ranks", str(ranks)])


@pytest.mark.parametrize("ranks", [1, 2, 4, 8, 16])
def test_sharded_demo_accepts_dividing_ranks(ranks):
    sdemo.check_ranks(ranks)


def test_validate_on_the_cpu_passes_every_row(capsys):
    rows = torch_validate.validate("cpu")
    assert len(rows) == 35
    assert [r for r in rows if r[2] != "OK"] == []
    assert torch_validate.report(rows) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        "35/35 families within f32 tolerance"
