"""Option-pricing demos on cfftpack_tpu_torch: the reference's acceptance
workloads.

Prints the tables of test/vargamma.c (BS + VG convergence sweep),
test/blackscholes.cpp (strike ladder), test/montecarlo.c (MC vs QMC
convergence), test/vg_mc.cpp (VG Monte Carlo) and test/shortrate.cpp
(callable bond), as examples/pricing_demo.py does for the JAX package.
Each ``demo_*`` function prints its table and returns its rows as plain
numbers.

Run: python examples/torch_pricing_demo.py [bsvg|strikes|qmc|vgmc|shortrate|all] [--device cpu]

The demos run on the CUDA card unless ``--device cpu`` is given; without
a card they raise.  On the card the card's name and power limit are
printed first and the ``Time`` column is the card's wall time.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from cfftpack_tpu_torch.config import resolve_device  # noqa: E402
from cfftpack_tpu_torch.models import (asian_option_qmc, bs_cf,  # noqa: E402
                                       callable_bond_demo, conv_bsvg_option,
                                       conv_option_price, vg_mc_price,
                                       vg_mc_price_device)
from cfftpack_tpu_torch.utils import black_scholes_option  # noqa: E402

VG_TARGET = 9.3424659413582116       # QuantLib (vargammaql.cpp)
BSVG_NS = tuple(1 << k for k in range(7, 19))
SHORTRATE_MODELS = ((1, "Hull-White"), (0, "Black-Karasinski"),
                    (5, "alpha-stable + shifted exp"))


def demo_bsvg(device=None):
    """Rows (n, conv BS, BS error, conv VG, VG - QuantLib, seconds)."""
    S, K, sigma, theta, kappa, r, t = 100.0, 98.0, 0.12, -0.14, 0.2, 0.05, 1.0
    cbs = float(black_scholes_option(S, K, sigma, t, r, True))
    print("\nStock Option Pricing Benchmark (vargamma.c analog)")
    print(f"BS closed form: {cbs:.12f}")
    print(f"{'N':>10}{'CONV BS':>20}{'Error':>16}{'CONV VG':>20}"
          f"{'VG-QL err':>16}{'Time':>10}")
    rows = []
    for n in BSVG_NS:
        t0 = time.perf_counter()
        c_bs = conv_bsvg_option(n, S, K, sigma, theta, kappa, t, r,
                                True, True, device=device)
        c_vg = conv_bsvg_option(n, S, K, sigma, theta, kappa, t, r,
                                True, False, device=device)
        dt = time.perf_counter() - t0
        print(f"{n:>10}{c_bs:>20.12f}{c_bs - cbs:>16.2e}"
              f"{c_vg:>20.12f}{c_vg - VG_TARGET:>16.2e}{dt:>10.4f}")
        rows.append((n, c_bs, c_bs - cbs, c_vg, c_vg - VG_TARGET, dt))
    return rows


def demo_strikes(device=None):
    """Rows (strike, BS call, conv call, % error) of one batched call."""
    S, sigma, r, t = 100.0, 0.15, 0.03, 1.0 / 12.0
    strikes = np.arange(85.0, 115.1, 2.5)
    print("\nStrike ladder (blackscholes.cpp analog) — ONE batched call")
    got = conv_option_price(S, strikes, t, r,
                            lambda u: bs_cf(u, t, sigma, r),
                            n=8192, grid_sigma=sigma, device=device)
    print(f"{'Strike':>8}{'BS Call':>12}{'CONV Call':>12}{'% err':>12}")
    rows = []
    for K, c in zip(strikes, np.atleast_1d(got)):
        c1 = float(black_scholes_option(S, K, sigma, t, r, True))
        pct = 100 * (c - c1) / c1
        print(f"{K:>8.2f}{c1:>12.6f}{c:>12.6f}{pct:>12.7f}")
        rows.append((float(K), c1, float(c), float(pct)))
    return rows


def demo_qmc(device=None):
    """Rows (samples, qmc, mean, stdev, the ten runs' prices)."""
    print("\nQuasi-Monte Carlo (montecarlo.c analog): "
          "DCT-IV Brownian paths vs plain MC")
    rows = []
    for samples in (500, 1000, 2000):
        for qmc in (True, False):
            vals = [asian_option_qmc(samples=samples, qmc=qmc, run_index=i,
                                     seed=11, device=device)
                    for i in range(10)]
            mean, std = float(np.mean(vals)), float(np.std(vals, ddof=1))
            print(f"  samples={samples:>5} {'QMC' if qmc else ' MC'}: "
                  f"mean {mean:>9.6f}  stdev {std:>9.6f}")
            rows.append((samples, qmc, mean, std, tuple(vals)))
    return rows


def demo_vgmc(device=None):
    """Rows (("host", price), ("device", price)) at 200000 draws."""
    print("\nVariance-Gamma inverse-CDF Monte Carlo (vg_mc.cpp analog)")
    p = vg_mc_price(samples=200000, seed=3, device=device)
    print(f"  VG call price (host sampling):   {p:.6f}  "
          f"(QuantLib target 9.342466)")
    # the whole pipeline on the device (pass mesh= to shard the draws)
    pd_ = vg_mc_price_device(samples=200000, seed=3, device=device)
    print(f"  VG call price (device pipeline): {pd_:.6f}")
    return [("host", p), ("device", pd_)]


def demo_shortrate(device=None):
    """Rows (model, straight, check, callable)."""
    print("\nFFT short-rate lattice (shortrate.cpp analog, QuantLib-free)")
    rows = []
    for model, name in SHORTRATE_MODELS:
        straight, check, callable_pv = callable_bond_demo(
            model=model, nstep=120, n_fft=512, maturity=10.0, device=device)
        print(f"  {name:<28} straight {straight:>12.4f}  "
              f"check {check:>12.4f}  callable {callable_pv:>12.4f}")
        rows.append((model, float(straight), float(check),
                     float(callable_pv)))
    return rows


DEMOS = {"bsvg": demo_bsvg, "strikes": demo_strikes, "qmc": demo_qmc,
         "vgmc": demo_vgmc, "shortrate": demo_shortrate}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=(*DEMOS, "all"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line())
    return {name: fn(device) for name, fn in DEMOS.items()
            if args.which in (name, "all")}


if __name__ == "__main__":
    main()
