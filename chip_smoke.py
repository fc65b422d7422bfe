"""Drive cfftpack_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Builds the CUDA kernel (K1, ``cfftpack_tpu_torch/csrc/stockham_fft.cu``)
from the checkout, holds it against its plain PyTorch version and
``torch.fft`` at the main path's shapes, then drives the main path
through the public entry points (the bench headline ``fft_split`` at
n = 1024 x 4096, the flagship rfft -> multiply -> irfft step, the conv
option pricer in float64, Bluestein and four-step lengths) and checks
each result.  Prints CUDA-event times of K1 and its plain version, one
JSON line describing the kernels, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero; without a CUDA card it exits non-zero before printing
a result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

import cfftpack_tpu_torch as ct
from cfftpack_tpu_torch.entry import entry
from cfftpack_tpu_torch.models import (bs_cf, conv_bsvg_option,
                                       conv_option_price)
from cfftpack_tpu_torch.ops import _build, fused_fft

DEV = "cuda"
# the reference's variance-gamma benchmark (test/vargamma.c:108-121) and
# the reference binary's conv price at N = 2^16 (tests/test_models.py)
VG = dict(S=100.0, K=98.0, sigma=0.12, theta=-0.14, kappa=0.2, t=1.0, r=0.05)
VG_CONV = 9.342473370823516
# phase 2: the CPU test's lengths plus 4096, ragged and full batches
K1_SIZES = (4, 8, 60, 64, 243, 899, 960, 1024, 4096)
K1_BATCHES = (37, 4096)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok  {what}")


def rel_err(got, want) -> float:
    got = got.to(torch.complex128) if got.is_complex() else got.double()
    want = want.to(torch.complex128) if want.is_complex() else want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def pair(shape, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=DEV, dtype=dtype),
            torch.randn(shape, generator=g, device=DEV, dtype=dtype))


@contextlib.contextmanager
def plain_engine():
    """Run the transform path with K1's plain version in place of the
    kernel, on the same card, for comparison and timing only."""
    kernel = fused_fft.sfft_fused

    def plain(xr, xi, n, inverse):
        shape = xr.shape
        yr, yi = fused_fft.sfft_plain(xr.reshape(-1, n), xi.reshape(-1, n),
                                      n, inverse)
        return yr.reshape(shape), yi.reshape(shape)

    fused_fft.sfft_fused = plain
    try:
        yield
    finally:
        fused_fft.sfft_fused = kernel


def median_ms(fn, reps: int = 30, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bs_closed_form(S, K, sigma, t, r):
    from scipy.special import ndtr
    d1 = (np.log(S / K) + t * (r + 0.5 * sigma * sigma)) / (sigma * np.sqrt(t))
    d2 = d1 - sigma * np.sqrt(t)
    return S * ndtr(d1) - K * ndtr(d2) * np.exp(-r * t)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # ---- phase 1: setup and build
    print("phase 1: setup and build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.load()
    print(f"  K1 built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")

    # ---- phase 2: K1 against its plain version and torch.fft
    print("phase 2: K1 vs plain version and torch.fft")
    bars = {torch.float32: 1e-5, torch.float64: 1e-12}
    for dt in (torch.float32, torch.float64):
        worst_p = worst_o = 0.0
        for n in K1_SIZES:
            for b in K1_BATCHES:
                xr, xi = pair((b, n), dt, seed=n + b)
                ref = torch.fft.fft(torch.complex(xr.double(), xi.double()))
                for inv in (False, True):
                    yr, yi = fused_fft.sfft_fused(xr, xi, n, inv)
                    pr, pi = fused_fft.sfft_plain(xr, xi, n, inv)
                    torch.cuda.synchronize()
                    want = (torch.conj(torch.fft.fft(torch.conj(torch.complex(
                        xr.double(), xi.double())))) if inv else ref)
                    ep = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
                    eo = rel_err(torch.complex(yr, yi), want)
                    check(ep < bars[dt] and eo < bars[dt],
                          f"K1 {dt} n={n} b={b} inv={inv}: vs plain {ep:.2e}"
                          f", vs torch.fft {eo:.2e} < {bars[dt]:g}")
                    worst_p, worst_o = max(worst_p, ep), max(worst_o, eo)
        print(f"  {dt}: worst vs plain {worst_p:.3e}, vs torch.fft "
              f"{worst_o:.3e}")

    # ---- main path: count K1 launches from here on
    fused_fft.launches = 0
    kern_err = 0.0

    # ---- phase 3: bench headline fft_split at (4096, 1024), ortho
    print("phase 3: fft_split n=1024 batch=4096 f32 norm=ortho")
    before = fused_fft.launches
    xr, xi = pair((4096, 1024), torch.float32, seed=3)
    yr, yi = ct.fft_split(xr, xi, norm="ortho")
    torch.cuda.synchronize()
    check(fused_fft.launches > before, "K1 launched by fft_split")
    with plain_engine():
        pr, pi = ct.fft_split(xr, xi, norm="ortho")
    kern_err = max(kern_err, float(max((yr - pr).abs().max(),
                                       (yi - pi).abs().max())))
    e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
    e_o = rel_err(torch.complex(yr, yi),
                  torch.fft.fft(torch.complex(xr, xi), norm="ortho"))
    check(tuple(yr.shape) == (4096, 1024) and bool(torch.isfinite(yr).all()),
          "fft_split output shape and finite")
    check(e_p < 1e-5, f"fft_split vs plain {e_p:.2e} < 1e-5")
    check(e_o < 1e-5, f"fft_split vs torch.fft {e_o:.2e} < 1e-5")

    # ---- phase 4: flagship step at n=960, batch 64 and batch 4096
    for batch in (64, 4096):
        print(f"phase 4: flagship step n=960 batch={batch} f32")
        before = fused_fft.launches
        step, args = entry(DEV, batch=batch)
        out = step(*args)
        torch.cuda.synchronize()
        check(fused_fft.launches > before, "K1 launched by the step")
        with plain_engine():
            want = step(*args)
        e_p = rel_err(out, want)
        check(tuple(out.shape) == (batch, 960)
              and bool(torch.isfinite(out).all()), "step output shape, finite")
        check(e_p < 1e-5, f"step vs plain {e_p:.2e} < 1e-5")
        # the step's halves against torch.fft: the packed spectrum, and
        # the inverse on it (the multiply leaves DC and Nyquist complex,
        # which torch.fft.irfft would drop and the reference does not)
        v = args[0]
        sr, si = ct.rfft_split(v)
        e_o = rel_err(torch.complex(sr, si),
                      torch.fft.rfft(v.double(), norm="forward"))
        check(e_o < 1e-4, f"rfft_split vs torch.fft {e_o:.2e} < 1e-4")
        e_r = rel_err(ct.irfft_split(sr, si, 960), v)
        check(e_r < 1e-4, f"irfft_split(rfft_split(v)) vs v {e_r:.2e} < 1e-4")

    # ---- phase 5: the pricer in float64
    strikes = np.arange(80.0, 120.0, 0.5)
    bs = bs_closed_form(100.0, strikes, 0.2, 0.25, 0.03)
    for n in (4096, 1 << 14):
        print(f"phase 5: conv_option_price 80 strikes n={n} f64")
        before = fused_fft.launches

        def price():
            return conv_option_price(100.0, strikes, 0.25, 0.03,
                                     lambda u: bs_cf(u, 0.25, 0.2, 0.03),
                                     n=n, grid_sigma=0.2, device=DEV)
        got = price()
        check(fused_fft.launches > before, "K1 launched by the pricer")
        with plain_engine():
            want = price()
        e_bs = float(np.abs(got - bs).max())
        e_p = float(np.abs(got - want).max() / np.abs(want).max())
        check(got.shape == (80,) and bool(np.isfinite(got).all()),
              "prices shape and finite")
        check(e_bs < 5e-3, f"vs Black-Scholes {e_bs:.2e} < 5e-3")
        check(e_p < 1e-12, f"vs plain {e_p:.2e} < 1e-12")
    print("phase 5: conv_bsvg_option VG n=2^16 f64")
    before = fused_fft.launches
    vg = conv_bsvg_option(1 << 16, VG["S"], VG["K"], VG["sigma"], VG["theta"],
                          VG["kappa"], VG["t"], VG["r"], is_bs=False,
                          device=DEV)
    check(fused_fft.launches > before, "K1 launched by the VG pricer")
    with plain_engine():
        vg_plain = conv_bsvg_option(1 << 16, VG["S"], VG["K"], VG["sigma"],
                                    VG["theta"], VG["kappa"], VG["t"],
                                    VG["r"], is_bs=False, device=DEV)
    check(abs(vg - vg_plain) < 1e-12 * abs(vg_plain),
          f"VG {vg!r} vs plain {vg_plain!r}")
    check(abs(vg - VG_CONV) < 1e-7,
          f"VG vs the reference conv price {abs(vg - VG_CONV):.2e} < 1e-7")

    # ---- phase 6: Bluestein and four-step routes
    for n, b in ((1009, 1024), (65536, 64)):
        print(f"phase 6: fft_split n={n} batch={b} f32")
        before = fused_fft.launches
        xr, xi = pair((b, n), torch.float32, seed=n)
        yr, yi = ct.fft_split(xr, xi, norm="backward")
        torch.cuda.synchronize()
        check(fused_fft.launches > before, "K1 launched")
        with plain_engine():
            pr, pi = ct.fft_split(xr, xi, norm="backward")
        e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
        e_o = rel_err(torch.complex(yr, yi),
                      torch.fft.fft(torch.complex(xr.double(), xi.double())))
        check(e_p < 1e-5, f"vs plain {e_p:.2e} < 1e-5")
        check(e_o < 1e-4, f"vs torch.fft {e_o:.2e} < 1e-4")
    launches = fused_fft.launches
    check(launches > 0, f"main path launched K1 {launches} times")

    # ---- phase 7: times (CUDA-event medians)
    print("phase 7: times")
    xr, xi = pair((4096, 1024), torch.float32, seed=7)
    k1_ms = median_ms(lambda: fused_fft.sfft_fused(xr, xi, 1024, False))
    plain_ms = median_ms(lambda: fused_fft.sfft_plain(xr, xi, 1024, False))
    path_ms = median_ms(lambda: ct.fft_split(xr, xi, norm="ortho"))
    with plain_engine():
        path_plain_ms = median_ms(lambda: ct.fft_split(xr, xi, norm="ortho"))
    xc = torch.complex(xr, xi)
    cufft_ms = median_ms(lambda: torch.fft.fft(xc))
    g = torch.Generator(device=DEV).manual_seed(8)
    pay = torch.rand((80, 16384), generator=g, device=DEV, dtype=torch.float64)
    fr, fi = pair((8193,), torch.float64, seed=9)
    fi[0] = 0.0
    fi[-1] = 0.0
    pr_ms = median_ms(lambda: ct.rfilter_split(pay, fr, fi))
    with plain_engine():
        pr_plain_ms = median_ms(lambda: ct.rfilter_split(pay, fr, fi))
    rows = [
        ("K1 sfft_fused (4096, 1024) f32", k1_ms),
        ("plain sfft_plain (4096, 1024) f32", plain_ms),
        ("fft_split K1 path (4096, 1024) f32 ortho", path_ms),
        ("fft_split plain path (4096, 1024) f32 ortho", path_plain_ms),
        ("cuFFT torch.fft.fft (4096, 1024) complex64", cufft_ms),
        ("rfilter_split K1 path (80, 16384) f64", pr_ms),
        ("rfilter_split plain path (80, 16384) f64", pr_plain_ms),
    ]
    for name, ms in rows:
        print(f"  time {name}: {ms:.4f} ms  [{card}]")

    print(json.dumps({"kernels": [{
        "name": "stockham_fft (K1)",
        "route": "cuda",
        "source": "cfftpack_tpu_torch/csrc/stockham_fft.cu",
        "replaces": "cfftpack_tpu/ops/pallas_fft.py:90",
        "launches": launches,
        "max_abs_err": kern_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
