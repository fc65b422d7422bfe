"""Validation of cfftpack_tpu_torch on the card: every transform family
against the reference-C golden vectors in float32, through the public
API, and each kernel's direct leg through its wrapper.

Run: python scripts/torch_validate.py [--device cpu]

The counterpart of scripts/tpu_validate.py.  Runs on the CUDA card
unless ``--device cpu`` is given (without a card it raises).  Prints a
per-family max relative error table (bar 5e-5 in float32, 1e-13 for the
float64 legs), then ``k/N families within f32 tolerance``, and exits 1
if any row fails.  :func:`validate` returns the rows.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch  # noqa: E402

import cfftpack_tpu_torch as ct  # noqa: E402
from cfftpack_tpu_torch.config import resolve_device  # noqa: E402
from cfftpack_tpu_torch.ops import (colfft, core, rstream,  # noqa: E402
                                    stream_fft)

# the module, not the function of the same name that ops exports
dct_ops = importlib.import_module("cfftpack_tpu_torch.ops.dct")

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "tests", "golden", "golden.npz")
F32_TOL, F64_TOL = 5e-5, 1e-13


def relerr(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1e-30, np.abs(want).max())
    return float(np.abs(got - want).max() / scale)


def validate(device) -> list:
    """Rows (name, relative error, "OK" or "FAIL") of every leg, on
    ``device``."""
    dev = torch.device(device)
    g = np.load(GOLDEN)
    rows = []

    def check(name, err, tol=F32_TOL):
        rows.append((name, err, "OK" if err < tol else "FAIL"))

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def host(*planes):
        """numpy of a tensor, or of re + 1j*im of two."""
        a = [p.cpu().double().numpy() for p in planes]
        return a[0] if len(a) == 1 else a[0] + 1j * a[1]

    # complex fft via the split API
    for n in (60, 101, 960, 1024, 1250):
        x = g[f"fft_in_{n}"]
        got = host(*ct.fft_split(f32(x.real), f32(x.imag)))
        check(f"fft n={n}", relerr(got, g[f"fft_fwd_{n}"]))

    # rfft via the split API (reference packing relation)
    for n in (60, 960, 1024):
        got = host(*ct.rfft_split(f32(g[f"rfft_in_{n}"])))
        ref = g[f"rfft_fwd_{n}"]
        hi = n // 2
        err = max(relerr(got[0], ref[0]),
                  relerr(2 * np.conj(got[1:hi]), ref[1:hi]))
        check(f"rfft n={n}", err)

    # real families through the public API
    fams = [("dct", 3, ct.dct), ("dct1", 1, ct.dct), ("dct4", 4, ct.dct),
            ("dst", 3, ct.dst), ("dst1", 1, ct.dst), ("dst4", 4, ct.dst),
            ("dct5", 5, ct.dct), ("dct8", 8, ct.dct),
            ("dst5", 5, ct.dst), ("dst8", 8, ct.dst)]
    for fam, t, fn in fams:
        n = 60 if f"{fam}_in_60" in g else 13
        got = host(fn(f32(g[f"{fam}_in_{n}"]), t))
        check(f"{fam} n={n}", relerr(got, g[f"{fam}_fwd_{n}"]))

    # the named kernel (impl="pallas": the four-step kernel K10)
    for n in (960, 1024):
        x = g[f"fft_in_{n}"]
        got = host(*ct.fft_split(f32(x.real), f32(x.imag), impl="pallas"))
        check(f"fft[pallas] n={n}", relerr(got, g[f"fft_fwd_{n}"]))

    # gdft via the split API
    x = g["gdft_in_60_0.5_0.0"]
    got = host(*ct.gdft_split(f32(x.real), f32(x.imag), a=0.0, b=0.5))
    check("gdft a_ref=.5", relerr(got, g["gdft_fwd_60_0.5_0.0"]))

    # 2-D DCT
    got = host(ct.dctn(f32(g["dct2d_in_8x6"]), 3))
    check("dct_2d 8x6", relerr(got, g["dct2d_fwd_8x6"]))

    # the 2-D split API vs numpy
    r4 = np.random.default_rng(4)
    a = r4.standard_normal((2, 24, 36)).astype(np.float32)
    b = r4.standard_normal((2, 24, 36)).astype(np.float32)
    got = host(*ct.fft2_split(f32(a), f32(b), norm="ortho"))
    want2 = np.fft.fft2(a.astype(np.float64) + 1j * b.astype(np.float64),
                        norm="ortho")
    check("fft2_split 24x36", relerr(got, want2))
    sr, si = ct.rfft2_split(f32(a))
    wantr = np.fft.rfft2(a.astype(np.float64)) / (24 * 36)
    check("rfft2_split 24x36", relerr(host(sr, si), wantr))
    back = host(ct.irfft2_split(sr, si, (24, 36)))
    check("irfft2_split roundtrip", relerr(back, a))

    # Bluestein on a batch of two.  tpu_validate.py also forces the
    # stream-eligible pad here through _stream_pad_for_bluestein; that
    # hook is a TPU pad preference, which the port does not carry.
    n = 101
    x = g[f"fft_in_{n}"]
    xb = np.stack([x, 2.0 * x])
    got = host(*ct.fft_split(f32(xb.real), f32(xb.imag)))
    check(f"fft bluestein n={n}",
          max(relerr(got[0], g[f"fft_fwd_{n}"]),
              relerr(got[1], 2.0 * g[f"fft_fwd_{n}"])))

    # float64 at (64, 2048) (tpu_validate.py holds the double-float
    # four-step engine against the flat one here; the card runs float64
    # natively, so fft_hp is held against torch.fft in complex128)
    xq = r4.standard_normal((64, 2048)).astype(np.float32)
    yq = r4.standard_normal((64, 2048)).astype(np.float32)
    xh = torch.complex(f32(xq), f32(yq)).to(torch.complex128)
    check("fft_hp 64x2048 vs torch.fft",
          relerr(ct.fft_hp(xh).cpu().numpy(),
                 torch.fft.fft(xh, norm="forward").cpu().numpy()),
          tol=F64_TOL)

    # float64 through the main API, at the C library's double bar
    n = 60
    x = torch.as_tensor(g[f"fft_in_{n}"], device=dev)            # complex128
    check(f"fft f64-route n={n}",
          relerr(ct.fft(x).cpu().numpy(), g[f"fft_fwd_{n}"]), tol=F64_TOL)
    x = torch.as_tensor(g[f"dct_in_{n}"], device=dev)             # float64
    check(f"dct f64-route n={n}",
          relerr(ct.dct(x, 3).cpu().numpy(), g[f"dct_fwd_{n}"]), tol=F64_TOL)

    # the column kernel K6 through its wrapper
    ac = r4.standard_normal((2, 64, 256)).astype(np.float32)
    bc = r4.standard_normal((2, 64, 256)).astype(np.float32)
    got = host(*colfft.scolfft(f32(ac), f32(bc), scale=0.5))
    wantc = np.fft.fft(ac.astype(np.float64) + 1j * bc.astype(np.float64),
                       axis=-2) * 0.5
    check("colfft 64x256 (scaled)", relerr(got, wantc))

    # the real-stream kernel K7 through its wrappers
    xs = r4.standard_normal((4, 2048)).astype(np.float32)
    yr, yi = rstream.srfft_stream(f32(xs), 2048)
    check("rstream rfft n=2048",
          relerr(host(yr, yi), np.fft.rfft(xs.astype(np.float64))))
    back = host(rstream.sirfft_stream(yr, yi, 2048)) / 2048
    check("rstream irfft roundtrip", relerr(back, xs))

    # the DCT-IV stream kernel K8 through its wrapper, against the core
    # (K1 at the half length 2048)
    n = 4096
    xd = f32(r4.standard_normal((4, n)).astype(np.float32))
    check(f"dct4 stream tail n={n}",
          relerr(host(dct_ops._dct4_stream(xd, n)),
                 host(dct_ops._dct4_core(xd, n))))

    # the split-stream kernel K5 at 2^20, against the in-core four-step
    n = 1 << 20
    xr6 = f32(r4.standard_normal((2, n)).astype(np.float32))
    xi6 = f32(r4.standard_normal((2, n)).astype(np.float32))
    got = host(*stream_fft.sfft_stream_split(xr6, xi6, n, False))
    want = host(*core._fourstep_local(xr6, xi6, n, False))
    check("split-stream n=2^20 vs fourstep", relerr(got, want))

    # the column DCT-II (K9) vs the DCT-II over the moved axis
    xcd = f32(r4.standard_normal((2, 64, 256)).astype(np.float32))
    want = dct_ops._dct2_core(xcd.movedim(-2, -1).contiguous(),
                              64).movedim(-1, -2)
    check("coldct2 64x256", relerr(host(colfft.scoldct(xcd, 2)), host(want)))
    return rows


def report(rows) -> int:
    """Print the table and the summary line; the number of failures."""
    width = max(len(r[0]) for r in rows) + 2
    bad = 0
    for name, err, status in rows:
        print(f"  {name:<{width}} rel err {err:.2e}  {status}")
        bad += status != "OK"
    print(f"{len(rows) - bad}/{len(rows)} families within f32 tolerance"
          + ("" if not bad else f"  ({bad} FAILED)"))
    return bad


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend: {name} ({dev.type})")
    sys.exit(1 if report(validate(dev)) else 0)


if __name__ == "__main__":
    main()
