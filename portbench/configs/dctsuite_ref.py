"""Plain reference of dctsuite: every transform of the suite as a dense
matrix product, in float64.

Each matrix is built from an exact integer angle, reduced before it is
turned into a float: k(2j+1) mod 4n for the DCT-II/III and DST-II/III
(the DST's with k+1 or j+1 in k's place), (2k+1)(2j+1) mod 8n for the
DCT-IV, jk mod n for the real DFT.  FFTPACK's scales, as the port's
``dct``, ``dst`` and ``rfft_split`` state them under ``norm="fftpack"``:
the forwards carry them, the inverses none.

    rfft:  yr + i yi = (1/n) sum_j x_j e^{-2 pi i jk/n}, k = 0 .. n/2
    irfft: x_j = sum_k w_k (yr_k cos(2 pi jk/n) - yi_k sin(2 pi jk/n)),
           w = 1 at k = 0 and n/2, else 2
    DCT-II:  y_k = (2/n) sum_j x_j cos(pi k(2j+1)/(2n))
    DCT-III: y_k = x_0/2 + sum_{j>=1} x_j cos(pi j(2k+1)/(2n))
    DST-II:  y_k = (2/n) sum_j x_j sin(pi (k+1)(2j+1)/(2n))
    DST-III: y_k = (-1)^k x_{n-1}/2 + sum_{j<n-1} x_j sin(pi (j+1)(2k+1)/(2n))
    DCT-IV:  y_k = (2/n) sum_j x_j cos(pi (2k+1)(2j+1)/(4n)), its
             inverse the same sum unscaled

No FFT algorithm and nothing of the program.  Each reconstruction's
reference is the reference's own inverse of its own forward.  Rows go
through in blocks, so that the reference fits beside the run; TF32 is
off in PyTorch while it runs, so that no product is rounded unasked.

The checks (``compare``), each the largest over the three lengths of the
largest gap over the reference's largest value: ``rfft_err`` (both
planes), ``dct2_err``, ``dst2_err``, ``dct4_err``, and ``recon_err``,
the largest over all twelve reconstructions.  The control is the same
code in float32 with TF32 products (``conv960_ref._mm``), one precision
below the configuration's float32.
"""
from __future__ import annotations

import functools
import math

import torch

from portbench.compare import MaxRel
from portbench.configs.conv960_ref import _mm

ROWS = 4096                    # rows a block
FAMILIES = ("rfft", "dct2", "dst2", "dct4")
CHECKS = tuple(f + "_err" for f in FAMILIES) + ("recon_err",)


def _trig(fn, num, den: int):
    """fn(pi * num / den) for the exact integers ``num``, in float64."""
    return fn((math.pi / den) * num.double())


@functools.lru_cache(maxsize=12)
def matrices(n: int, dtype, device) -> dict:
    """The [j, k]-indexed matrices of length n, each forward with
    FFTPACK's scale: y = x @ m["dct2"], x' = y @ m["dct3"], and so on;
    the real DFT's forward as the pair (fr, fi) = (cos, -sin) / n, its
    inverse as (ir, ii) = (w cos, -w sin), k-major."""
    j = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    c2 = _trig(torch.cos, (k * (2 * j + 1)) % (4 * n), 2 * n)
    c3 = c2.T.clone()
    c3[0] *= 0.5
    s2 = _trig(torch.sin, ((k + 1) * (2 * j + 1)) % (4 * n), 2 * n)
    s3 = s2.T.clone()
    s3[n - 1] *= 0.5
    c4 = _trig(torch.cos, ((2 * k + 1) * (2 * j + 1)) % (8 * n), 4 * n)
    h = n // 2
    twice = 2 * ((j * k[:, : h + 1]) % n)
    cos, msin = _trig(torch.cos, twice, n), -_trig(torch.sin, twice, n)
    w = torch.full((h + 1, 1), 2.0, dtype=torch.float64, device=device)
    w[0] = 1.0
    if n % 2 == 0:
        w[h] = 1.0
    mats = {"fr": cos / n, "fi": msin / n, "ir": w * cos.T,
            "ii": w * msin.T, "dct2": c2 * (2 / n), "dct3": c3,
            "dst2": s2 * (2 / n), "dst3": s3, "dct4": c4 * (2 / n),
            "idct4": c4}
    return {name: m.to(dtype).contiguous() for name, m in mats.items()}


def suite(x, m: dict, tf32: bool = False) -> tuple:
    """The nine outputs of one length, in the program's order, of the
    rows ``x``, from the matrices ``m``."""
    yr, yi = _mm(x, m["fr"], tf32), _mm(x, m["fi"], tf32)
    outs = [yr, yi, _mm(yr, m["ir"], tf32) + _mm(yi, m["ii"], tf32)]
    for fwd, inv in (("dct2", "dct3"), ("dst2", "dst3"), ("dct4", "idct4")):
        y = _mm(x, m[fwd], tf32)
        outs += [y, _mm(y, m[inv], tf32)]
    return tuple(outs)


def _blocks(sizes, inputs, slot, dtype, tf32: bool):
    """Yield (length index, rows, outputs of those rows) of one call, in
    blocks of ROWS, TF32 off in PyTorch meanwhile."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for i, n in enumerate(sizes["lengths"]):
            x = inputs["x"][n][slot]
            mats = matrices(n, dtype, x.device)
            for r0 in range(0, x.shape[0], ROWS):
                rows = slice(r0, min(r0 + ROWS, x.shape[0]))
                yield i, rows, suite(x[rows].to(dtype), mats, tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# each output's accumulator: the spectrum's two planes share one
SHARED = {0: "rfft", 1: "rfft", 2: "rfft_rec", 3: "dct2", 4: "dct2_rec",
          5: "dst2", 6: "dst2_rec", 7: "dct4", 8: "dct4_rec"}


def compare(sizes, traffic, inputs, calls):
    """The five checks over the calls ({index: (slot, outputs)}) against
    the float64 reference; a call with outputs of another count fails
    every check."""
    lengths = range(len(sizes["lengths"]))
    acc = {(i, a): MaxRel() for i in lengths for a in SHARED.values()}
    for slot, outs in calls.values():
        if len(outs) != 9 * len(lengths):
            return dict.fromkeys(CHECKS, math.inf)
        for i, rows, want in _blocks(sizes, inputs, slot, torch.float64,
                                     False):
            for o, a in SHARED.items():
                acc[i, a].add(outs[9 * i + o][rows].double(), want[o])
    errs = {f + "_err": max(acc[i, f].value() for i in lengths)
            for f in FAMILIES}
    errs["recon_err"] = max(acc[i, f + "_rec"].value() for i in lengths
                            for f in FAMILIES)
    return errs


def control(sizes, traffic):
    """The reference in float32 with TF32 products in the program's
    place: a call of the same form as the program's."""
    def call(inputs, slot):
        parts = {}
        for i, _, outs in _blocks(sizes, inputs, slot, torch.float32, True):
            parts.setdefault(i, []).append(outs)
        return tuple(torch.cat(c) for i in sorted(parts)
                     for c in zip(*parts[i]))
    return call
