"""Plain reference of fft2_4096: the 2-D DFT as dense matrices.

A checked image X (n0, n1) is drawn again whole from its ranks' seeds
(``seeded.py``, as ``fft2_4096.py`` draws each rank's rows), and a rank's
rows of its spectrum are F0[rows] @ X @ F1 / (n0 n1), FFTPACK's forward
scaling, with F[j, k] = exp(-2 pi i jk / n) built from jk mod n: complex
matrix products in complex128, TF32 off, no FFT algorithm and nothing of
the program.  Every image of a kept call is checked, one at a time: of
two images drawn from the seed and the call's index, the same on every
rank, every row the rank holds; of each other image, rows drawn from the
seed, the call's index, the image and the rank.

The control, in the program's place, is the same products in complex64
with TF32 operands: each rank's row DFT of its block, the blocks
gathered over the ranks (``torch.distributed.all_gather``) a few images
at a time, its rows of the column DFT; each float32 operand rounded to
TF32's 10-bit mantissa (to nearest, ties away, as the tensor cores'
conversion does) and the products summed in float32.
"""
from __future__ import annotations

import contextlib
import functools
import math
import random

import torch
import torch.distributed as dist

from portbench import seeded
from portbench.compare import MaxRel

CHECKED = 2                    # images whose every row is checked
ROWS = 8                       # rows checked of each other image, a rank
GATHER = 8                     # images a gather in the control


@functools.lru_cache(maxsize=4)
def dft(n: int, dtype, device):
    j = torch.arange(n, dtype=torch.int64, device=device)
    ang = (-2 * math.pi / n) * ((j[:, None] * j[None, :]) % n).double()
    return torch.polar(torch.ones_like(ang), ang).to(dtype)


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def image(seed: int, slot: int, b: int, ranks: int, rows: int, n1: int,
          device) -> torch.Tensor:
    """Image b of ring slot ``slot``, whole, as complex128 (n0, n1)."""
    x = torch.cat([seeded.normal((2, rows, n1), device, seed, slot, b, r)
                   for r in range(ranks)], dim=1).double()
    return torch.complex(x[0], x[1])


def spectrum_rows(x, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` (indices) of the FFTPACK-scaled 2-D DFT of x (n0, n1)."""
    n0, n1 = x.shape
    with _no_tf32():
        return (dft(n0, x.dtype, x.device)[rows] @ x
                @ dft(n1, x.dtype, x.device)) / (n0 * n1)


def checked(seed: int, index: int, images: int) -> list[int]:
    """The images of call ``index`` whose every row is checked."""
    return random.Random(f"{seed}:{index}").sample(range(images),
                                                   min(CHECKED, images))


def checked_rows(seed: int, index: int, b: int, rank: int,
                 rows: int) -> list[int]:
    """The rows (of the rank's) checked of an image not in ``checked``."""
    return sorted(random.Random(f"{seed}:{index}:{b}:{rank}").sample(
        range(rows), min(ROWS, rows)))


def compare(sizes, traffic, inputs, calls):
    """This rank's check of each kept call ({index: (slot, outputs)}):
    the program's rows of every image against the complex128 reference,
    every row of the ``checked`` images and ``checked_rows`` of the
    others."""
    acc = MaxRel()
    seed, rank, d = inputs["seed"], inputs["rank"], inputs["ranks"]
    for index, (slot, (yr, yi)) in calls.items():
        shape = inputs["xr"][slot].shape
        if yr.shape != shape or yi.shape != shape:
            return {"spectrum_err": math.inf}
        images, rows, n1 = shape
        whole = set(checked(seed, index, images))
        for b in range(images):
            mine = (list(range(rows)) if b in whole
                    else checked_rows(seed, index, b, rank, rows))
            at = torch.tensor(mine, device=yr.device)
            want = spectrum_rows(image(seed, slot, b, d, rows, n1, yr.device),
                                 at + rank * rows)
            acc.add(torch.complex(yr[b, at].double(), yi[b, at].double()),
                    want)
    return {"spectrum_err": acc.value()}


def _tf32(x):
    """x (float32) with its mantissa rounded to TF32's 10 bits."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _cmm(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) from TF32 operands, summed in float32."""
    ar, ai, br, bi = map(_tf32, (ar, ai, br, bi))
    with _no_tf32():
        return ar @ br - ai @ bi, ar @ bi + ai @ br


def control(sizes, traffic):
    """The reference in complex64 with TF32 products, in the program's
    place: a call of the same form as the program's."""
    def call(inputs, slot):
        xr, xi = inputs["xr"][slot], inputs["xi"][slot]
        images, rows, n1 = xr.shape
        d, rank = inputs["ranks"], inputs["rank"]
        n0 = rows * d
        f1 = dft(n1, torch.complex64, xr.device)
        f0 = dft(n0, torch.complex64, xr.device)[rank * rows:
                                                 (rank + 1) * rows]
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        for b0 in range(0, images, GATHER):
            blk = slice(b0, min(b0 + GATHER, images))
            zr, zi = _cmm(xr[blk], xi[blk], f1.real, f1.imag)
            z = torch.stack([zr, zi])
            parts = [torch.empty_like(z) for _ in range(d)]
            dist.all_gather(parts, z)
            z = torch.cat(parts, dim=2)          # (2, images, n0, n1)
            cr, ci = _cmm(f0.real, f0.imag, z[0], z[1])
            yr[blk], yi[blk] = cr / (n0 * n1), ci / (n0 * n1)
        return yr, yi
    return call
