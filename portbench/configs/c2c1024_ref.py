"""Plain reference of c2c1024: the complex round trip as dense DFTs.

spectrum = x @ W / n (FFTPACK's forward scaling), reconstruction =
spectrum @ conj(W) (the unscaled inverse), with W[j, k] = exp(-2 pi i
jk / n) built from jk mod n: complex matrix products in complex128, no
FFT algorithm and nothing of the program.  The control is the same code
in complex64 (float32), TF32 off.
"""
from __future__ import annotations

import functools
import math

import torch

from portbench.compare import MaxRel

ROWS = 4096                    # rows a block


@functools.lru_cache(maxsize=4)
def dft(n: int, dtype, device):
    j = torch.arange(n, dtype=torch.int64, device=device)
    ang = (-2 * math.pi / n) * ((j[:, None] * j[None, :]) % n).double()
    return torch.polar(torch.ones_like(ang), ang).to(dtype)


def round_trip(x, W):
    n = W.shape[0]
    spec = (x @ W) / n
    return spec, spec @ W.conj()


def _blocks(sizes, inputs, slot, dtype):
    x = inputs["x"][slot]
    W = dft(sizes["n"], dtype, x.device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for r0 in range(0, x.shape[0], ROWS):
            rows = slice(r0, min(r0 + ROWS, x.shape[0]))
            yield rows, round_trip(x[rows].to(dtype), W)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def compare(sizes, traffic, inputs, calls):
    """The spectrum's and the reconstruction's checks over the calls
    ({index: (slot, outputs)}) against the complex128 reference."""
    names = ("spectrum_err", "recon_err")
    acc = {k: MaxRel() for k in names}
    for slot, outs in calls.values():
        for rows, want in _blocks(sizes, inputs, slot, torch.complex128):
            for k, w, got in zip(names, want, outs):
                acc[k].add(got[rows], w)
    return {k: a.value() for k, a in acc.items()}


def control(sizes, traffic):
    """The reference in complex64 in the program's place."""
    def call(inputs, slot):
        parts = [w for _, w in _blocks(sizes, inputs, slot,
                                       torch.complex64)]
        return tuple(torch.cat(c).to(torch.complex128) for c in zip(*parts))
    return call
