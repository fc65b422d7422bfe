"""Plain reference of c2c1m: the complex round trip at n = 2^20 through
one index map of dense DFTs.

A dense DFT matrix of 2^20 points would hold 2^40 entries, so this
reference departs from "no FFT algorithm" by one step, the index map
n = n1 * n2 with n1 the largest divisor of n not above sqrt(n) (1024 x
1024 at 2^20), j = n2*j1 + j2 and k = k1 + n1*k2:

    X[k1 + n1*k2] = sum_j2 W_n2^(j2 k2) W_n^(j2 k1)
                    sum_j1 W_n1^(j1 k1) x[n2*j1 + j2]

a dense n1-point DFT over j1 (a matrix product), the twiddle W_n^(j2 k1),
a dense n2-point DFT over j2 (a matrix product), read out with k2 the
slow index.  Each table is built from the exponent's product mod its
length, W_m^(ab) = exp(-2 pi i (ab mod m) / m), in complex128.  The
program splits 2^20 otherwise (K5: 2 x 4096 x 128), and nothing of it is
used here.  spectrum = X / n (FFTPACK's forward scaling), reconstruction
= the same map on the spectrum with the conjugate tables, unscaled.  Rows
go through in blocks, so that the reference fits beside the run.

The control is the same map in complex64 with TF32 matrix products: each
product's operands rounded to TF32's 10-bit mantissa (to nearest, ties
away, as the tensor cores' conversion does) and summed in float32, one
precision below the configuration's float32.  TF32 is off in PyTorch
while either runs, so that no product is rounded unasked.
"""
from __future__ import annotations

import functools
import math

import torch

from portbench.compare import MaxRel

ROWS = 8                       # rows a block: 128 MiB of complex128


def factors(n: int) -> tuple[int, int]:
    """(n1, n2): n1 the largest divisor of n not above sqrt(n)."""
    n1 = max(d for d in range(1, math.isqrt(n) + 1) if n % d == 0)
    return n1, n // n1


def _table(a, b, m: int, sign: float, dtype):
    ang = (sign * 2 * math.pi / m) * ((a[:, None] * b[None, :]) % m).double()
    return torch.polar(torch.ones_like(ang), ang).to(dtype)


@functools.lru_cache(maxsize=8)
def tables(n: int, inverse: bool, dtype, device):
    """(D1, T, D2): the n1- and n2-point DFT matrices and the (n1, n2)
    twiddle W_n^(k1 j2), conjugate for the inverse."""
    n1, n2 = factors(n)
    sign = 1.0 if inverse else -1.0
    i1 = torch.arange(n1, dtype=torch.int64, device=device)
    i2 = torch.arange(n2, dtype=torch.int64, device=device)
    return (_table(i1, i1, n1, sign, dtype), _table(i1, i2, n, sign, dtype),
            _table(i2, i2, n2, sign, dtype))


def _tf32(z):
    """z (complex64) with each part's mantissa rounded to TF32's 10 bits."""
    b = torch.view_as_real(z.resolve_conj().contiguous()).view(torch.int32)
    return torch.view_as_complex(((b + 0x1000) & -0x2000).view(torch.float32))


def _mm(a, b, tf32: bool):
    return _tf32(a) @ _tf32(b) if tf32 else a @ b


def transform(x, inverse: bool = False, tf32: bool = False):
    """The unscaled DFT (inverse: with the conjugate tables) over the last
    axis of (rows, n) ``x``, in ``x``'s dtype."""
    r, n = x.shape
    n1, n2 = factors(n)
    D1, T, D2 = tables(n, inverse, x.dtype, x.device)
    a = _mm(D1, x.reshape(r, n1, n2), tf32) * T      # [k1, j2]
    return _mm(a, D2, tf32).transpose(1, 2).reshape(r, n)   # [k2, k1]


def round_trip(x, tf32: bool = False):
    spec = transform(x, False, tf32) / x.shape[-1]
    return spec, transform(spec, True, tf32)


def _blocks(inputs, slot, dtype, tf32: bool):
    x = inputs["x"][slot]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for r0 in range(0, x.shape[0], ROWS):
            rows = slice(r0, min(r0 + ROWS, x.shape[0]))
            yield rows, round_trip(x[rows].to(dtype), tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def compare(sizes, traffic, inputs, calls):
    """The spectrum's and the reconstruction's checks over the calls
    ({index: (slot, outputs)}) against the complex128 reference."""
    names = ("spectrum_err", "recon_err")
    acc = {k: MaxRel() for k in names}
    for slot, outs in calls.values():
        for rows, want in _blocks(inputs, slot, torch.complex128, False):
            for k, w, got in zip(names, want, outs):
                acc[k].add(got[rows], w)
    return {k: a.value() for k, a in acc.items()}


def control(sizes, traffic):
    """The map in complex64 with TF32 products in the program's place."""
    def call(inputs, slot):
        parts = [w for _, w in _blocks(inputs, slot, torch.complex64, True)]
        return tuple(torch.cat(c) for c in zip(*parts))
    return call
