"""Plain reference of conv960: the pricer's step as dense DFT matrices.

out = c2r(rfft(v) * phi): a forward real DFT with FFTPACK's 1/n, the
complex multiply by the filter, and the unscaled inverse, each a matrix
product in float64 (no FFT algorithm, nothing of the program).  The
inverse reads a packed spectrum of n//2 + 1 bins as the JAX package's
c2r does, the imaginary parts of bin 0 and bin n/2 included, as an
alternating and a constant term: the forward of this cell never makes
them (its filter is real at both bins), but the filter's gradient is
taken there too.  Gradients are autograd's through these products.

The control is the same code in float32 with its matrix products in
TF32, forward and backward: each operand rounded to TF32's 10-bit
mantissa (to nearest, ties away, as the tensor cores' conversion does)
and the products summed in float32, on the card and on the CPU alike.
"""
from __future__ import annotations

import functools
import math

import torch

from portbench.compare import MaxRel

ROWS = 8192                    # rows a block


@functools.lru_cache(maxsize=4)
def tables(n: int, dtype, device):
    """(fr, fi, ir, ii): Y = v @ (fr + i fi) with the 1/n of the forward;
    out = Tr @ ir + Ti @ ii, the unscaled inverse of a packed spectrum."""
    h = n // 2
    m = torch.arange(n, dtype=torch.int64, device=device)
    k = torch.arange(h + 1, dtype=torch.int64, device=device)
    ang = (2 * math.pi / n) * ((k[:, None] * m[None, :]) % n).double()
    c, s = torch.cos(ang), torch.sin(ang)
    w = torch.full((h + 1, 1), 2.0, dtype=torch.float64, device=device)
    w[0] = 1.0
    if n % 2 == 0:
        w[h] = 1.0
    ir, ii = w * c, -w * s
    ii[0] = -torch.where(m % 2 == 0, 1.0, -1.0).double()
    if n % 2 == 0:
        ii[h] = -1.0
    return tuple(t.to(dtype).contiguous()
                 for t in (c.T / n, -s.T / n, ir, ii))


def _tf32(x):
    """x (float32) with its mantissa rounded to TF32's 10 bits."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


class _TF32MM(torch.autograd.Function):
    """a @ b with TF32 operands, its backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _tf32(a), _tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ b.T, a.T @ g


def _mm(a, b, tf32: bool):
    return _TF32MM.apply(a, b) if tf32 else a @ b


def step(v, phr, phi, tabs, tf32: bool = False):
    fr, fi, ir, ii = tabs
    yr, yi = _mm(v, fr, tf32), _mm(v, fi, tf32)
    tr = yr * phr - yi * phi
    ti = yr * phi + yi * phr
    return _mm(tr, ir, tf32) + _mm(ti, ii, tf32)


def _blocks(sizes, traffic, inputs, slot, dtype, tf32):
    """Yield (rows, outputs of those rows, the filter's gradient part)
    of one call, in blocks of ROWS."""
    v = inputs["v"][slot].detach()
    grad = traffic["call"] == "grad"
    tabs = tables(sizes["n"], dtype, v.device)
    phr = inputs["phr"].detach().to(dtype).requires_grad_(grad)
    phi = inputs["phi"].detach().to(dtype).requires_grad_(grad)
    for r0 in range(0, v.shape[0], ROWS):
        rows = slice(r0, min(r0 + ROWS, v.shape[0]))
        vb = v[rows].to(dtype).requires_grad_(grad)
        with torch.enable_grad():
            out = step(vb, phr, phi, tabs, tf32)
            if not grad:
                yield rows, (out.detach(),), ()
                continue
            cot = inputs["cot"][rows].to(dtype)
            gv, gr, gi = torch.autograd.grad(out, (vb, phr, phi), cot)
        yield rows, (out.detach(), gv), (gr, gi)


def compare(sizes, traffic, inputs, calls):
    """The checks of this config: the program's outputs of ``calls``
    ({index: (slot, outputs)}) against the float64 reference."""
    grad = traffic["call"] == "grad"
    names = ["out_err"] + (["grad_v_err", "grad_phr_err", "grad_phi_err"]
                           if grad else [])
    acc = {k: MaxRel() for k in names}
    for slot, outs in calls.values():
        parts = [0.0, 0.0]
        for rows, ref, red in _blocks(sizes, traffic, inputs, slot,
                                      torch.float64, False):
            for k, want, got in zip(names, ref, outs):
                acc[k].add(got[rows].double(), want)
            parts = [p + r for p, r in zip(parts, red)]
        if grad:
            acc["grad_phr_err"].add(outs[2].double(), parts[0])
            acc["grad_phi_err"].add(outs[3].double(), parts[1])
    return {k: a.value() for k, a in acc.items()}


def control(sizes, traffic):
    """The reference in the precision below the config's, in the
    program's place: a call of the same form as the program's."""
    def call(inputs, slot):
        outs, parts = [], [0.0, 0.0]
        for _, ref, red in _blocks(sizes, traffic, inputs, slot,
                                   torch.float32, True):
            outs.append(ref)
            parts = [p + r for p, r in zip(parts, red)]
        cat = tuple(torch.cat(c) for c in zip(*outs))
        return cat + (tuple(parts) if traffic["call"] == "grad" else ())
    return call
