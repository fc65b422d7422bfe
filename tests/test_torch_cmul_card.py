"""The step's filter map (``ops.cmul``, ``csrc/cmul.cu``) on the card
(``-m cuda``).

The forward and the adjoint against their plain versions on the same card
inputs, at book's shape (65536, 481) in float32, at (1001, 17) in float64
and at (19, 12289) in float32: the planes within 1e-6 of max |t|, the
filter's gradient within 1e-5 of its max; every ``needs`` subset of the
Function's backward against the plain adjoint; two adjoint runs give the
same filter gradient bit for bit; the launch raises on CUDA inputs it
does not take; and the step launches one cmul a book call and two more a
greeks call.
This file imports no JAX.
"""
import itertools

import pytest
import torch

from cfftpack_tpu_torch.entry import entry
from cfftpack_tpu_torch.ops import cmul
from cfftpack_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# book's shape; float64 with rows not a multiple of the 2-row groups; a
# filter past the forward's 48 KB of shared memory (read through the
# cache), with rows not a multiple of the 4-row groups
SHAPES = [((65536, 481), torch.float32), ((1001, 17), torch.float64),
          ((19, 12289), torch.float32)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _inputs(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(s):
        return torch.randn(s, generator=g, device="cuda", dtype=dtype)
    return r(shape), r(shape), r(shape[-1:]), r(shape[-1:])


@pytest.mark.parametrize("shape, dtype", SHAPES)
def test_kernels_match_plain_on_card(shape, dtype):
    _card()
    sr, si, fr, fi = _inputs(shape, dtype, 1)
    gr, gi, _, _ = _inputs(shape, dtype, 2)
    for conj in (False, True):
        got = cmul._launch(sr, si, fr, fi, conj)
        want = cmul.cmul_plain(sr, si, fr, fi, conj)
        assert max(_rel(a, b) for a, b in zip(got, want)) < 1e-6, conj
        for planes in (True, False):
            got = cmul._adj_launch(gr, gi, sr, si, fr, fi, conj, planes)
            want = cmul.adjoint_plain(gr, gi, sr, si, fr, fi, conj, planes)
            if planes:
                assert max(_rel(a, b) for a, b in zip(got[:2], want[:2])
                           ) < 1e-6, (conj, planes)
            else:
                assert got[:2] == (None, None)
            assert max(_rel(a, b) for a, b in zip(got[2:], want[2:])
                       ) < 1e-5, (conj, planes)


@pytest.mark.parametrize("shape, dtype", SHAPES)
def test_adjoint_is_the_same_bit_for_bit(shape, dtype):
    _card()
    sr, si, fr, fi = _inputs(shape, dtype, 3)
    gr, gi, _, _ = _inputs(shape, dtype, 4)
    a = cmul._adj_launch(gr, gi, sr, si, fr, fi, False, True)
    b = cmul._adj_launch(gr, gi, sr, si, fr, fi, False, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_every_needs_subset_on_card():
    """The Function's backward on the card for each subset of inputs that
    require grad: what the plain adjoint gives."""
    _card()
    sr, si, fr, fi = _inputs((300, 481), torch.float32, 5)
    gr, gi, _, _ = _inputs((300, 481), torch.float32, 6)
    want = cmul.adjoint_plain(gr, gi, sr, si, fr, fi, False, True)
    for needs in itertools.product((False, True), repeat=4):
        if not any(needs):
            continue
        xs = [t.clone().requires_grad_(n)
              for t, n in zip((sr, si, fr, fi), needs)]
        out = cmul.spectral_mul(*xs)
        grads = torch.autograd.grad(out, [x for x, n in zip(xs, needs) if n],
                                    (gr, gi))
        for g, w in zip(grads, [w for w, n in zip(want, needs) if n]):
            assert _rel(g, w) < (1e-6 if g.ndim == 2 else 1e-5), needs


def test_launch_refuses_what_it_does_not_take():
    _card()
    sr, si, fr, fi = _inputs((8, 481), torch.float32, 7)
    bad = {
        "dtype": (sr.half(), si.half(), fr.half(), fi.half()),
        "mixed dtype": (sr, si, fr.double(), fi.double()),
        "strided": (sr[:, :240], si[:, :240], fr[:240], fi[:240]),
        "offset": (sr.reshape(-1)[1:1 + 7 * 481].view(7, 481),
                   si[1:], fr, fi),
        "per-row filter": (sr, si, sr, si),
        "host filter": (sr, si, fr.cpu(), fi.cpu())}
    for name, args in bad.items():
        with pytest.raises((TypeError, ValueError)):
            cmul._launch(*args)
        assert not cmul.cmul_eligible(*args), name


def test_step_counts_on_card():
    """A book call of the step launches K1 twice and cmul once; a greeks
    call (the step and its gradient in v, phi_r, phi_i) K1 four times and
    cmul twice (the forward, and the adjoint's one call)."""
    _card()
    step, args = entry("cuda", batch=64)
    v, phr, phi = (t.clone().requires_grad_(True) for t in args)
    cot = torch.randn_like(v)
    step(*args)
    torch.autograd.grad(step(v, phr, phi), (v, phr, phi), cot)
    profiling.reset()
    step(*args)
    assert {k: n for k, n in profiling.launches.items() if n} == {
        "K1": 2, "cmul": 1}
    profiling.reset()
    torch.autograd.grad(step(v, phr, phi), (v, phr, phi), cot)
    torch.cuda.synchronize()
    assert {k: n for k, n in profiling.launches.items() if n} == {
        "K1": 4, "cmul": 2}
