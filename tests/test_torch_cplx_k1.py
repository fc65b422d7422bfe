"""K1's interleaved complex mode: ``fft``/``ifft`` at K1's register lengths.

``ops/core.py:complex_pass`` sends a complex64 or complex128 tensor whose
transform axis is the last, at a length of ``plan.REG_LENGTHS`` of
its real dtype, through ``fused_fft.cfft_interleaved``: on the card one
launch of the C entry ``k1_cplx_f32``/``f64`` on the (re, im) pairs as the
tensor holds them, on the CPU K1's plain version on the ``view_as_real``
planes.  Every other input keeps the split pass over the planes.

* On the CPU: both directions at every register length in both dtypes
  under three norms against numpy and the JAX package; views (conjugate
  and negative bits, transposed and strided rows, storage offsets, 0 and
  1 rows, leading axes, axis 0) against numpy with the input untouched;
  gradients against ``torch.fft``'s autograd and ``gradcheck``;
  ``profiling.complex_maps`` by route; and, with the C entry a recorder,
  one K1 call a transform on the rows as they lie, a copy under
  ``cfftpack.pack`` only for rows that need one.

The card's checks are in ``test_torch_cplx_k1_card.py`` (no JAX there),
which also holds the cases and views both files use.
"""
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import cfftpack_tpu as jt
import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.config import fwd_scale, inv_scale
from cfftpack_tpu_torch.ops import _build, fused_fft
from cfftpack_tpu_torch.utils import profiling

from test_torch_cplx_k1_card import (CASES, DTYPES, NORMS, VIEWS, _port,
                                     _view, _want)
from torch_parity import bar, complex_input, rel_err

torch.set_num_threads(1)


@pytest.fixture
def maps(monkeypatch):
    """``profiling.complex_maps`` fresh for the test."""
    fresh = {"interleaved": 0, "planes": 0}
    monkeypatch.setattr(profiling, "complex_maps", fresh)
    return fresh


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("dt, n", CASES)
def test_route_matches_numpy_and_jax(dt, n, norm, maps):
    x = complex_input((3, n), dt, seed=n)
    xt = torch.from_numpy(x)
    for inverse in (False, True):
        got = _port(inverse)(xt, norm=norm)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        assert got.is_contiguous()
        jfn = jt.ifft if inverse else jt.fft
        assert rel_err(got, _want(x, inverse, norm)) < bar(dt), inverse
        assert rel_err(got, np.asarray(jfn(x, norm=norm))) < bar(dt), inverse
    assert maps == {"interleaved": 2, "planes": 0}


@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_views_match_numpy(dt, kind, maps):
    """Each kind of input gives numpy's answer through the route its
    layout takes, and is left as it was."""
    n = 960 if dt is np.complex64 else 480
    v, want_in, axis, route = _view(kind, dt, n)
    before = v.resolve_conj().resolve_neg().clone()
    for inverse in (False, True):
        got = _port(inverse)(v, axis=axis)
        assert got.shape == v.shape and got.dtype == v.dtype
        if v.numel():
            assert rel_err(got, _want(want_in, inverse, "fftpack",
                                      axis)) < bar(dt), inverse
    assert torch.equal(v.resolve_conj().resolve_neg(), before)
    assert maps[route] == 2 and sum(maps.values()) == 2


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_grad_matches_torch_fft(dt, norm, inverse, maps, monkeypatch):
    """The gradient of a real loss through the route is ``torch.fft``'s
    (autograd through PyTorch's own transform at the same scale), with
    the backward one map of the route itself, the other direction at the
    same scale."""
    seen = []
    route = fused_fft.cfft_interleaved

    def spy(x, n, inv, scale=1.0):
        seen.append((inv, scale))
        return route(x, n, inv, scale)
    monkeypatch.setattr(fused_fft, "cfft_interleaved", spy)
    n = 512
    tdt = DTYPES[dt]
    x = torch.from_numpy(complex_input((3, n), dt, seed=11))
    cot = torch.from_numpy(complex_input((3, n), dt, seed=12))
    s = inv_scale(norm, n) * n if inverse else fwd_scale(norm, n)
    ref = torch.fft.ifft if inverse else torch.fft.fft

    def grad(fn):
        xg = x.clone().requires_grad_(True)
        loss = (fn(xg) * cot).real.sum() + fn(xg).abs().square().sum()
        return torch.autograd.grad(loss, xg)[0]
    got = grad(lambda a: _port(inverse)(a, norm=norm))
    want = grad(lambda a: ref(a) * s)
    assert got.dtype == tdt
    assert rel_err(got, want) < bar(dt)
    # two calls of the forward, each entered once with grad and once
    # without, then each one's adjoint
    assert maps == {"interleaved": 2, "planes": 0}
    sc = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    assert seen == [(inverse, sc)] * 4 + [(not inverse, sc)] * 2, seen


@pytest.mark.parametrize("fn", ["fft", "ifft"])
def test_gradcheck_complex128(fn):
    x = torch.from_numpy(complex_input((2, 480), np.complex128, seed=21))
    f = getattr(pt, fn)
    assert torch.autograd.gradcheck(
        lambda a: f(a, norm="ortho"), (x.requires_grad_(True),),
        eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("case", [
    "k1_c64", "k1_c128", "real_input", "c128_at_8192", "length_2p20",
    "axis_m2", "bluestein", "stage_loop_length", "fft2"])
def test_complex_maps_count_routes(case, maps):
    """``profiling.complex_maps`` counts each ``fft``/``ifft`` call by the
    route it took: interleaved for a contiguous last axis at a register
    length of its dtype, planes for every other input."""
    c64, c128 = np.complex64, np.complex128
    if case == "k1_c64":
        x, kw, want = complex_input((2, 8192), c64, 1), {}, "interleaved"
    elif case == "k1_c128":
        x, kw, want = complex_input((2, 1024), c128, 1), {}, "interleaved"
    elif case == "real_input":            # float64 rows become complex128
        x = np.random.default_rng(1).standard_normal((2, 1024))
        kw, want = {}, "interleaved"
    elif case == "c128_at_8192":          # 8192 is a float32 length only
        x, kw, want = complex_input((1, 8192), c128, 1), {}, "planes"
    elif case == "length_2p20":           # K5's length
        x, kw, want = complex_input((1, 1 << 20), c64, 1), {}, "planes"
    elif case == "axis_m2":
        x, kw, want = complex_input((1024, 3), c64, 1), {"axis": -2}, "planes"
    elif case == "bluestein":
        x, kw, want = complex_input((2, 1021), c128, 1), {}, "planes"
    elif case == "stage_loop_length":     # K1, but not a register length
        x, kw, want = complex_input((2, 1000), c128, 1), {}, "planes"
    else:                                 # fft2: one pass of each route
        x = complex_input((480, 480), c128, 1)
        got = pt.ifft2(pt.fft2(torch.from_numpy(x)))
        assert rel_err(got, x) < 1e-12
        assert maps == {"interleaved": 2, "planes": 2}
        return
    xt = torch.from_numpy(x)
    y = pt.fft(xt, **kw)
    axis = kw.get("axis", -1)
    assert rel_err(y, _want(x, False, "fftpack", axis)) < bar(y.numpy().dtype)
    assert rel_err(pt.ifft(y, **kw), x) < bar(y.numpy().dtype)
    assert maps[want] == 2 and sum(maps.values()) == 2
    counts = profiling.counts()
    assert counts["complex." + want] == 2


@pytest.fixture
def cplx_entry(monkeypatch):
    """The interleaved mode's C entry as a recorder on CPU tensors: the
    wrapper runs up to it and ``_build.call`` counts as on the card."""
    calls = []

    def record(*args):
        calls.append(args)
        return record.err

    record.err = 0
    lib = types.SimpleNamespace(k1_cplx_f32=record, k1_cplx_f64=record)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "_enter",
                        lambda fn, dev, args: fn(*args, None))
    monkeypatch.setattr(fused_fft, "_cplx_check", lambda *a: None)
    monkeypatch.setattr(plan, "_LAUNCH_PLANS", {})
    monkeypatch.setattr(profiling, "launches",
                        dict.fromkeys(profiling.KERNELS, 0))
    return record, calls


def _launch_rows(v, n: int, inverse: bool = False, scale: float = 1.0):
    """What ``cfft_interleaved`` hands the launch on the card."""
    return fused_fft._cplx_launch(fused_fft._cplx_rows(v, n), n, inverse,
                                  scale)


@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
def test_launch_passes_rows_as_they_lie(cplx_entry, dt):
    """A contiguous input goes to the C entry at its own address, one K1
    call a transform with the register schedule, the direction and the
    scale; no rows make no call; an error code raises."""
    record, calls = cplx_entry
    n = 1024
    x = torch.randn(5, n, dtype=dt)[1:]            # a storage offset
    y = _launch_rows(x, n, True, 0.25)
    assert y.shape == x.shape and y.dtype == dt
    (c,) = calls
    assert c[0] == x.data_ptr() and c[1] == y.data_ptr()
    assert c[3:5] == (4, n)                        # B, n
    assert c[-5:-1] == (1, 1, 64, 0.25)            # inverse, tb, threads
    assert c[-1] is None and profiling.launches["K1"] == 1
    lp = fused_fft.cplx_plan(n, dt, x.device)
    assert lp.passes == fused_fft.plan.reg_passes(n)
    _launch_rows(x[:0], n)
    assert len(calls) == 1
    record.err = 9
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _launch_rows(x, n)
    assert profiling.launches["K1"] == 1


def test_launch_copies_only_rows_that_need_it(cplx_entry):
    """Conjugate and negative bits and strided rows are copied once under
    ``cfftpack.pack`` before the one K1 call; a contiguous input opens no
    pack span."""
    record, calls = cplx_entry
    n = 480
    base = torch.randn(4, 2 * n, dtype=torch.complex128)
    x = base[:, :n].contiguous()
    _launch_rows(x, n)                             # plan built
    for v, copied in ((x, False), (x.conj(), True), (torch._neg_view(x), True),
                      (base[:, ::2], True), (x[1:], False)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("test.launch"):
                _launch_rows(v, n)
        names = [e.name for e in prof.events()
                 if e.name.startswith("cfftpack.")]
        assert names == (["cfftpack.pack"] if copied else []) + [
            "cfftpack.K1"], (names, copied)
        assert (calls[-1][0] != v.data_ptr()) == copied
    assert profiling.launches["K1"] == 6


def test_route_opens_no_leaf_span_on_a_contiguous_input():
    """On the CPU the route runs the plain version; for a contiguous
    input it opens no pack or unpack span, where the planes' route at a
    stage-loop length opens its unpack."""
    x = torch.randn(2, 1024, dtype=torch.complex128)
    z = torch.randn(2, 1000, dtype=torch.complex128)
    for v in (x, z):
        pt.ifft(pt.fft(v))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.ifft(pt.fft(x))
    assert not [e.name for e in prof.events()
                if e.name in ("cfftpack.pack", "cfftpack.unpack")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.ifft(pt.fft(z))
    assert [e.name for e in prof.events()
            if e.name == "cfftpack.unpack"] == ["cfftpack.unpack"] * 2
