"""The port's spans and launch registry (``cfftpack_tpu_torch.utils.profiling``).

* Under ``torch.profiler`` the flagship step, ``fft``/``ifft`` and
  ``torch.autograd.grad`` through the step record the program's spans
  (``cfftpack.step``, the API spans, the leaf steps, ``cfftpack.adjoint``),
  each inside the span that encloses it on its thread.  On the CPU the
  plain versions run, so no ``cfftpack.K*`` or ``cfftpack.pack`` span;
  the glue's leaf spans where a real transform's half length runs K1's
  stage loop, the DCT/DST glue's (``ops/dct.py``) at the benchmark's
  suite lengths, and the complex join where a length takes the planes.
* With no profiler no ``record_function`` is made.
* The registry counts K1's launches as the wrapper's own counter did: one
  a successful C call, none for a CPU tensor, an empty batch or an error,
  with the C entry a recorder (no card here).
* A cache miss builds under ``cfftpack.plan`` once; a second call of the
  same shape records no such span.
* The real route's maps are counted by direction (``real_maps``), and a
  real mode's launch counts and spans as K1.
* On the card (``-m cuda``): the K1 spans with no glue span around the
  step's real modes, and the adjoint's span on autograd's device thread
  inside ``torch.autograd.grad``, each with its K1 span inside.
"""
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.entry import entry
from cfftpack_tpu_torch.ops import _build, fused_fft
from cfftpack_tpu_torch.utils import profiling


def _spans(prof, prefix=("cfftpack.", "test.")):
    """[(name, parent, thread, start, end)] of the profiled host spans
    whose names start with ``prefix`` (on the card a span has a copy on
    the device's timeline too); ``parent`` is the name of the innermost
    such span around it on its thread, or None."""
    evs = [(e.name, e.thread, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(prefix)
           and e.device_type == torch.autograd.DeviceType.CPU]
    out = []
    for name, tid, a, b in evs:
        around = [(b2 - a2, n2) for n2, t2, a2, b2 in evs
                  if t2 == tid and a2 <= a and b <= b2
                  and (a2, b2) != (a, b)]
        out.append((name, min(around)[1] if around else None, tid, a, b))
    return out


def _pairs(spans) -> set:
    return {(name, parent) for name, parent, *_ in spans}


def _step_inputs(batch=4, grad=False):
    step, (v, phr, phi) = entry("cpu", batch=batch)
    if grad:
        v, phr, phi = (t.clone().requires_grad_(True) for t in (v, phr, phi))
    return step, v, phr, phi


def test_step_spans_nest_as_stated():
    step, v, phr, phi = _step_inputs()
    step(v, phr, phi)                                  # plans built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(v, phr, phi)
    got = _pairs(_spans(prof))
    # at 960 both transforms are K1's real modes, whose plain versions
    # (like K1's) open no leaf span
    assert got == {("cfftpack.step", None),
                   ("cfftpack.rfft_split", "cfftpack.step"),
                   ("cfftpack.filter", "cfftpack.step"),
                   ("cfftpack.irfft_split", "cfftpack.step")}, got


def test_glue_route_spans_nest_as_stated():
    """An even n whose half K1 runs on the stage loop (192) keeps the real
    transforms' glue: the merge and scale of the forward, the unmerge and
    interleave of the inverse, each in its leaf span."""
    x = torch.randn(4, 192)
    yr, yi = pt.rfft_split(x)
    pt.irfft_split(yr, yi, 192)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.irfft_split(*pt.rfft_split(x), 192)
    assert _pairs(_spans(prof)) == {
        ("cfftpack.rfft_split", None),
        ("cfftpack.merge", "cfftpack.rfft_split"),
        ("cfftpack.scale", "cfftpack.rfft_split"),
        ("cfftpack.irfft_split", None),
        ("cfftpack.merge", "cfftpack.irfft_split"),
        ("cfftpack.unpack", "cfftpack.irfft_split")}


_SUITE = {
    "rfft": ("rfft_split", "irfft_split",
             lambda x: pt.rfft_split(x, norm="fftpack"),
             lambda y, n: pt.irfft_split(*y, n, norm="fftpack")),
    "dct2": ("dct", "idct", lambda x: pt.dct(x, 2, norm="fftpack"),
             lambda y, n: pt.idct(y, 2, norm="fftpack")),
    "dst2": ("dst", "idst", lambda x: pt.dst(x, 2, norm="fftpack"),
             lambda y, n: pt.idst(y, 2, norm="fftpack")),
    "dct4": ("dct", "idct", lambda x: pt.dct(x, 4, norm="fftpack"),
             lambda y, n: pt.idct(y, 4, norm="fftpack")),
}


@pytest.mark.parametrize("family", sorted(_SUITE))
@pytest.mark.parametrize("n", [960, 1000, 1250])
def test_dct_suite_spans_nest_as_stated(n, family):
    """The round trips of the DCT/DST suite (the benchmark's ``dctsuite``)
    open their glue's leaf spans under their API spans, none inside
    another: each DCT/DST forward its gathers (pack), table multiplies
    (merge), riffle (unpack) and the norm's multiply (scale), the inverse
    the same but the scale (FFTPACK's inverse is unscaled), at n % 4 = 0
    (960, 1000) and 2 (1250) alike; the real round trip the stage-loop
    route's merge, scale, unmerge and interleave where the half length is
    not a register length (1000, 1250), and none at 960, whose real modes
    (their plain version here) open none."""
    fwd_name, inv_name, fwd, inv = _SUITE[family]
    x = torch.randn(4, n)
    inv(fwd(x), n)                                      # tables built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inv(fwd(x), n)
    f, i = "cfftpack." + fwd_name, "cfftpack." + inv_name
    if family != "rfft":
        leaves = {(f, ("pack", "merge", "unpack", "scale")),
                  (i, ("pack", "merge", "unpack"))}
    elif n == 960:
        leaves = set()
    else:
        leaves = {(f, ("merge", "scale")), (i, ("merge", "unpack"))}
    assert _pairs(_spans(prof)) == {(f, None), (i, None)} | {
        ("cfftpack." + leaf, api) for api, names in leaves
        for leaf in names}


def test_fft_ifft_spans_nest_as_stated():
    """At a register length K1's interleaved mode (its plain version here)
    opens no leaf span; at a stage-loop length the planes' route joins
    its result under ``cfftpack.unpack``."""
    for n, leaves in ((1024, set()), (1000, {
            ("cfftpack.unpack", "cfftpack.fft"),
            ("cfftpack.unpack", "cfftpack.ifft")})):
        x = torch.randn(4, n, dtype=torch.complex128)
        pt.ifft(pt.fft(x))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pt.ifft(pt.fft(x))
        spans = _spans(prof)
        assert _pairs(spans) == {("cfftpack.fft", None),
                                 ("cfftpack.ifft", None)} | leaves, n
        assert [s[0] for s in spans].count("cfftpack.unpack") == len(leaves)


def test_grad_through_the_step_records_the_adjoints():
    step, v, phr, phi = _step_inputs(grad=True)
    cot = torch.randn_like(v)
    torch.autograd.grad(step(v, phr, phi), (v, phr, phi), cot)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(v, phr, phi)
        with record_function("test.grad"):
            torch.autograd.grad(out, (v, phr, phi), cot)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    # one adjoint a map of the forward (the two real maps and the
    # filter's multiply), inside the grad call
    assert names.count("cfftpack.adjoint") == 3
    assert {p for n, p, *_ in spans if n == "cfftpack.adjoint"} == {
        "test.grad"}
    assert not any(n.startswith(("cfftpack.K", "cfftpack.pack",
                                 "cfftpack.merge", "cfftpack.unpack"))
                   for n in names)


def test_no_profiler_makes_no_record_function(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    step, v, phr, phi = _step_inputs(grad=True)
    out = step(v, phr, phi)
    torch.autograd.grad(out, (v, phr, phi), torch.ones_like(out))
    x = torch.randn(2, 64, dtype=torch.complex64)
    pt.ifft(pt.fft(x))
    assert profiling.span("cfftpack.pack") is profiling.span("cfftpack.K1")


@pytest.fixture
def k1_entry(monkeypatch):
    """K1's C entry as a recorder on CPU tensors: the wrapper runs up to
    it and ``_build.call`` counts as on the card; the registry and the
    plan cache are restored after."""
    calls = []

    def record(*args):
        calls.append(args)
        return record.err

    record.err = 0
    lib = types.SimpleNamespace(cfft_stockham_f32=record,
                                cfft_stockham_f64=record,
                                k1_real_f32=record, k1_real_f64=record)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "_enter",
                        lambda fn, dev, args: fn(*args, None))
    monkeypatch.setattr(fused_fft, "_check", lambda *a: None)
    monkeypatch.setattr(fused_fft, "_real_check", lambda *a: None)
    monkeypatch.setattr(plan, "_LAUNCH_PLANS", {})
    monkeypatch.setattr(profiling, "launches",
                        dict.fromkeys(profiling.KERNELS, 0))
    monkeypatch.setattr(profiling, "real_maps", {"r2c": 0, "c2r": 0})
    monkeypatch.setattr(profiling, "complex_maps",
                        {"interleaved": 0, "planes": 0})
    return record, calls


def test_registry_counts_k1_as_its_counter_did(k1_entry):
    record, calls = k1_entry
    x = torch.randn(3, 480)
    fused_fft._launch(x, x, 480, False, 1.0)
    assert profiling.launches["K1"] == 1 and len(calls) == 1
    assert calls[0][-1] is None and calls[0][0] == x.data_ptr()
    fused_fft._launch(x[:0], x[:0], 480, True, 1.0)    # no rows: no call
    fused_fft.sfft_fused(x, x, 480, False)             # CPU: the plain one
    assert profiling.launches["K1"] == 1 and len(calls) == 1
    record.err = 7
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        fused_fft._launch(x, x, 480, False, 1.0)
    assert profiling.launches["K1"] == 1 and len(calls) == 2
    assert {k: v for k, v in profiling.counts().items()
            if k != "plans" and v} == {"K1": 1}


def test_real_modes_count_and_span_as_k1(k1_entry):
    """A real mode's launch is one K1 C call in ``cfftpack.K1``: the r2c
    mode's rows and the c2r mode's planes go in as they lie when
    contiguous, and a strided row is copied under ``cfftpack.pack``
    first."""
    record, calls = k1_entry
    x = torch.randn(3, 960)
    yr, yi = fused_fft._real_launch(x, None, 960, "rfft", 0.5)
    assert yr.shape == yi.shape == (3, 481)
    assert calls[-1][1] == x.data_ptr() and calls[-1][0] == 0
    out = fused_fft._real_launch(yr, yi, 960, "irfft", 1.0)
    assert out.shape == (3, 960) and calls[-1][0] == 1
    assert calls[-1][1:3] == (yr.data_ptr(), yi.data_ptr())
    assert profiling.launches["K1"] == 2
    xs = torch.randn(960, 6)[:, ::2].t()              # strided rows
    fused_fft._real_launch(yr, yi, 960, "rfft_adj", 1.0)   # plan built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.launch"):
            fused_fft._real_launch(xs, None, 960, "rfft", 1.0)
            fused_fft._real_launch(yr, yi, 960, "rfft_adj", 1.0)
    spans = _spans(prof)
    assert [s[0] for s in spans if s[1] == "test.launch"] == [
        "cfftpack.pack", "cfftpack.K1", "cfftpack.K1"]
    assert calls[-2][1] != xs.data_ptr()
    assert profiling.launches["K1"] == 5
    assert profiling.real_maps == {"r2c": 0, "c2r": 0}


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_real_map_counter(device):
    """``profiling.real_maps`` counts the real route's maps by direction on
    the CPU as on the card: 1 + 1 a step call, 2 + 2 a grad call through
    the step (each forward and the other's adjoint), one K1 launch a map
    on the card; none for fft/ifft, an odd n or a half length K1 runs on
    the stage loop."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    step, (v, phr, phi) = entry(device, batch=4)
    profiling.reset()
    step(v, phr, phi)
    assert profiling.real_maps == {"r2c": 1, "c2r": 1}
    counts = profiling.counts()
    assert (counts["real.r2c"], counts["real.c2r"]) == (1, 1)
    assert counts["K1"] == (2 if device == "cuda" else 0)
    v, phr, phi = (t.clone().requires_grad_(True) for t in (v, phr, phi))
    profiling.reset()
    out = step(v, phr, phi)
    torch.autograd.grad(out, (v, phr, phi), torch.ones_like(out))
    assert profiling.real_maps == {"r2c": 2, "c2r": 2}
    assert profiling.launches["K1"] == (4 if device == "cuda" else 0)
    profiling.reset()
    pt.ifft(pt.fft(torch.randn(2, 960, dtype=torch.complex64,
                               device=device)))
    for n in (961, 192):
        x = torch.randn(2, n, device=device)
        pt.irfft_split(*pt.rfft_split(x), n)
    assert profiling.real_maps == {"r2c": 0, "c2r": 0}
    profiling.reset()
    assert set(profiling.counts().values()) == {0}


def test_k1_launch_has_pack_and_kernel_spans(k1_entry):
    x = torch.randn(6, 960)[:, ::2]                    # strided: a copy
    fused_fft._launch(x, x, 480, False, 1.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.launch"):
            fused_fft._launch(x, x, 480, False, 1.0)
    spans = _spans(prof)
    assert _pairs(spans) == {("test.launch", None),
                             ("cfftpack.pack", "test.launch"),
                             ("cfftpack.K1", "test.launch")}
    (pack,) = [s for s in spans if s[0] == "cfftpack.pack"]
    (k1,) = [s for s in spans if s[0] == "cfftpack.K1"]
    assert pack[4] <= k1[3]                            # no overlap
    copies = [e for e in prof.events()
              if e.name in ("aten::contiguous", "aten::clone")
              and pack[3] <= e.time_range.start <= pack[4]]
    assert copies


def test_second_call_builds_no_plan():
    plan.clear_device_tables()
    step, v, phr, phi = _step_inputs()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(v, phr, phi)
    built = profiling.counts()["plans"]
    first = [s for s in _spans(prof) if s[0] == "cfftpack.plan"]
    # the tables of 480 (the plain K1) and of 960 (the merge's tables)
    assert built == len(first) == 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(v, phr, phi)
    assert not [s for s in _spans(prof) if s[0] == "cfftpack.plan"]
    assert profiling.counts()["plans"] == built
    profiling.reset()
    assert set(profiling.counts().values()) == {0}


@pytest.mark.cuda
def test_spans_on_card():
    """On the card the step's K1 launches sit in ``cfftpack.K1`` spans
    after their ``cfftpack.pack`` copies, and autograd's device thread
    runs each adjoint in ``cfftpack.adjoint``, inside the caller's
    ``torch.autograd.grad``, with its own K1 span inside, or for the
    filter's multiply its ``cfftpack.cmul`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    step, args = entry("cuda", batch=64)
    v, phr, phi = (t.clone().requires_grad_(True) for t in args)
    cot = torch.randn_like(v)
    for _ in range(2):
        torch.autograd.grad(step(v, phr, phi), (v, phr, phi), cot)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step(v, phr, phi)
        with record_function("test.grad"):
            torch.autograd.grad(out, (v, phr, phi), cot)
        torch.cuda.synchronize()
    spans = _spans(prof)
    pairs = _pairs(spans)
    assert {("cfftpack.K1", "cfftpack.rfft_split"),
            ("cfftpack.K1", "cfftpack.irfft_split"),
            ("cfftpack.cmul", "cfftpack.filter"),
            ("cfftpack.K1", "cfftpack.adjoint"),
            ("cfftpack.cmul", "cfftpack.adjoint")} <= pairs, pairs
    # the real modes read the rows as they lie and do the glue in K1
    assert not any(n in ("cfftpack.plan", "cfftpack.pack", "cfftpack.merge",
                         "cfftpack.scale", "cfftpack.unpack")
                   for n, *_ in spans), pairs
    (grad,) = [s for s in spans if s[0] == "test.grad"]
    adj = [s for s in spans if s[0] == "cfftpack.adjoint"]
    assert len(adj) == 3
    for name, parent, tid, a, b in adj:
        assert tid != grad[2], "the backward ran on the caller's thread"
        assert grad[3] <= a and b <= grad[4]
        assert any(n in ("cfftpack.K1", "cfftpack.cmul") and t == tid
                   and a <= a2 and b2 <= b
                   for n, _, t, a2, b2 in spans), "no kernel in the adjoint"
    launches = [e.time_range.start for e in prof.events()
                if "LaunchKernel" in e.name]
    for name, parent, tid, a, b in spans:
        if name in ("cfftpack.K1", "cfftpack.cmul"):
            assert any(a <= t <= b for t in launches), (parent, a, b)
    assert np.isfinite(out.detach().cpu().numpy()).all()
