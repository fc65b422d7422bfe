"""The benchmark's configuration c2c1m on the CPU: the long complex round
trip of ``BASELINE.json`` configs[2], ``fft`` then ``ifft`` on complex64
rows of 2^20 (``portbench/configs/c2c1m*.py``).

* The plain reference (one index map n = n1 * n2 of dense DFTs, in
  complex128) against ``numpy.fft`` at 2^20 and at 1000 = 25 x 40.
* The port's route on the CPU (``core.sfft`` to the K5 split's plain
  version, ``stream_plain``) against the reference, through the check
  that decides ``correct`` and the cell's limits.
* The dispatch at (2^20, float32): the split of 2, not K1 nor the
  in-core four-step.
* Planted faults under the check read ``correct`` false.
* The bytes of a call and the readers of K5's kernels.
"""
import types

import numpy as np
import pytest
import torch

import cfftpack_tpu_torch as ct
from cfftpack_tpu_torch.ops import core, fused_fft, stream_fft
from portbench import spec
from portbench import trace as tracing

N = 1 << 20
SEED = 2 ** 31 + 23
CELL = spec.resolve("c2c1m.stream64")
REF = spec.load_module(CELL.reference, "reference")
CONF = spec.load_module(CELL.builder, "config")
# float32 rounding over K5's 20 radix-2 levels (and the reference's own
# complex128, 1e-15) leaves the port near 4e-7 of max |X| at 2^20; TF32's
# 10-bit products read 3.5e-4, far outside 1e-5.
TOL = 1e-5


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n,rows", [(N, 1), (1000, 3)])
def test_reference_matches_numpy(n, rows):
    rng = np.random.default_rng(n + rows)
    x = rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))
    assert REF.factors(n) == ((1024, 1024) if n == N else (25, 40))
    t = torch.from_numpy(x)
    want = np.fft.fft(x)
    assert _rel(REF.transform(t).numpy(), want) < 1e-13
    assert _rel(REF.transform(t, inverse=True).numpy(),
                np.fft.ifft(x) * n) < 1e-13
    spec_, recon = REF.round_trip(t)
    assert _rel(spec_.numpy(), want / n) < 1e-13
    assert _rel(recon.numpy(), x) < 1e-13


def test_reference_leaves_tf32_as_it_found_it():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    x = torch.randn(2, 1000, dtype=torch.complex64)
    seen = []
    for _ in REF._blocks({"x": [x]}, 0, torch.complex128, False):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
    assert seen == [(False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags


@pytest.fixture(scope="module")
def run():
    """Inputs of two rows of 2^20 and the program's outputs on them."""
    traffic = dict(CELL.traffic, rows=2, ring=1)
    gen = torch.Generator().manual_seed(SEED)
    inputs = CONF.make_inputs(CELL.sizes, traffic, gen,
                                 torch.device("cpu"))
    outs = CONF.program(CELL.sizes, traffic)(inputs, 0)
    return traffic, inputs, outs


def _checks(run, outs):
    traffic, inputs, _ = run
    return REF.compare(CELL.sizes, traffic, inputs, {0: (0, outs)})


def _correct(errs) -> bool:
    return all(errs[k] <= v["limit"] for k, v in CELL.limits.items())


def test_program_matches_reference(run):
    _, inputs, (spec_, recon) = run
    assert spec_.dtype == recon.dtype == torch.complex64
    assert spec_.shape == recon.shape == (2, N)
    errs = _checks(run, (spec_, recon))
    assert set(errs) == set(CELL.limits)
    assert errs["spectrum_err"] < TOL and errs["recon_err"] < TOL, errs
    assert _correct(errs)


def test_control_is_not_correct(run):
    traffic, inputs, _ = run
    outs = REF.control(CELL.sizes, traffic)(inputs, 0)
    errs = _checks(run, outs)
    assert min(errs.values()) > TOL and not _correct(errs), errs


def test_split_factor_and_dispatch(monkeypatch):
    """(2^20, float32) takes the K5 split of 2 (m = 4096); fft reaches it
    and its plain version's "split" and "split_inv" modes, and neither K1
    nor the in-core four-step."""
    assert stream_fft._filter_split_factor(N) == 2
    assert stream_fft.stream_filter_eligible(N, torch.float32)
    assert not fused_fft.fused_eligible(N, torch.float32)

    def refuse(*a, **k):
        raise AssertionError("not K5's route")
    monkeypatch.setattr(fused_fft, "sfft_fused", refuse)
    monkeypatch.setattr(core, "_fourstep_local", refuse)
    split, modes = stream_fft.sfft_stream_split, []

    def spy_split(xr, xi, n, inverse, scale=1.0):
        modes.append(("split", n, inverse, scale))
        return split(xr, xi, n, inverse, scale)
    plain = stream_fft.stream_plain

    def spy_plain(xr, xi, n, mode, *a, **k):
        modes.append(mode)
        return plain(xr, xi, n, mode, *a, **k)
    monkeypatch.setattr(stream_fft, "sfft_stream_split", spy_split)
    monkeypatch.setattr(stream_fft, "stream_plain", spy_plain)
    x = torch.randn(1, N, dtype=torch.complex64)
    ct.ifft(ct.fft(x))
    assert modes[0] == ("split", N, False, 1.0 / N)
    assert modes[1] == "split"
    assert ("split", N, True, 1.0) in modes and "split_inv" in modes
    assert {m for m in modes if isinstance(m, str)} == {
        "split", "split_inv", "fwd"}


def _moved_row(run):
    spec_, recon = run[2]
    spec_ = spec_.clone()
    spec_[1] *= 1.01
    return spec_, recon


def _half_as_input(run):
    _, inputs, (spec_, recon) = run
    x = inputs["x"][0]
    return (torch.cat([spec_[:1], x[1:]]), torch.cat([recon[:1], x[1:]]))


def _unscaled(run):
    spec_, recon = run[2]
    return spec_ * N, recon


@pytest.mark.parametrize("fault", [_moved_row, _half_as_input, _unscaled],
                         ids=["one_row_moved_1pct", "half_batch_as_input",
                              "forward_unscaled"])
def test_planted_fault_is_not_correct(run, fault):
    errs = _checks(run, fault(run))
    assert not _correct(errs), errs


def test_counts():
    counts = spec.load_module(CELL.counts, "counts")
    # 64 rows of 2^20 complex64: input, spectrum, reconstruction
    assert counts.ideal_bytes(CELL.sizes, CELL.traffic) == 3 * 64 * N * 8
    # two directions, each its (re, im) float32 planes in and out
    assert counts.k5_bytes(CELL.sizes, CELL.traffic) == \
        2 * (2 * 64 * N * 4 + 2 * 64 * N * 4)


def test_k5_readers():
    """Each K5 reader picks its kernels by name from a trace of two calls;
    the roofline share is K5's bytes at the peak over their time."""
    names = {"col": "void sf_split_col_reg_kernel<2, 4096>(SFSplitColIO<2>)",
             "row": "void sf_split_row_kernel<2, false>(SFSplitRowIO<2>)",
             "copy": "void at::native::elementwise_kernel<128, 4>()"}
    kernels = [tracing.Kernel(names[k], 0.0, us, call, 0.0)
               for call in (0, 1) for k, us in
               (("col", 1600.0), ("col", 1500.0), ("row", 400.0),
                ("row", 450.0), ("copy", 999.0))]
    tr = tracing.Trace((0.0, 1e4), [(0.0, 5e3), (5e3, 1e4)], kernels, [],
                       [], {})
    run = types.SimpleNamespace(trace=tr, cell=CELL, peak_bytes_per_s=3.35e12)

    def read(metric):
        return spec.load_module(CELL.reader(metric), "metric").read(run)
    assert read("k5_col_device_us.c2c1m") == 3100.0
    assert read("k5_row_device_us.c2c1m") == 850.0
    share = 100.0 * 4 * 64 * N * 8 / 3.35e12 / 3950e-6
    assert read("k5_roofline.c2c1m") == pytest.approx(share)
    run.trace = None
    assert read("k5_roofline.c2c1m") is None
