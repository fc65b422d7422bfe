"""The benchmark's ``dctsuite`` configuration (``portbench/configs/dctsuite*.py``)
on the CPU, at 8 rows of each length:

* the cell's program (the port's ``rfft_split``/``irfft_split``, ``dct``/
  ``idct``, ``dst``/``idst`` round trips at 960, 1000 and 1250) against
  the plain reference's ``compare``, every check under its limit, and the
  same through the harness, with the control (the reference one precision
  down) not correct;
* the reference's dense matrices against ``scipy.fft``'s ``rfft``, ``dct``
  and ``dst`` of types 2, 3 and 4 at n = 10, 12 and 30 (n % 4 = 2 and 0),
  under the scales the port states for ``norm="fftpack"``;
* planted faults, each failing a check: one output of the 1250 block moved
  by 1%, the DST-II answered by the DCT-II, the forwards left unscaled,
  half of the rows returned as the input;
* the reference imports neither JAX, nor the JAX package, nor the port,
  and the builder no JAX (in a subprocess);
* the ideal bytes of a call, and the inputs drawn again from the seed.
"""
import json
import random
import subprocess
import sys

import numpy as np
import pytest
import scipy.fft as sf
import torch

from portbench import harness, spec

torch.set_num_threads(1)

CELL = "dctsuite.suite16k"
ROWS = 8
SEED = 2 ** 31 + 27
CPU = torch.device("cpu")


def _cell():
    cell = spec.resolve(CELL)
    cell.traffic = dict(cell.traffic, rows=ROWS)
    return cell


@pytest.fixture(scope="module")
def suite():
    cell = _cell()
    builder = spec.load_module(cell.builder, "config")
    ref = spec.load_module(cell.reference, "reference")
    inputs = builder.make_inputs(cell.sizes, cell.traffic,
                                 torch.Generator().manual_seed(SEED), CPU)
    return cell, builder, ref, inputs


def _checks(suite, call, slots=(0, 1)):
    cell, _, ref, inputs = suite
    calls = {i: (s, call(inputs, s)) for i, s in enumerate(slots)}
    return ref.compare(cell.sizes, cell.traffic, inputs, calls)


def _failed(suite, errs):
    limits = suite[0].limits
    return sorted(k for k, v in errs.items() if not v <= limits[k]["limit"])


def test_program_is_within_every_limit(suite):
    cell, builder, ref, _ = suite
    errs = _checks(suite, builder.program(cell.sizes, cell.traffic))
    assert set(errs) == set(ref.CHECKS) == set(cell.limits)
    assert not _failed(suite, errs), errs
    assert all(0 < v < 1e-6 for v in errs.values()), errs


def test_harness_runs_the_cell_and_the_control_fails():
    cell = _cell()
    r = harness.run_cell(cell, SEED, 0.2, False, CPU, harness.clock())
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end} == {
        "c2c_rows_per_s", "c2c_call_p95_ms", "setup_s"}
    ref = spec.load_module(cell.reference, "reference")
    r = harness.run_cell(cell, SEED, 0.2, False, CPU, harness.clock(),
                         program=ref.control(cell.sizes, cell.traffic))
    assert not r["correct"], r["checks"]
    # TF32 products miss every check, by a factor of ten or more
    assert all(c["value"] > 10 * c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("n", [10, 12, 30])
def test_reference_matrices_match_scipy(n, suite):
    ref = suite[2]
    m = ref.matrices(n, torch.float64, CPU)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n))
    got = [t.numpy() for t in ref.suite(torch.from_numpy(x), m)]
    spec_ = sf.rfft(x) / n
    want = [spec_.real, spec_.imag, x, sf.dct(x, 2) / n, x,
            sf.dst(x, 2) / n, x, sf.dct(x, 4) / n, x]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-13)
    # the inverses alone: FFTPACK's unscaled DCT-III, DST-III, DCT-IV, c2r
    y = torch.from_numpy(rng.standard_normal((5, n)))
    for name, oracle in (("dct3", sf.dct(y.numpy(), 3) / 2),
                         ("dst3", sf.dst(y.numpy(), 3) / 2),
                         ("idct4", sf.dct(y.numpy(), 4) / 2)):
        np.testing.assert_allclose((y @ m[name]).numpy(), oracle, rtol=0,
                                   atol=1e-13, err_msg=name)
    spec_[:, 0] = spec_[:, 0].real
    spec_[:, -1] = spec_[:, -1].real
    yr, yi = torch.from_numpy(spec_.real), torch.from_numpy(spec_.imag)
    np.testing.assert_allclose((yr @ m["ir"] + yi @ m["ii"]).numpy(),
                               sf.irfft(spec_, n) * n, rtol=0, atol=1e-13)


def _moved(suite):
    """One output of the 1250 block, the DCT-IV's, moved by a hundredth
    of its largest value at one element."""
    cell, builder = suite[:2]
    prog = builder.program(cell.sizes, cell.traffic)
    r = random.Random(5)
    at = 9 * cell.sizes["lengths"].index(1250) + 7

    def call(inputs, slot):
        outs = list(prog(inputs, slot))
        o = outs[at].clone()
        o[r.randrange(o.shape[0]), r.randrange(o.shape[1])] += \
            0.01 * o.abs().max()
        outs[at] = o
        return tuple(outs)
    return call, {"dct4_err"}


def _dst_as_dct(suite):
    """The DST-II answered by the DCT-II at every length."""
    cell, builder = suite[:2]
    prog = builder.program(cell.sizes, cell.traffic)

    def call(inputs, slot):
        outs = list(prog(inputs, slot))
        for i in range(len(cell.sizes["lengths"])):
            outs[9 * i + 5] = outs[9 * i + 3]
        return tuple(outs)
    return call, {"dst2_err"}


def _unscaled(suite):
    """The forwards left unscaled: the norm that puts the scale on the
    inverse, so that every round trip still holds."""
    cell, builder = suite[:2]
    sizes = dict(cell.sizes, norm="backward")
    return (builder.program(sizes, cell.traffic),
            {"rfft_err", "dct2_err", "dst2_err", "dct4_err"})


def _half_input(suite):
    """Half of the rows of every output returned as the input (its first
    columns where the output is narrower)."""
    cell, builder = suite[:2]
    prog = builder.program(cell.sizes, cell.traffic)

    def call(inputs, slot):
        outs = list(prog(inputs, slot))
        for i, n in enumerate(cell.sizes["lengths"]):
            x = inputs["x"][n][slot]
            for o in range(9 * i, 9 * i + 9):
                t = outs[o].clone()
                t[ROWS // 2:] = x[ROWS // 2:, : t.shape[1]]
                outs[o] = t
        return tuple(outs)
    # the reconstructions' rows, each the input, still pass
    return call, {"rfft_err", "dct2_err", "dst2_err", "dct4_err"}


@pytest.mark.parametrize("fault", [_moved, _dst_as_dct, _unscaled,
                                   _half_input],
                         ids=["moved_1250", "dst_as_dct", "unscaled",
                              "half_rows_input"])
def test_planted_fault_fails_its_checks(fault, suite):
    call, expect = fault(suite)
    failed = _failed(suite, _checks(suite, call))
    assert expect <= set(failed), failed


def test_reference_imports_no_jax_and_no_port():
    code = (
        "import sys, json, torch\n"
        "from portbench import spec\n"
        "cell = spec.resolve('%s')\n"
        "ref = spec.load_module(cell.reference, 'reference')\n"
        "ref.matrices(10, torch.float64, torch.device('cpu'))\n"
        "a = spec.forbidden_modules(sys.modules)\n"
        "port = sorted(m for m in sys.modules\n"
        "              if m.split('.')[0] == 'cfftpack_tpu_torch')\n"
        "spec.load_module(cell.builder, 'config')\n"
        "b = spec.forbidden_modules(sys.modules)\n"
        "print(json.dumps([a, port, b]))\n" % CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], [], []]


def test_ideal_bytes_by_hand():
    cell = _cell()
    counts = spec.load_module(cell.counts, "counts")
    # 2 rows: each length's input, the spectrum's two planes of n/2 + 1
    # and seven outputs of n, in float32
    per_row = sum(n + 2 * (n // 2 + 1) + 7 * n for n in (960, 1000, 1250))
    assert per_row == 3210 + 2 * (481 + 501 + 626) + 7 * 3210
    assert counts.ideal_bytes(cell.sizes, {"rows": 2}) == 2 * per_row * 4


def test_seed_gives_the_same_inputs(suite):
    cell, builder = suite[:2]
    a, b = (builder.make_inputs(cell.sizes, cell.traffic,
                                torch.Generator().manual_seed(2 ** 33 + 3),
                                CPU)["x"] for _ in range(2))
    assert sorted(a) == cell.sizes["lengths"] == [960, 1000, 1250]
    for n in a:
        assert len(a[n]) == cell.traffic["ring"]
        assert all(t.shape == (ROWS, n) and t.dtype == torch.float32
                   for t in a[n])
        assert all(torch.equal(x, y) for x, y in zip(a[n], b[n]))
