"""The check that decides ``correct``, driven through the harness on the
CPU at small sizes (the harness's look for a card skipped): the program
passes, the control (the reference in the precision below) fails, and
so does each fault a cell can have, planted under the timed path."""
import random

import pytest
import torch

from portbench import harness, spec

ROWS = {"conv960.book": 64, "conv960.greeks": 64, "c2c1024.stream": 32}


def _cell(name):
    cell = spec.resolve(name)
    cell.traffic = dict(cell.traffic, rows=ROWS[name])
    return cell


def _run(cell, program=None, seed=2 ** 31 + 5):
    return harness.run_cell(cell, seed, 0.3, False, torch.device("cpu"),
                            harness.clock(), program=program)


def _program(cell):
    return spec.load_module(cell.builder, "config").program(cell.sizes,
                                                            cell.traffic)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_program_is_correct(name):
    r = _run(_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in _cell(name).end_to_end}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_control_is_not_correct(name):
    cell = _cell(name)
    ref = spec.load_module(cell.reference, "reference")
    r = _run(cell, ref.control(cell.sizes, cell.traffic))
    assert not r["correct"], r["checks"]


def _unchanged(cell):
    """A step that returns its state unchanged: each output is the input
    of its shape."""
    prog = _program(cell)

    def call(inputs, slot):
        state = [t[slot] if isinstance(t, list) else t
                 for t in inputs.values() if t is not None]
        return tuple(next(s for s in state if s.shape == o.shape).detach()
                     for o in prog(inputs, slot))
    return call


def _half(cell):
    """Half of the batch left out: the program on the first half of the
    rows, the rest of each row output zero, each sum over rows doubled
    (the mean taken over the rest)."""
    prog = _program(cell)
    rows = cell.traffic["rows"]

    def cut(t):
        if isinstance(t, list):
            return [cut(b) for b in t]
        if isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == rows:
            return t[: rows // 2]
        return t

    def call(inputs, slot):
        outs = prog({k: cut(v) for k, v in inputs.items()}, slot)
        return tuple(
            torch.cat([o, torch.zeros_like(o)]) if o.shape[0] == rows // 2
            else 2 * o for o in outs)
    return call


def _altered(cell):
    """One answer altered where it is produced: an element of the first
    output moved by a hundredth of its largest value."""
    prog = _program(cell)
    r = random.Random(3)

    def call(inputs, slot):
        outs = list(prog(inputs, slot))
        o = outs[0].detach().clone()
        i, j = r.randrange(o.shape[0]), r.randrange(o.shape[1])
        o[i, j] += 0.01 * o.abs().max()
        outs[0] = o
        return tuple(outs)
    return call


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half_batch", "altered_answer"])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_fault_is_not_correct(name, fault):
    cell = _cell(name)
    r = _run(cell, fault(cell))
    assert not r["correct"], r["checks"]


def test_seed_gives_the_same_inputs():
    cell = _cell("conv960.greeks")
    mod = spec.load_module(cell.builder, "config")
    a, b = (mod.make_inputs(cell.sizes, cell.traffic,
                            torch.Generator().manual_seed(2 ** 33 + 1),
                            torch.device("cpu")) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a["v"], b["v"]))
    assert torch.equal(a["cot"], b["cot"]) and torch.equal(a["phr"], b["phr"])
    # a characteristic function is real at bin 0, and the packed layout
    # keeps bin n/2 real
    assert a["phi"][0] == 0 and a["phi"][-1] == 0
