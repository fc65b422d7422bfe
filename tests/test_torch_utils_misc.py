"""The port's four small utils (``utils/cache.py``, ``aot.py``,
``profiling.py``, ``debug.py``) on the CPU, beside the JAX package's
(tests/test_utils_misc.py) where their meaning survives."""
import inspect
import json

import numpy as np
import pytest
import torch

import cfftpack_tpu.utils as ju

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import config, ops, parallel, plan
from cfftpack_tpu_torch import utils as pu


@pytest.fixture
def nan_checks():
    pu.enable_nan_checks(True)
    try:
        yield
    finally:
        pu.enable_nan_checks(False)


def test_enable_compilation_cache_makes_the_directory(tmp_path):
    path = tmp_path / "cache" / "dir"
    assert pu.enable_compilation_cache(str(path)) == str(path)
    assert path.is_dir()


def test_warm_plans_builds_the_device_tables(monkeypatch):
    sizes = (60, 101, 1024)
    pu.warm_plans(sizes, device="cpu", dtype=torch.float64)
    for n in sizes:
        tab = plan._DEVICE_TABLES[(n, torch.float64, torch.device("cpu"))]
        assert tab.n == n and np.prod(tab.factors) == n
    assert plan._DEVICE_TABLES[(101, torch.float64,
                                torch.device("cpu"))].bluestein is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pu.warm_plans([64])


def test_precompile_makes_one_warm_up_call():
    calls = []

    def step(v):
        calls.append(v.shape)
        return pt.rfft_split(v)

    x = torch.randn((4, 96), dtype=torch.float64)
    run = pu.precompile(step, x)
    assert calls == [(4, 96)]
    yr, yi = run(x)
    want = np.fft.rfft(x.numpy()) / 96
    assert np.abs(yr.numpy() + 1j * yi.numpy() - want).max() < 1e-15
    assert len(calls) == 2


def test_trace_exports_a_chrome_trace(tmp_path):
    x = torch.randn((8, 64), dtype=torch.complex64)
    with pu.trace(str(tmp_path)) as logdir:
        pt.fft(x)
    assert logdir == str(tmp_path)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_timer_on_the_host_clock():
    x = torch.randn((64, 1024), dtype=torch.complex64)
    with pu.Timer(sync=x) as t:
        pt.fft(x)
    assert t.seconds > 0.0
    with pu.Timer() as t:
        pass
    assert t.seconds >= 0.0


def test_check_finite_matches_reference():
    good = (torch.ones(3), np.zeros((2, 2)), torch.arange(4))
    pu.check_finite(*good)
    ju.check_finite(*(np.asarray(g) for g in good))
    bad = torch.tensor([1.0, float("nan"), float("inf")])
    for fn in (pu.check_finite, ju.check_finite):
        with pytest.raises(FloatingPointError, match=r"x\[1\]: 2 non-finite"):
            fn(good[0], np.asarray(bad) if fn is ju.check_finite else bad,
               name="x")
    with pytest.raises(FloatingPointError):
        pu.check_finite(torch.complex(bad, bad))


def test_nan_checks_at_the_api_exit(nan_checks):
    x = torch.tensor([1.0, float("nan"), 2.0, 3.0])
    with pytest.raises(FloatingPointError, match="fft"):
        pt.fft(x)
    with pytest.raises(FloatingPointError, match="rfft_split"):
        pt.rfft_split(x)
    pt.fft(torch.ones(4))
    pu.enable_nan_checks(False)
    assert config.NAN_CHECKS is False
    assert torch.isnan(pt.fft(x)).any()


def test_every_public_transform_passes_the_api_exit():
    for mod in (ops, parallel):
        names = [n for n, v in vars(mod).items() if inspect.isfunction(v)
                 and not n.startswith("_")]
        assert names
        for n in names:
            if n in ("make_mesh", "local_mesh", "init_distributed"):
                continue
            assert getattr(mod, n).__wrapped__, n
    assert pt.fft is ops.fft


@pytest.mark.cuda
def test_timer_and_trace_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn((64, 1024), dtype=torch.complex64, device="cuda")
    pt.fft(x)
    with pu.Timer(sync=x) as t:
        pt.fft(x)
    assert t.seconds > 0.0
    with pu.trace(str(tmp_path)):
        pt.fft(x)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
