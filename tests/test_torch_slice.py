"""The slice end to end: the flagship step and the conv pricer against
the JAX package, that importing the port leaves JAX out, that CPU runs
never launch the kernel, and that the entry points run on the card
unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

import __graft_entry__
from cfftpack_tpu.models import (bs_cf as j_bs_cf,
                                 conv_bsvg_option as j_conv_bsvg_option,
                                 conv_option_price as j_conv_option_price)

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch.config import resolve_device
from cfftpack_tpu_torch.entry import entry
from cfftpack_tpu_torch.models import (bs_cf, conv_bsvg_option,
                                       conv_option_price)
from cfftpack_tpu_torch import compat
from cfftpack_tpu_torch.models import (asian_option_qmc_device,
                                       callable_bond_demo, vg_mc_price_device)
from cfftpack_tpu_torch.ops import stream_fft
from cfftpack_tpu_torch.utils import halton_batch
from cfftpack_tpu_torch.utils import profiling

from cfftpack_tpu_torch.parallel._comm import count_collectives

from torch_parity import one_rank_mesh, rel_err, to_np  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
STRIKES = np.arange(80.0, 120.0, 0.5)                  # 80 strikes
# the reference's variance-gamma benchmark (test/vargamma.c:108-121)
VG = (100.0, 98.0, 0.12, -0.14, 0.2, 1.0, 0.05)


def test_flagship_step_matches_reference():
    jstep, jargs = __graft_entry__.entry()
    want = np.asarray(jax.jit(jstep)(*jargs))
    step, args = entry("cpu")
    for a, b in zip(args, jargs):
        assert np.array_equal(to_np(a), np.asarray(b))   # same inputs
    got = step(*args)
    assert got.shape == (64, 960) and got.dtype == torch.float32
    assert rel_err(got, want) < 1e-4                   # f32 bar


def test_conv_option_price_matches_reference():
    def phi(u):
        return bs_cf(u, 0.25, 0.2, 0.03)

    got = conv_option_price(100.0, STRIKES, 0.25, 0.03, phi, n=4096,
                            grid_sigma=0.2, device="cpu")
    want = j_conv_option_price(100.0, STRIKES, 0.25, 0.03,
                               lambda u: j_bs_cf(u, 0.25, 0.2, 0.03),
                               n=4096, grid_sigma=0.2)
    assert got.shape == (80,)
    assert rel_err(got, want) < 1e-12                  # f64 bar


@pytest.mark.parametrize("is_call", [True, False])
def test_conv_bsvg_option_vg_matches_reference(is_call):
    got = conv_bsvg_option(4096, *VG, is_call=is_call, is_bs=False,
                           device="cpu")
    want = j_conv_bsvg_option(4096, *VG, is_call=is_call, is_bs=False)
    assert abs(got - want) < 1e-12 * abs(want)


def test_pricer_mesh_waits_for_the_parallel_layer(one_rank_mesh):
    """The sharded ladder: a mesh that is not a DeviceMesh raises
    TypeError (before any device is resolved); on a one-rank gloo mesh
    it matches the mesh=None call and gathers once."""
    def price(**kw):
        return conv_option_price(100.0, STRIKES, 0.25, 0.03, _phi, n=4096,
                                 grid_sigma=0.2, **kw)

    with pytest.raises(TypeError, match="DeviceMesh"):
        price(mesh=object())
    with count_collectives() as cc:
        got = price(mesh=one_rank_mesh)
    assert cc["all_gather_into_tensor"] == 1
    assert rel_err(got, price(device="cpu")) < 1e-15


def test_import_leaves_jax_out():
    code = ("import sys, cfftpack_tpu_torch, cfftpack_tpu_torch.models, "
            "cfftpack_tpu_torch.entry, cfftpack_tpu_torch.ops.stream_fft, "
            "cfftpack_tpu_torch.ops.colfft, "
            "cfftpack_tpu_torch.ops.fourstep_fft, "
            "cfftpack_tpu_torch.ops.gdft, cfftpack_tpu_torch.ops.oddtypes, "
            "cfftpack_tpu_torch.ops.shift, cfftpack_tpu_torch.ops.freq, "
            "cfftpack_tpu_torch.ops.hp, cfftpack_tpu_torch.compat, "
            "cfftpack_tpu_torch.apps, cfftpack_tpu_torch.utils, "
            "cfftpack_tpu_torch.models.montecarlo, "
            "cfftpack_tpu_torch.models.shortrate, "
            "cfftpack_tpu_torch.parallel, cfftpack_tpu_torch.dryrun, "
            "cfftpack_tpu_torch.utils.cache, cfftpack_tpu_torch.utils.aot, "
            "cfftpack_tpu_torch.utils.profiling, "
            "cfftpack_tpu_torch.utils.debug; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'cfftpack_tpu.'))] ; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ------------------------------------------------------ the port's layers
#
# base (plan, _build, _adjoint, config, utils.profiling) <- kernel wrappers
# <- the engine (ops/core.py, which alone picks a kernel) <- the API
# (cfft, rfft, ...) and parallel/, read from the sources by ast.

PORT = "cfftpack_tpu_torch"
KERNEL_WRAPPERS = tuple(f"{PORT}.ops.{m}" for m in (
    "fused_fft", "stream_fft", "rstream", "colfft", "fourstep_fft", "cmul"))


def _port_imports():
    """({module: {(imported module, name or None)}}, packages): every
    import of every module of the port, module-level and function-level,
    relative ones resolved; (module, None) where a module is imported,
    (module, name) where a name is taken from it."""
    paths = {}
    for p in (REPO / PORT).rglob("*.py"):
        parts = p.relative_to(REPO).with_suffix("").parts
        paths[".".join(parts[:-1] if parts[-1] == "__init__"
                       else parts)] = p
    graph = {}
    for mod, path in paths.items():
        pkg = mod.split(".")
        if path.name != "__init__.py":
            pkg = pkg[:-1]
        deps = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                deps |= {(a.name, None) for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                base = node.module
                if node.level:
                    up = pkg[:len(pkg) - node.level + 1]
                    base = ".".join(up + ([base] if base else []))
                for a in node.names:
                    sub = f"{base}.{a.name}"
                    deps.add((sub, None) if sub in paths else (base, a.name))
        graph[mod] = {(m, n) for m, n in deps if m in paths}
    packages = {m for m, p in paths.items() if p.name == "__init__.py"}
    return graph, packages


def _import_cycle(graph, packages):
    """One import cycle among the port's non-package modules, or []."""
    edges = {m: sorted({d for d, _ in deps if d not in packages})
             for m, deps in graph.items() if m not in packages}
    state, stack = {}, []

    def visit(m):
        state[m] = "open"
        stack.append(m)
        for d in edges[m]:
            if state.get(d) == "open":
                return stack[stack.index(d):] + [d]
            if d not in state and (found := visit(d)):
                return found
        state[m] = "done"
        stack.pop()
        return []

    for m in sorted(edges):
        if m not in state and (found := visit(m)):
            return found
    return []


def _base_reaches_ops(graph, packages):
    base = [f"{PORT}.{m}" for m in ("plan", "ops._build", "ops._adjoint",
                                    "config", "utils.profiling")]
    return [(m, d) for m in base for d, _ in graph[m]
            if d.startswith(f"{PORT}.ops") and d != m]


def _wrappers_reach_up(graph, packages):
    above = tuple(f"{PORT}.ops.{m}" for m in (
        "core", "cfft", "rfft", "dct", "gdft", "hp", "oddtypes"))
    return [(m, d) for m in KERNEL_WRAPPERS for d, _ in graph[m]
            if d in above]


def _api_reaches_past_engine(graph, packages):
    mods = [m for m in graph if m in (f"{PORT}.ops.cfft", f"{PORT}.ops.rfft")
            or m.startswith(f"{PORT}.parallel")]
    return [(m, d, n) for m in mods for d, n in graph[m]
            if d in KERNEL_WRAPPERS
            or (d == f"{PORT}.ops.cfft" and n and n.startswith("_"))]


LAYER_RULES = {
    "no import cycle": _import_cycle,
    "the base imports nothing from ops": _base_reaches_ops,
    "kernel wrappers import no engine or API": _wrappers_reach_up,
    "cfft, rfft and parallel reach no kernel wrapper": (
        _api_reaches_past_engine),
}


@pytest.mark.parametrize("rule", sorted(LAYER_RULES))
def test_port_layers(rule):
    """The port's imports point one way: tables and the C entry under
    the kernel wrappers, under the engine, under the API; the offending
    imports are listed."""
    assert LAYER_RULES[rule](*_port_imports()) == []


@pytest.mark.parametrize("script", ["examples/torch_pricing_demo.py",
                                    "examples/torch_sharded_demo.py",
                                    "scripts/torch_validate.py",
                                    "chip_smoke.py"])
def test_scripts_leave_jax_out(script):
    code = ("import importlib.util, sys; "
            f"spec = importlib.util.spec_from_file_location('d', {script!r}); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'cfftpack_tpu.'))] ; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# names of the JAX package not ported yet: none
NOT_PORTED = {}


@pytest.mark.parametrize("ref", ["cfftpack_tpu", "cfftpack_tpu.models",
                                 "cfftpack_tpu.apps", "cfftpack_tpu.utils",
                                 "cfftpack_tpu.compat",
                                 "cfftpack_tpu.parallel"])
def test_port_has_every_public_name(ref):
    """Every public name of the JAX package's top level, models, apps,
    utils, compat.__all__ and parallel exists in the port, bar the
    listed ones."""
    import importlib
    import inspect
    mod = importlib.import_module(ref)
    port = importlib.import_module(ref.replace("cfftpack_tpu",
                                               "cfftpack_tpu_torch", 1))
    names = getattr(mod, "__all__", None) or [
        n for n, v in vars(mod).items()
        if not n.startswith("_") and not inspect.ismodule(v)]
    assert names
    missing = {n for n in names if not hasattr(port, n)}
    assert missing == NOT_PORTED.get(ref, set()), missing


def test_cpu_slice_never_launches_the_kernel():
    step, args = entry("cpu", batch=4)
    step(*args)
    conv_option_price(100.0, STRIKES[:4], 0.25, 0.03,
                      lambda u: bs_cf(u, 0.25, 0.2, 0.03), n=256,
                      grid_sigma=0.2, device="cpu")
    pt.fft2_split(torch.zeros((2, 64, 8)), torch.zeros((2, 64, 8)))
    pt.dctn(torch.zeros((2, 64, 8)), 2, axes=(-2, -1))
    z = torch.zeros((2, 4096))
    pt.fft_split(z, z, impl="pallas")
    stream_fft.sfft_mm2(z, z, 4096, False)
    pt.gdft(torch.zeros((2, 60), dtype=torch.complex64), 0.5, 0.25)
    pt.dct(torch.zeros((2, 13)), 5)
    assert (profiling.launches["K1"] == 0
            and profiling.launches["K10"] == 0)
    assert {k: profiling.launches[k] for k in ("K2", "K3", "K4", "K5",
                                                "K11")} == {
        "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K11": 0}
    assert {k: profiling.launches[k] for k in ("K6", "K9")} == {"K6": 0,
                                                                "K9": 0}


def _phi(u):
    return bs_cf(u, 0.25, 0.2, 0.03)


DEFAULT_DEVICE_CALLS = {
    "entry": lambda **kw: entry(batch=2, **kw),
    "conv_option_price": lambda **kw: conv_option_price(
        100.0, STRIKES[:2], 0.25, 0.03, _phi, n=64, grid_sigma=0.2, **kw),
    "conv_bsvg_option": lambda **kw: conv_bsvg_option(64, *VG, **kw),
    "fft of a list": lambda **kw: pt.fft(
        [1.0, 2.0, 3.0] if not kw else torch.tensor([1.0, 2.0, 3.0], **kw)),
    "dct of an ndarray": lambda **kw: pt.dct(
        np.ones(6) if not kw else torch.ones(6, **kw)),
    "gdft of a list": lambda **kw: pt.gdft(
        [1.0, 2.0, 3.0] if not kw else torch.tensor([1.0, 2.0, 3.0], **kw),
        0.5, 0.25),
    "fft_hp of a list": lambda **kw: pt.fft_hp(
        [1.0, 2.0, 3.0] if not kw else torch.tensor([1.0, 2.0, 3.0], **kw)),
    "compat plan on a list": lambda **kw: compat.fft_create(3).forward(
        [1.0, 2.0, 3.0] if not kw else torch.tensor([1.0, 2.0, 3.0], **kw)),
    "halton_batch": lambda **kw: halton_batch(1, 4, 3, **kw),
    "asian_option_qmc_device": lambda **kw: asian_option_qmc_device(
        steps=4, samples=8, **kw),
    "vg_mc_price_device": lambda **kw: vg_mc_price_device(
        n=64, samples=16, **kw),
    "callable_bond_demo": lambda **kw: callable_bond_demo(
        nstep=4, n_fft=16, maturity=1.0, **kw),
    "fftfreq": lambda **kw: pt.fftfreq(8, **kw),
    "rfftfreq": lambda **kw: pt.rfftfreq(8, **kw),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_default_device_is_the_card(name, monkeypatch):
    """With no device named, an entry point runs on the card: where
    there is none it raises and does not fall back; device="cpu" (or a
    CPU tensor) runs."""
    call = DEFAULT_DEVICE_CALLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    call(device="cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")


@pytest.mark.cuda
def test_default_device_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, args = entry(batch=2)
    assert all(a.is_cuda for a in args)
    assert pt.fft([1.0, 2.0, 3.0]).is_cuda
