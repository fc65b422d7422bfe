"""The command as the driver runs it: no card, no result; no JAX."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _has_result(stdout):
    lines = stdout.strip().splitlines()
    try:
        return "correct" in json.loads(lines[-1])
    except (IndexError, ValueError):
        return False


@pytest.mark.parametrize("cell", ["conv960.book", "fft2_4096.weak4"])
def test_refuses_without_a_card(cell):
    """Exit 2 and no result, in one process or over ranks."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["--workload", cell, "--seed", str(2 ** 31 + 9),
              "--seconds", "1", "--trace", "0"], spec.REPO, env)
    assert p.returncode == 2 and not _has_result(p.stdout)
    assert "not measuring" in p.stderr


def test_harness_and_references_leave_jax_out():
    """A whole small run on the CPU in a fresh process, then no module
    whose top-level name is jax, jaxlib, flax or cfftpack_tpu (the cells
    over several ranks: test_portbench_ranks.py)."""
    code = (
        "import sys, torch\n"
        "from portbench import calibrate, harness, ranks, readers, run, spec\n"
        "for name in spec.every_cell():\n"
        "    c = spec.resolve(name)\n"
        "    if c.chips > 1:\n"
        "        continue\n"
        "    c.traffic = dict(c.traffic, rows=16)\n"
        "    spec.load_module(c.reference, 'reference')\n"
        "    r = harness.run_cell(c, 1, 0.1, False, torch.device('cpu'),\n"
        "                         harness.clock())\n"
        "    assert r['correct'], r\n"
        "print(spec.forbidden_modules(sys.modules))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_card_run_is_correct(card):
    p = _run(["--workload", "conv960.book", "--seed", str(2 ** 31 + 11),
              "--seconds", "2", "--trace", "0"], spec.REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
def test_card_run_needs_the_program(card, tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/."""
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.REPO / "portbench", tmp_path / "portbench")
    p = _run(["--workload", "conv960.book", "--seed", "3", "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert p.returncode != 0 and not _has_result(p.stdout)
