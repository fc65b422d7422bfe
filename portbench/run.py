"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload conv960.book --seed 7 --seconds 10 --trace 0

Refuses to run (exit 2, no result) without as many CUDA cards as the
cell asks for: it never falls back to the CPU.  With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics from a profiled stretch after the window.  The
checks against the plain reference come last, on standard error and in
the result line; the result line is the last line of standard output.
Exit 3, no result, where a module of JAX or of the JAX package is loaded
once the run is done.

A cell of one chip runs in this process on card 0.  A cell of ``chips``
above 1 runs over that many ranks (``ranks.py``), under this contract:

* Ranks.  The launcher (this process) starts ``chips`` rank processes
  from the ``spawn`` context; it imports neither PyTorch nor the program
  and uses no card.  A rank that finds fewer than ``chips`` cards exits
  2, and so does the launcher, with no result.  Rank r takes card
  r and joins the program's NCCL group through
  ``cfftpack_tpu_torch.parallel.init_distributed`` at
  ``tcp://localhost:<a free port>``, and opens a gloo group of the
  harness's own over which the ranks agree.  Each group's collectives
  time out after ``ranks.GROUP_TIMEOUT_S`` (the program's group where
  this PyTorch can set it).  Rank 0 builds the kernel library where the
  checkout has none before the others load it.
* Agreement.  Every rank makes the same calls in the same order, so no
  collective is left unmatched: after the warm calls every rank makes
  exactly ceil(seconds / t) calls, t being rank 0's warm seconds a call,
  broadcast over gloo, with no control traffic between calls.  A call's
  time is the largest of its times on the ranks and the window's the
  largest of the ranks' windows, gathered over gloo once the window has
  closed.  ``setup_s`` (counted from the launcher's start) and
  ``memory_peak_bytes`` are the largest rank's, ``device.count`` is
  ``chips``.  The traced stretch runs on every rank and is taken again on
  every rank unless each rank's trace is whole; rank 0's trace gives the
  per-layer metrics, ``busy_s`` and ``window_s`` are averaged over the
  ranks.  A failed call ends its rank, and so the run.
* The check.  Each rank compares the calls it kept with the plain
  reference; each check is the largest over the ranks, and ``correct``
  is false where a rank kept nothing or a check passes its limit.
* Which rank prints.  Rank 0 makes the result and hands it to the
  launcher, which prints the checks on standard error and the result
  line last on standard output once every rank has reported every run
  and has ended, and exits 3 instead where any rank, or the launcher,
  loaded JAX or the JAX package.
* Timeouts.  A rank that raises or dies, or a run still going
  ``ranks.DEADLINE_S`` seconds past ``--seconds``, ends every rank
  (SIGTERM, then SIGKILL); the launcher waits for each and exits 1 with
  no result, naming the phase each rank had reached.  A rank exits
  without the interpreter's clean-up once the launcher has heard from
  every rank that it is done, so that no teardown of the groups can hold
  a run past its end.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parent.parent / "build" / "portbench"


def _card(device_index: int) -> str:
    """The card's name and power limit, for the record."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every compiler cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        (CACHE / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(CACHE / sub)

    from . import spec

    cell = spec.resolve(args.workload)
    if cell.chips > 1:
        return _over_ranks(cell, args)

    import torch

    from . import harness

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {have}; not measuring", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, T0)
    found = spec.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    result["info"]["card"] = _card(device.index)
    return _report(result)


def _over_ranks(cell, args) -> int:
    """The cell over ``cell.chips`` rank processes, one card each; this
    process imports neither PyTorch nor the program."""
    from . import ranks, spec
    got = {}
    rc = ranks.launch(cell, [(args.seed, None)], args.seconds,
                      bool(args.trace), T0,
                      on_result=lambda i, r, found: got.update(r=r, f=found))
    if rc:
        return rc
    found = sorted(set(got["f"]) | set(spec.forbidden_modules(sys.modules)))
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    got["r"]["info"]["card"] = [_card(i) for i in range(cell.chips)]
    return _report(got["r"])


def _report(result) -> int:
    """The run's record and checks on standard error, then the result
    line, last on standard output."""
    print(json.dumps(result["info"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
