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

    import torch

    from . import harness, spec

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {have}; not measuring", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, T0)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    result["info"]["card"] = _card(device.index)
    print(json.dumps(result["info"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
