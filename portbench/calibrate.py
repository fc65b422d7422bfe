"""Read the numbers the correctness check compares, over many seeds in
one process: the program's, and the control's (the plain reference in
the precision below the configuration's, put in the program's place).
The limits in ``limits/<cell>.json`` are set from these readings.

    python3 -m portbench.calibrate --workload conv960.book \\
        --seeds 101-112 --control-seeds 201-203 --seconds 2

One JSON line a run on standard output.  Needs the card, as a run does;
the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys


def _seeds(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from . import harness, spec
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ref = spec.load_module(cell.reference, "reference")
    runs = [(s, "program", None) for s in args.seeds] + [
        (s, "control", ref.control(cell.sizes, cell.traffic))
        for s in args.control_seeds]
    for seed, kind, program in runs:
        r = harness.run_cell(cell, seed, args.seconds, False, device,
                             harness.clock(), program=program)
        print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": {k: c["value"]
                                     for k, c in r["checks"].items()},
                          "metrics": {k: m["value"]
                                      for k, m in r["metrics"].items()},
                          "memory_peak_bytes":
                              r["device"]["memory_peak_bytes"]}),
              flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
