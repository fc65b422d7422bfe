"""Read the numbers the correctness check compares, over many seeds in
one process: the program's, and the control's (the plain reference in
the precision below the configuration's, put in the program's place).
The limits in ``limits/<cell>.json`` are set from these readings.

    python3 -m portbench.calibrate --workload conv960.book \\
        --seeds 101-112 --control-seeds 201-203 --seconds 2

One JSON line a run on standard output, with the time it was made
("at", seconds since the epoch) and the run's record ("info").  Needs
the card, as a run does; the benchmark's own runs never run this.  A
cell of several chips runs through the launcher of ``run.py``
(``ranks.launch``): its ranks start once and make every run in turn,
each agreed and checked as a run of the cell is.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time


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

    from . import harness, ranks, spec
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench.calibrate: {cell.name} needs {cell.chips} CUDA "
              "card(s)", file=sys.stderr)
        return 2
    kinds = (["program"] * len(args.seeds)
             + ["control"] * len(args.control_seeds))
    seeds = args.seeds + args.control_seeds

    def line(i, r, found=()):
        print(json.dumps({"workload": cell.name, "seed": seeds[i],
                          "kind": kinds[i], "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": {k: c["value"]
                                     for k, c in r["checks"].items()},
                          "metrics": {k: m["value"]
                                      for k, m in r["metrics"].items()},
                          "memory_peak_bytes":
                              r["device"]["memory_peak_bytes"],
                          "device": r["device"]["kind"],
                          "count": r["device"]["count"],
                          "jax_loaded": list(found),
                          "at": time.time(), "info": r["info"]}),
              flush=True)

    if cell.chips > 1:
        runs = [(s, None if k == "program" else ranks.control)
                for s, k in zip(seeds, kinds)]
        return ranks.launch(cell, runs, args.seconds, False,
                            harness.clock(),
                            deadline_s=len(runs) * (args.seconds + 120)
                            + ranks.DEADLINE_S, on_result=line)
    device = torch.device("cuda", 0)
    ref = spec.load_module(cell.reference, "reference")
    for i, kind in enumerate(kinds):
        program = (ref.control(cell.sizes, cell.traffic)
                   if kind == "control" else None)
        r = harness.run_cell(cell, seeds[i], args.seconds, False, device,
                             harness.clock(), program=program)
        line(i, r)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
