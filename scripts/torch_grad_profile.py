"""Device time of each kernel's forward and of its forward with the
backward (the adjoint on the same kernels), on one CUDA card, for this
checkout or another one.

    python3 scripts/torch_grad_profile.py [--root DIR] [--only K3,K4]

Imports ``cfftpack_tpu_torch`` and ``chip_smoke.py`` from DIR (default:
this checkout) and takes the kernel rows of ``chip_smoke.grad_rows`` (the
shapes of PERF.md §6, as phase 36 of the smoke runs them).  With
``torch.profiler`` (``chip_smoke.profile_route``: kernel rows only, after
3 warm-up calls) it prints, for each row, the forward alone and the
forward with its backward (``torch.autograd.grad`` of a random
cotangent): the device time and kernel rows a call by kernel, the
CUDA-event time and the idle share, with the card's name and power
limit; then the same for the flagship step at batch 4096 and
``rfilter_split`` at (64, 65536) with the filter's gradient.  ``--only``
keeps the rows whose name starts with one of the given prefixes.
Profiler sessions live here and not in the smoke: in one process, a
session before the smoke's phase 25 made its later traces lose kernel
rows.  Needs the card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package and chip_smoke.py to use")
    ap.add_argument("--only", default="",
                    help="comma-separated prefixes of the rows to profile")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_grad_profile: no CUDA device")
    import chip_smoke as cs
    import cfftpack_tpu_torch as ct
    from cfftpack_tpu_torch.entry import entry
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; tree {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    prefixes = tuple(p for p in args.only.split(",") if p)
    rows = [(name, shape, xs, fn)
            for name, shape, xs, fn, *_ in cs.grad_rows()
            if not prefixes or name.startswith(prefixes)]
    step, sargs = entry("cuda", batch=4096)
    x = cs.real((64, 65536), torch.float32, seed=390)
    fr, fi = cs.packed_filter(65536, seed=391)
    rows += [("flagship step d/d(v, phi_r, phi_i)", (4096, 960),
              list(sargs), step),
             ("rfilter_split d/d(x, fr, fi)", (64, 65536), [x, fr, fi],
              lambda v, p, q: ct.rfilter_split(v, p, q))]
    for name, shape, xs, fn in rows:
        cots = cs.cotangents(fn, xs)
        ls = cs.leaves(xs)
        cs.profile_route(f"{name} {shape} forward", lambda: fn(*xs), card)
        cs.profile_route(
            f"{name} {shape} forward and backward",
            lambda: torch.autograd.grad(cs.as_tuple(fn(*ls)), ls, cots),
            card)
        del cots, ls


if __name__ == "__main__":
    main()
