"""Where the parallel layer's time goes at world size 1 on one CUDA card,
for this checkout or another one.

    python3 scripts/torch_parallel_profile.py [--root DIR] [--grad]

Imports ``cfftpack_tpu_torch`` and ``chip_smoke.py`` from DIR (default:
this checkout), opens a one-rank NCCL group and, with ``torch.profiler``
(``chip_smoke.profile_route``: kernel rows only, after 3 warm-up calls),
prints the device time by kernel, the kernel rows a call, the CUDA-event
time and the idle share of the four-step (``fft_fourstep_split`` at
(64, 2^20) float32 planes, forward without and with the natural order,
the inverse) beside the single-device ``fft_split`` (K5), and of
``fft2_sharded_split`` at (64, 4096, 4096) beside ``fft2_split``, with
the card's name and power limit.  ``--grad`` profiles instead the rows
of the smoke's phase 37 (``chip_smoke.par_grad_rows``: the four-step at
(64, 2^20), ``fft2_sharded_split`` and ``rfft2_sharded_split`` at
(16, 4096, 4096), ``dctn2_sharded`` at (64, 1024, 1024)), each forward
alone and forward with its backward (``torch.autograd.grad`` of a random
cotangent).  Needs the card.
"""
from __future__ import annotations

import argparse
import socket
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package and chip_smoke.py to use")
    ap.add_argument("--grad", action="store_true",
                    help="profile phase 37's rows forward and backward")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        sys.exit("torch_parallel_profile: no CUDA device")
    import chip_smoke as cs
    import cfftpack_tpu_torch as ct
    from cfftpack_tpu_torch import parallel as par
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; tree {root}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    par.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = par.make_mesh((1,), ("data",))
        if args.grad:
            profile_grad(cs, par, mesh, card)
            return
        xr, xi = cs.pair((64, 1 << 20), torch.float32, seed=360)
        yr, yi = par.fft_fourstep_split(xr, xi, mesh, reorder=False)
        for name, fn in (
                ("fft_fourstep_split reorder=False (64, 2^20)",
                 lambda: par.fft_fourstep_split(xr, xi, mesh, reorder=False)),
                ("fft_fourstep_split reorder=True (64, 2^20)",
                 lambda: par.fft_fourstep_split(xr, xi, mesh)),
                ("ifft_fourstep_split reordered=False (64, 2^20)",
                 lambda: par.ifft_fourstep_split(yr, yi, mesh,
                                                 reordered=False)),
                ("single-device fft_split (64, 2^20) (K5)",
                 lambda: ct.fft_split(xr, xi))):
            cs.profile_route(name, fn, card, calls=10)
        del xr, xi, yr, yi
        torch.cuda.empty_cache()
        xr, xi = cs.pair((64, 4096, 4096), torch.float32, seed=361)
        for name, fn in (
                ("fft2_sharded_split (64, 4096, 4096)",
                 lambda: par.fft2_sharded_split(xr, xi, mesh)),
                ("single-device fft2_split (64, 4096, 4096)",
                 lambda: ct.fft2_split(xr, xi))):
            cs.profile_route(name, fn, card, calls=3)
    finally:
        dist.destroy_process_group()


def profile_grad(cs, par, mesh, card: str) -> None:
    """Each row of phase 37 forward, then forward and backward."""
    import torch
    for name, xs, fn, *_ in cs.par_grad_rows(par, mesh):
        cots = cs.cotangents(fn, xs)
        ls = cs.leaves(xs)
        calls = 3 if "4096, 4096" in name else 10
        cs.profile_route(f"{name} forward", lambda: fn(*xs), card, calls)
        cs.profile_route(
            f"{name} forward and backward",
            lambda: torch.autograd.grad(cs.as_tuple(fn(*ls)), ls, cots),
            card, calls)
        del xs, cots, ls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
