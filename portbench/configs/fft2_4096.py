"""fft2_4096: the sharded forward 2-D FFT,
``cfftpack_tpu_torch.parallel.fft2_sharded_split``, of the configuration's
images over its ranks, rows sharded: this rank's (images, n0/ranks, n1)
block of re and im float32 planes in, the same rows of the spectrum out,
FFTPACK scaling.  A run over several ranks joins the program's group
before this module is used (``ranks.py``).

Inputs: the rank-r rows of image b on ring slot s are one standard normal
draw of shape (2, n0/ranks, n1), re then im, from the generator of (seed,
s, b, r) (``seeded.py``), so that the reference draws any image again on
its own."""
from __future__ import annotations

import torch
import torch.distributed as dist

from cfftpack_tpu_torch import parallel
from portbench import seeded


def world(sizes) -> tuple[int, int]:
    """(rank, ranks) of the run, which has to have the configuration's
    number of ranks."""
    rank, d = dist.get_rank(), dist.get_world_size()
    if d != sizes["ranks"]:
        raise ValueError(f"the configuration shards over {sizes['ranks']} "
                         f"ranks; the run has {d}")
    return rank, d


def make_inputs(sizes, traffic, gen, device):
    rank, d = world(sizes)
    seed = gen.initial_seed()
    rows, n1, images = sizes["n0"] // d, sizes["n1"], sizes["images"]
    out = {"xr": [], "xi": [], "seed": seed, "rank": rank, "ranks": d}
    for s in range(traffic["ring"]):
        xr = torch.empty((images, rows, n1), device=device)
        xi = torch.empty_like(xr)
        for b in range(images):
            xr[b], xi[b] = seeded.normal((2, rows, n1), device, seed, s, b,
                                         rank)
        out["xr"].append(xr)
        out["xi"].append(xi)
    return out


def program(sizes, traffic):
    mesh = parallel.local_mesh(
        devices="cuda" if dist.get_backend() == "nccl" else "cpu")
    norm = sizes["norm"]

    def call(inputs, slot):
        return parallel.fft2_sharded_split(inputs["xr"][slot],
                                           inputs["xi"][slot], mesh,
                                           norm=norm)
    return call
