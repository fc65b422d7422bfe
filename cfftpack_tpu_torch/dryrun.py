"""The distributed pipeline on n ranks, one step each leg, with its
collective budgets: the counterpart of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py``).

    python -m cfftpack_tpu_torch.dryrun 4 cpu     # four gloo ranks
    python -m cfftpack_tpu_torch.dryrun 1         # one NCCL rank

Mesh (dp, tp) = (n/2, 2) when n is even and at least 4, else (1, n);
"data" shards the batch, "model" the transform.  Legs: the 2^16 filtered
four-step pipeline (``reorder=False``, the filter reshaped k2-major and
transposed to the spectrum's layout) and the same with
``overlap_chunks=2``, the 512^2 and 2048^2 sharded 2-D round trips, the
80-strike ladder, the mesh-wide Asian QMC at 4096 samples and the
float64 FFT on (4, 60); each checked at the JAX dry run's bar, its
collectives counted.
"""
from __future__ import annotations

import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from .models import asian_option_qmc_device, bs_cf, conv_option_price
from .ops import fft, fft_hp, ifft
from .parallel import (fft2_sharded, fft_fourstep, ifft2_sharded,
                       ifft_fourstep, init_distributed, make_mesh)
from .parallel._comm import count_collectives, mesh_device, shard
from .parallel.fourstep_split import _split
from .utils import black_scholes_option

__all__ = ["dryrun_multichip"]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _budget(cc: dict, n_a2a: int, what: str) -> None:
    _check(cc["all_to_all_single"] == n_a2a,
           f"{what}: expected {n_a2a} all-to-all, counted "
           f"{cc['all_to_all_single']}")
    for coll in ("all_reduce", "reduce_scatter_tensor"):
        _check(cc[coll] == 0, f"{what}: unexpected {coll}")


def _slab(x, n1: int, n2: int, mesh):
    """This rank's block of a (batch, n) signal: batch rows over "data",
    the column slab of its (N1, N2) view over "model"."""
    b = x.shape[0]
    x = shard(x.reshape(b, n1, n2), mesh, ("data",))
    x = shard(x.transpose(0, 2), mesh, ("model",)).transpose(0, 2)
    return x.reshape(x.shape[0], -1)


def _complex(rng, shape):
    return (rng.standard_normal(shape, dtype=np.float32)
            + 1j * rng.standard_normal(shape, dtype=np.float32)
            ).astype(np.complex64)


def _run(n_devices: int, device: str) -> dict:
    if n_devices % 2 == 0 and n_devices >= 4:
        dp, tp = n_devices // 2, 2
    else:
        dp, tp = 1, n_devices
    mesh = make_mesh((dp, tp), ("data", "model"), devices=device)
    dev = mesh_device(mesh)
    r = np.random.default_rng(0)

    batch, n = 2 * dp, 1 << 16     # the BASELINE configs[2] class
    x = torch.from_numpy(_complex(r, (batch, n))).to(dev)
    phi = torch.from_numpy(np.exp(1j * r.standard_normal(n))
                           .astype(np.complex64)).to(dev)
    n1, n2 = _split(n, tp)
    xb = _slab(x, n1, n2, mesh)
    # reorder=False holds X[k1 + n1*k2] at [k1, k2]: the filter is
    # reshaped k2-major, transposed, and cut to this rank's k1 rows
    fb = shard(phi.reshape(n2, n1).T, mesh, ("model",))

    def step(chunks):
        spec = fft_fourstep(xb, mesh, axis_name="model", reorder=False,
                            batch_axis_name="data", overlap_chunks=chunks)
        return ifft_fourstep(spec * fb, mesh, axis_name="model",
                             reordered=False, batch_axis_name="data",
                             overlap_chunks=chunks)

    with count_collectives() as cc:
        out = step(1)
    _budget(cc, 2, "fourstep fwd+inv")          # one transpose each way
    with count_collectives() as cc:
        out_ov = step(2)
    _budget(cc, 4, "fourstep overlap_chunks=2 fwd+inv")
    err_ov = float((out_ov - out).abs().max())
    _check(err_ov < 5e-6, f"overlap pipeline vs unchunked {err_ov}")
    want = _slab(ifft(fft(x) * phi[None]), n1, n2, mesh)
    err = float((out - want).abs().max())
    _check(err < 1e-5, f"four-step filtered-pipeline error {err}")

    def round_trip(img, what):
        blk = shard(shard(img, mesh, ("data",)).transpose(0, 1), mesh,
                    ("model",)).transpose(0, 1)
        with count_collectives() as cc:
            s = fft2_sharded(blk, mesh, axis_name="model",
                             batch_axis_name="data")
            back = ifft2_sharded(s, mesh, axis_name="model",
                                 batch_axis_name="data")
        _budget(cc, 4, what)                    # two transposes each way
        e = float((back - blk).abs().max())
        _check(e < 1e-5, f"{what} roundtrip error {e}")
        return e

    err2 = round_trip(torch.from_numpy(_complex(r, (batch, 512, 512)))
                      .to(dev), "sharded 512^2 2-D fwd+inv")
    # the BASELINE configs[3] class (4096^2, batch 64) at 2048^2
    err2d_big = round_trip(torch.from_numpy(_complex(r, (dp, 2048, 2048)))
                           .to(dev), "sharded 2048^2 2-D fwd+inv")

    strikes = np.arange(80.0, 120.0, 0.5)        # 80 strikes
    with count_collectives() as cc:
        ladder = conv_option_price(
            100.0, strikes, 0.25, 0.03, lambda u: bs_cf(u, 0.25, 0.2, 0.03),
            n=4096, grid_sigma=0.2, mesh=mesh)
    _check(cc["all_gather_into_tensor"] == 1,
           f"ladder: expected one all_gather_into_tensor, counted {cc}")
    bs = black_scholes_option(100.0, strikes, 0.2, 0.25, 0.03, True)
    err3 = float(np.abs(ladder - bs).max())
    _check(err3 < 5e-3, f"sharded pricer error vs closed form {err3}")

    # the shards draw the single-device call's Halton point set
    q1 = asian_option_qmc_device(samples=4096, device=dev)
    with count_collectives() as cc:
        qn = asian_option_qmc_device(samples=4096, mesh=mesh)
    _check(cc["all_reduce"] == 1,
           f"QMC: expected one all_reduce, counted {cc}")
    err4 = abs(q1 - qn)
    _check(err4 < 1e-6, f"sharded QMC vs single-device {err4}")

    xd = r.standard_normal((4, 60)) + 1j * r.standard_normal((4, 60))
    ref = np.fft.fft(xd)
    got = fft_hp(torch.from_numpy(xd).to(dev), norm="backward").cpu().numpy()
    err5 = float(np.abs(got - ref).max() / np.abs(ref).max())
    _check(err5 < 5e-14, f"float64 FFT vs numpy {err5}")

    res = {"mesh": {"data": dp, "model": tp}, "filtered": err,
           "overlap": err_ov, "fft2_512": err2, "fft2_2048": err2d_big,
           "ladder": err3, "qmc": err4, "hp": err5}
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}) on {device}: mesh "
              f"{res['mesh']} ok; 2^16 fourstep (2 a2a) + overlap_chunks=2 "
              f"(4 a2a, err {err_ov:.2e}) + 512x512 sharded-2D (4 a2a) + "
              f"2048x2048 sharded-2D (4 a2a, err {err2d_big:.2e}) + "
              f"{len(strikes)}-strike sharded pricer + mesh-wide QMC + "
              f"float64 FFT (err {err5:.2e}); errs {err:.2e} / {err2:.2e} "
              f"/ {err3:.2e} / {err4:.2e}", flush=True)
    return res


def _rank_main(rank: int, n_devices: int, device: str, port: int, queue):
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", n_devices, rank, device=device)
    try:
        res = _run(n_devices, device)
        if rank == 0:
            queue.put(res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the distributed pipeline on ``n_devices`` ranks and check it;
    returns rank 0's errors.  In place when the process group already
    has ``n_devices`` ranks (every rank calls it); otherwise it spawns
    them (``torch.multiprocessing``, a free localhost port) on
    ``device`` ("cuda": NCCL, one card a rank; "cpu": gloo)."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the process group has "
                             f"{dist.get_world_size()} ranks, not "
                             f"{n_devices}")
        return _run(n_devices, device)
    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} NCCL ranks need {n_devices} cards, "
                         f"have {torch.cuda.device_count()}")
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    # rank 0's one small message fits the pipe, so joining first is safe
    torch.multiprocessing.spawn(_rank_main, nprocs=n_devices, args=(
        n_devices, device, _free_port(), queue))
    return queue.get()


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
