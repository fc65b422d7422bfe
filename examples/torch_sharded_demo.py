"""Distribution-layer demo on cfftpack_tpu_torch: every sharded API on
one device mesh, each with a parity line against the single-device call.

The counterpart of examples/sharded_demo.py, one process a rank over
``torch.distributed``.  Shows, at the JAX demo's shapes:
  * zero-collective batch data parallelism          (parallel.pfft)
  * one-all-to-all four-step long-transform split   (fft_fourstep)
  * sharded 2-D row-column FFT, complex + real      (fft2/rfft2_sharded)
  * sharded 2-D DCT                                 (dctn2_sharded)
  * mesh-sharded strike-ladder pricer               (conv_option_price)
  * mesh-wide Monte-Carlo sampling                  (asian/vg mc, mesh=)

Every function of ``cfftpack_tpu_torch.parallel`` takes and returns this
rank's block; the demo cuts each global input into the rank's block,
gathers the outputs and prints on rank 0 the error against the
single-device port call on the same device.

Run:
  python examples/torch_sharded_demo.py                 # one NCCL rank a card
  python examples/torch_sharded_demo.py --device cpu    # 8 gloo ranks
  python examples/torch_sharded_demo.py --device cpu --ranks 2 --dtype float64
  torchrun --nproc-per-node 2 examples/torch_sharded_demo.py --device cpu

A caller that has already joined a process group (``init_distributed``)
calls :func:`main` on every rank: the demo runs on that group and leaves
it as it found it.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import cfftpack_tpu_torch as ct  # noqa: E402
from cfftpack_tpu_torch import parallel as par  # noqa: E402
from cfftpack_tpu_torch.dryrun import _free_port  # noqa: E402
from cfftpack_tpu_torch.models import (asian_option_qmc_device,  # noqa: E402
                                       bs_cf, conv_option_price,
                                       vg_mc_price_device)
from cfftpack_tpu_torch.parallel._comm import mesh_device, shard  # noqa: E402
from cfftpack_tpu_torch.parallel.fourstep_split import _split  # noqa: E402
from cfftpack_tpu_torch.utils import black_scholes_option  # noqa: E402

PFFT_SHAPE, FOURSTEP_N = (16, 1024), 4096
FFT2_SHAPE, REAL2_SHAPE = (64, 64), (64, 48)
STRIKES = np.arange(85.0, 115.0, 1.0)          # 30 strikes
QMC_SAMPLES, VG_SAMPLES = 4096, 400000
VG_ANCHOR = 9.342466                           # QuantLib (vargammaql.cpp)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def check_ranks(d: int) -> None:
    """D must divide every sharded axis of the demo: the 16 rows of
    pfft, the 64 rows of the 2-D inputs and the 48 columns of the row
    DCT's exchange, both factors of 4096's four-step split, and the
    4096 QMC and 400000 VG samples."""
    if d < 1:
        raise ValueError(f"ranks must be at least 1, got {d}")
    sizes = (PFFT_SHAPE[0], FFT2_SHAPE[0], REAL2_SHAPE[0], REAL2_SHAPE[1],
             FOURSTEP_N, QMC_SAMPLES, VG_SAMPLES)
    bad = sorted({s for s in sizes if s % d})
    if not bad:
        try:
            _split(FOURSTEP_N, d)
        except ValueError:
            bad = [FOURSTEP_N]
    if bad:
        raise ValueError(f"{d} ranks do not divide the demo's sharded "
                         f"sizes {bad}; use a D that divides 16, 48, 64, "
                         f"4096 and 400000 (1, 2, 4, 8 or 16)")


def _gather(block):
    """The blocks of every rank, concatenated along axis 0."""
    block = block.contiguous()
    if block.is_complex():
        return torch.view_as_complex(_gather(torch.view_as_real(block)))
    out = block.new_empty((dist.get_world_size() * block.shape[0],)
                          + block.shape[1:])
    dist.all_gather_into_tensor(out, block)
    return out


def _err(got, want) -> tuple[float, float]:
    """(max |got - want|, the same over max |want|)."""
    err = float((torch.as_tensor(got) - torch.as_tensor(want)).abs().max())
    return err, err / float(torch.as_tensor(want).abs().max())


def run(mesh, dtype: torch.dtype = torch.float32) -> dict:
    """Every sharded API on ``mesh`` (1-D, axis "data"); every rank calls
    it.  Returns {line: (abs error, error / max |X|)} and the mesh
    prices; rank 0 prints the lines."""
    dev = mesh_device(mesh)
    d = mesh.size()
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    r = np.random.default_rng(0)

    def cplx(shape):
        x = r.standard_normal(shape) + 1j * r.standard_normal(shape)
        return torch.from_numpy(x).to(dev, cdt)

    rows = {}
    x = cplx(PFFT_SHAPE)
    got = _gather(par.pfft(par.shard_batch(x, mesh), mesh))
    rows["batch-DP fft"] = _err(got, ct.fft(x))

    v = cplx((FOURSTEP_N,))
    n1, n2 = _split(FOURSTEP_N, d)
    # the rank's column slab of the (N1, N2) view in, its natural chunk out
    slab = shard(v.reshape(n1, n2).T, mesh, ("data",)).T.reshape(-1)
    got = _gather(par.fft_fourstep(slab, mesh))
    rows["four-step 1-D"] = _err(got, ct.fft(v))

    img = cplx(FFT2_SHAPE)
    got = _gather(par.fft2_sharded(shard(img, mesh, ("data",)), mesh))
    rows["sharded 2-D fft"] = _err(got, ct.fft2(img))

    real = torch.from_numpy(r.standard_normal(REAL2_SHAPE)).to(dev, dtype)
    blk = shard(real, mesh, ("data",))
    got = _gather(par.rfft2_sharded(blk, mesh))
    rows["sharded 2-D rfft"] = _err(got, ct.rfft2(real))
    got = _gather(par.dctn2_sharded(blk, mesh))
    rows["sharded 2-D dct"] = _err(got, ct.dctn(real, 3))

    def ladder(**kw):
        return conv_option_price(100.0, STRIKES, 0.25, 0.03,
                                 lambda u: bs_cf(u, 0.25, 0.2, 0.03),
                                 n=4096, grid_sigma=0.2, **kw)

    lad = ladder(mesh=mesh)
    rows["sharded pricer"] = _err(lad, ladder(device=dev))
    bs = black_scholes_option(100.0, STRIKES, 0.2, 0.25, 0.03, True)

    q1 = asian_option_qmc_device(samples=QMC_SAMPLES, device=dev)
    qn = asian_option_qmc_device(samples=QMC_SAMPLES, mesh=mesh)
    rows["mesh QMC asian"] = _err(qn, q1)

    # rank k draws VG_SAMPLES/D from the generator seeded k: the mean of
    # those D single-device runs is the mesh's estimate
    vn = vg_mc_price_device(samples=VG_SAMPLES, mesh=mesh)
    v1 = float(np.mean([vg_mc_price_device(samples=VG_SAMPLES // d, seed=k,
                                           device=dev) for k in range(d)]))
    rows["mesh VG MC"] = _err(vn, v1)

    if dist.get_rank() == 0:
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"devices: {d} x {name}; mesh {shape}; "
              f"{str(dtype).split('.')[1]}")
        notes = {"batch-DP fft": " (zero collectives)",
                 "four-step 1-D": " (one all-to-all)",
                 "sharded pricer": f" ({len(STRIKES)} strikes; vs closed "
                                   f"form {np.abs(lad - bs).max():.2e})",
                 "mesh QMC asian": f" {qn:.6f} (single-chip {q1:.6f}, same "
                                   "Halton set)",
                 "mesh VG MC": f" {vn:.6f} (QuantLib anchor {VG_ANCHOR})"}
        for line, (err, rel) in rows.items():
            print(f"{line:<18}err {err:.2e} rel {rel:.2e}"
                  f"{notes.get(line, '')}")
    return {"rows": rows, "qmc": (qn, q1), "vg": vn}


def _on_group(device: str, dtype: torch.dtype) -> dict:
    world = dist.get_world_size()
    check_ranks(world)
    return run(par.make_mesh((world,), ("data",), devices=device), dtype)


def _rank_main(rank: int, world: int, device: str, port: int, dtype, queue):
    if device == "cpu":
        torch.set_num_threads(1)
    par.init_distributed(f"127.0.0.1:{port}", world, rank, device=device)
    try:
        res = _on_group(device, dtype)
        if rank == 0:
            queue.put(res)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    """Run the demo; returns rank 0's result (every rank's, in place)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=None,
                    help="gloo ranks on the CPU (default 8) or NCCL ranks, "
                         "one a card (default: every card)")
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    args = ap.parse_args(argv)
    dtype = DTYPES[args.dtype]
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for gloo ranks")
    if dist.is_initialized():
        # a group the caller made: run on it, leave it to the caller
        if args.ranks not in (None, dist.get_world_size()):
            raise ValueError(f"the process group has "
                             f"{dist.get_world_size()} ranks, not "
                             f"{args.ranks}")
        return _on_group(args.device, dtype)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        par.init_distributed(device=args.device)    # torchrun's ranks
        try:
            return _on_group(args.device, dtype)
        finally:
            dist.destroy_process_group()
    d = args.ranks
    if d is None:
        d = 8 if args.device == "cpu" else torch.cuda.device_count()
    check_ranks(d)
    if args.device == "cuda" and d > torch.cuda.device_count():
        raise ValueError(f"{d} NCCL ranks need {d} cards, have "
                         f"{torch.cuda.device_count()}")
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    # rank 0's one small message fits the pipe, so joining first is safe
    torch.multiprocessing.spawn(_rank_main, nprocs=d, args=(
        d, args.device, _free_port(), dtype, queue))
    return queue.get()


if __name__ == "__main__":
    main()
