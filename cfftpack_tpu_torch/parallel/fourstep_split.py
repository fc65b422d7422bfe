"""Distributed four-step FFT on (re, im) planes: one long transform
sharded over a mesh axis.

Counterpart of ``cfftpack_tpu/parallel/fourstep_split.py`` and of the
schedule of ``fourstep.py`` (whose complex entry points wrap this one).
The length-n transform is an (N1, N2) matrix, x[j1*N2 + j2], with
``_split`` choosing the same (N1, N2) as the JAX package:

    forward, on the rank's column slab (..., N1, N2/D), j2 sharded:
    1. length-N1 DFT over axis -2 (K6 in the natural layout)
    2. twiddle e^{-2i pi k1 j2 / n}, j2 the global index
    3. tiled all-to-all: k1 sharded, j2 gathered -> (..., N1/D, N2)
    4. length-N2 DFT over the rows (K1), the norm in its store
    X[k1 + N1*k2] = out[k1, k2]  (k1 sharded)

The inverse mirrors it on the (N1/D, N2) spectrum block: rows first
(K1), the conjugate twiddle over the global k1 index, the all-to-all
back to column slabs, the column DFT (K6) with the norm in its store.

Blocks: the forward takes, and the inverse returns, the rank's column
slab of the natural-order input flattened, ``x.reshape(..., N1, N2)[...,
:, r*N2/D:(r+1)*N2/D]`` as (..., n/D) (the JAX ``in_specs``).  The
spectrum is the (..., N1/D, N2) block of the JAX ``out_specs``;
``reorder=True`` (``reordered=True``) returns (takes) the rank's
contiguous 1/D chunk of the natural-order spectrum instead, one more
all-to-all.  The leading axis may be a block of a batch sharded over
``batch_axis_name``.  ``overlap_chunks=C`` cuts the exchange into C
all-to-alls, chunk i carrying the i-th sub-slice of every rank's range;
each is issued asynchronously before the row pass of the one before it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import plan
from ..config import (DEFAULT_NORM, _as_real_plane, check_norm, fwd_scale,
                      inv_scale)
from ..ops import core
from ._comm import all_to_all_tiled, axis_index, axis_size, on_mesh

__all__ = ["fft_fourstep_split", "ifft_fourstep_split"]


@functools.lru_cache(maxsize=4096)
def _split(n: int, n_shards: int) -> tuple[int, int]:
    """N1*N2 == n with both factors divisible by the shard count and as
    square as possible: the JAX package's rule, on which the
    ``reorder=False`` layout depends."""
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            for n1 in (d, n // d):
                n2 = n // n1
                if n1 % n_shards == 0 and n2 % n_shards == 0:
                    score = abs(n1 - n2)
                    if best is None or score < best[0]:
                        best = (score, n1, n2)
        d += 1
    if best is None:
        raise ValueError(
            f"length {n} not splittable as N1*N2 with both divisible by "
            f"{n_shards} shards")
    return best[1], best[2]


def _check_chunks(n_split: int, d: int, overlap_chunks: int) -> int:
    c = int(overlap_chunks)
    if c < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {c}")
    if c > 1 and (n_split % c or (n_split // c) % d):
        raise ValueError(
            f"overlap_chunks={c}: N1={n_split} must split into chunks "
            f"divisible by the {d}-way mesh axis")
    return c


@functools.lru_cache(maxsize=16)
def _twiddle(n: int, rows: int, a0: int, cols: int, b0: int, sign: float,
             dtype, device):
    """e^{sign 2i pi (a0 + a)(b0 + b) / n} over (rows, cols), built in
    float64 from the exact product mod n."""
    a = np.arange(a0, a0 + rows, dtype=np.int64)[:, None]
    b = np.arange(b0, b0 + cols, dtype=np.int64)[None, :]
    ang = (sign * 2.0 * np.pi / n) * ((a * b) % n)
    return (plan.to_device(np.cos(ang), dtype, device),
            plan.to_device(np.sin(ang), dtype, device))


def _exchange(ar, ai, group, d: int, split: int, concat: int, c: int, fn):
    """All-to-all (split -> sharded, concat -> gathered) in ``c`` chunks,
    then ``fn`` on each chunk's planes; the results are concatenated
    along ``split``.  Chunk i is the i-th sub-slice of every rank's range
    of ``split``, so each rank's chunks assemble its range in order;
    chunk i + 1's collective is in flight while ``fn`` runs on chunk i.
    Under autograd each chunk's exchange is recorded when it is waited
    on, so the graph has ``c`` exchanges, each with its adjoint."""
    split %= ar.ndim
    w = ar.shape[split] // (c * d)

    def start(i):
        planes = tuple(p.unflatten(split, (d, c, w)).select(split + 1, i)
                       .flatten(split, split + 1) for p in (ar, ai))
        return all_to_all_tiled(planes, group, split, concat, async_op=True)

    pending = start(0)
    outs = []
    for i in range(c):
        wait = pending
        if i + 1 < c:
            pending = start(i + 1)
        outs.append(fn(*wait()))
    if c == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs], dim=split),
            torch.cat([o[1] for o in outs], dim=split))


def _twiddled(ar, ai, tw):
    twr, twi = tw
    return ar * twr - ai * twi, ar * twi + ai * twr


def _fourstep_pair(xr, xi, mesh, axis_name: str, inverse: bool, norm: str,
                   natural: bool, batch_axis_name, overlap_chunks: int = 1):
    """The schedule both ways.  Forward: ``natural`` is ``reorder``;
    inverse: ``reordered``."""
    name = "ifft_fourstep" if inverse else "fft_fourstep"
    xr = _as_real_plane(on_mesh(xr, mesh), name)
    xi = _as_real_plane(on_mesh(xi, mesh), name)
    if xr.shape != xi.shape:
        raise ValueError("re/im shapes differ")
    if xi.dtype != xr.dtype:
        xi = xi.to(xr.dtype)
    if batch_axis_name is not None:
        axis_size(mesh, batch_axis_name)          # the axis must exist
    d, r = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    run = _inverse if inverse else _forward
    return run(xr, xi, d, r, mesh.get_group(axis_name), norm, natural,
               overlap_chunks)


def _forward(xr, xi, d: int, r: int, group, norm: str, reorder: bool,
             overlap_chunks: int):
    lead = xr.shape[:-1]
    n = xr.shape[-1] * d
    n1, n2 = _split(n, d)
    c = _check_chunks(n1, d, overlap_chunks)
    w = n2 // d
    ar, ai = core.scaled_pass(xr.reshape(lead + (n1, w)),
                              xi.reshape(lead + (n1, w)), -2, False, 1.0)
    ar, ai = _twiddled(ar, ai, _twiddle(n, n1, 0, w, r * w, -1.0, ar.dtype,
                                        ar.device))
    s = fwd_scale(norm, n)
    yr, yi = _exchange(ar, ai, group, d, -2, -1, c,
                       lambda br, bi: core.sfft(br, bi, n2, False, s))
    if not reorder:
        return yr, yi                             # (..., N1/D, N2)
    # natural order: this rank's k2 range, all k1, k2-major
    yr, yi = all_to_all_tiled((yr, yi), group, -1, -2)
    return (yr.transpose(-1, -2).reshape(lead + (n // d,)),
            yi.transpose(-1, -2).reshape(lead + (n // d,)))


def _inverse(yr, yi, d: int, r: int, group, norm: str, reordered: bool,
             overlap_chunks: int):
    if reordered:
        # the contiguous natural chunk holds k2 in this rank's range
        lead = yr.shape[:-1]
        n = yr.shape[-1] * d
        n1, n2 = _split(n, d)
        yr = yr.reshape(lead + (n2 // d, n1)).transpose(-1, -2)
        yi = yi.reshape(lead + (n2 // d, n1)).transpose(-1, -2)
        yr, yi = all_to_all_tiled((yr, yi), group, -2, -1)
    else:
        lead = yr.shape[:-2]
        n1, n2 = yr.shape[-2] * d, yr.shape[-1]
        n = n1 * n2
    c = _check_chunks(n2, d, overlap_chunks)
    ar, ai = core.sfft(yr, yi, n2, True)
    ar, ai = _twiddled(ar, ai, _twiddle(n, n1 // d, r * (n1 // d), n2, 0,
                                        1.0, ar.dtype, ar.device))
    s = inv_scale(norm, n)
    xr, xi = _exchange(ar, ai, group, d, -1, -2, c,
                       lambda br, bi: core.scaled_pass(br, bi, -2, True, s))
    return xr.reshape(lead + (n // d,)), xi.reshape(lead + (n // d,))


def fft_fourstep_split(xr, xi, mesh, axis_name: str = "data",
                       norm: str = DEFAULT_NORM, reorder: bool = True,
                       batch_axis_name: str | None = None):
    """Forward four-step FFT on an (re, im) pair, length sharded over
    ``mesh[axis_name]``: this rank's column slab in, its spectrum block
    out (the module docstring gives both layouts)."""
    return _fourstep_pair(xr, xi, mesh, axis_name, False, check_norm(norm),
                          bool(reorder), batch_axis_name)


def ifft_fourstep_split(yr, yi, mesh, axis_name: str = "data",
                        norm: str = DEFAULT_NORM, reordered: bool = True,
                        batch_axis_name: str | None = None):
    """Inverse of :func:`fft_fourstep_split` (the mirrored schedule):
    this rank's spectrum block in, its column slab out."""
    return _fourstep_pair(yr, yi, mesh, axis_name, True, check_norm(norm),
                          bool(reordered), batch_axis_name)
