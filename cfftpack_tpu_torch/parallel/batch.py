"""Batch-sharded transforms: shard the leading axis, transform per row.

Counterpart of ``cfftpack_tpu/parallel/batch.py``.  Each rank runs the
single-device entry point on its block of the batch; there is no
collective at all.  :func:`shard_batch` cuts a rank's block out of the
global batch.
"""
from __future__ import annotations

import torch

from .. import ops
from ._comm import mesh_device, shard

__all__ = ["shard_batch", "pfft", "pifft", "prfft", "pirfft", "pdct"]


def shard_batch(x, mesh, axis: str = "data"):
    """This rank's block of ``x`` with the leading axis sharded over
    ``mesh[axis]``, on the rank's device; the leading axis must be
    divisible by the axis size (``ValueError``)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return shard(x, mesh, (axis,)).to(mesh_device(mesh))


def pfft(x, mesh, axis: str = "data", **kw):
    """Batch-sharded forward complex FFT over the last axis of this
    rank's block (``shard_batch``); keywords as :func:`ops.fft`."""
    return ops.fft(x, **kw)


def pifft(x, mesh, axis: str = "data", **kw):
    return ops.ifft(x, **kw)


def prfft(x, mesh, axis: str = "data", **kw):
    return ops.rfft(x, **kw)


def pirfft(x, n: int, mesh, axis: str = "data", **kw):
    return ops.irfft(x, n=n, **kw)


def pdct(x, type: int, mesh, axis: str = "data", **kw):
    return ops.dct(x, type=type, **kw)
