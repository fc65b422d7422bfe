"""Batch-sharded float64 transforms.

Counterpart of ``cfftpack_tpu/parallel/hp.py``.  The JAX package runs a
double-float engine on its f64-less chips; the card has native FP64, so
these are the batch forms (:mod:`.batch`) in complex128/float64.  As in
the JAX package they take the whole batch (host or tensor), whose
leading axis must divide over ``mesh[axis]``; each rank transforms its
block (``shard_batch``) and returns it.  No collective.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_NORM, check_norm
from .batch import pfft, pifft, prfft, shard_batch

__all__ = ["pfft_hp", "pifft_hp", "prfft_hp"]


def _block(x, mesh, axis: str, dtype, name: str):
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    x = x.to(dtype)
    if x.ndim < 2:
        raise ValueError(f"{name}: need a batch axis to shard")
    return shard_batch(x, mesh, axis)


def pfft_hp(x, mesh, axis: str = "data", norm: str = DEFAULT_NORM):
    """Batch-sharded forward FFT in complex128 (any length): the whole
    batch in, this rank's block of the spectrum out."""
    return pfft(_block(x, mesh, axis, torch.complex128, "pfft_hp"), mesh,
                axis, norm=check_norm(norm))


def pifft_hp(y, mesh, axis: str = "data", norm: str = DEFAULT_NORM):
    return pifft(_block(y, mesh, axis, torch.complex128, "pifft_hp"), mesh,
                 axis, norm=check_norm(norm))


def prfft_hp(x, mesh, axis: str = "data", norm: str = DEFAULT_NORM):
    """Batch-sharded real FFT in float64: the whole real batch in, this
    rank's block of the packed (n//2+1) complex128 spectrum out."""
    return prfft(_block(x, mesh, axis, torch.float64, "prfft_hp"), mesh,
                 axis, norm=check_norm(norm))
