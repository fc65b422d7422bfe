"""Spectrum shifts: fftshift / ifftshift (even and odd lengths).

Counterpart of ``cfftpack_tpu/ops/shift.py``, numpy semantics: fftshift
rolls by +n//2 (DC to the center), ifftshift by -(n//2); for odd n the
two differ.  One ``torch.roll`` per axis, any dtype, on the tensor's
device.
"""
from __future__ import annotations

import torch

from ..config import as_tensor

__all__ = ["fftshift", "ifftshift"]


def _axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        return (axes,)
    return tuple(int(a) for a in axes)


def fftshift(x, axes=None):
    x = as_tensor(x)
    for ax in _axes(x, axes):
        x = torch.roll(x, x.shape[ax] // 2, dims=ax)
    return x


def ifftshift(x, axes=None):
    x = as_tensor(x)
    for ax in _axes(x, axes):
        x = torch.roll(x, -(x.shape[ax] // 2), dims=ax)
    return x
