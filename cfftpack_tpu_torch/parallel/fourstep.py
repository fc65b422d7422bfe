"""Distributed four-step FFT on complex tensors.

Counterpart of ``cfftpack_tpu/parallel/fourstep.py``: the complex entry
points over the schedule of :mod:`.fourstep_split`, whose docstring
gives the algorithm, the blocks each rank holds and the collectives.
"""
from __future__ import annotations

import torch

from ..config import DEFAULT_NORM, check_norm, complex_dtype_of
from ._comm import on_mesh
from .fourstep_split import _fourstep_pair

__all__ = ["fft_fourstep", "ifft_fourstep"]


def _complex(x, mesh, inverse: bool, norm: str, natural: bool,
             batch_axis_name, overlap_chunks: int, axis_name: str):
    x = on_mesh(x, mesh)
    x = x.to(complex_dtype_of(x.dtype))
    return torch.complex(*_fourstep_pair(
        x.real, x.imag, mesh, axis_name, inverse, check_norm(norm),
        bool(natural), batch_axis_name, int(overlap_chunks)))


def fft_fourstep(x, mesh, axis_name: str = "data",
                 norm: str = DEFAULT_NORM, reorder: bool = True,
                 batch_axis_name: str | None = None,
                 overlap_chunks: int = 1):
    """Forward FFT over the last axis, length sharded across the mesh:
    this rank's column slab (..., n/D) in.

    ``reorder=False`` returns the (..., N1/D, N2) four-step block (k1
    sharded), with one all-to-all; compose with :func:`ifft_fourstep`
    (``reordered=False``) for transform -> pointwise -> inverse pipelines
    with no other transpose.  ``reorder=True`` returns the rank's
    contiguous 1/D chunk of the natural order, one more all-to-all.

    ``overlap_chunks=C`` (C > 1) tiles the exchange into C all-to-alls,
    each issued before the row pass of the chunk before it.  The same
    butterflies and twiddles: bit-identical results on the CPU; requires
    N1 % (C*D) == 0.
    """
    return _complex(x, mesh, False, norm, reorder, batch_axis_name,
                    overlap_chunks, axis_name)


def ifft_fourstep(y, mesh, axis_name: str = "data",
                  norm: str = DEFAULT_NORM, reordered: bool = True,
                  batch_axis_name: str | None = None,
                  overlap_chunks: int = 1):
    """Inverse of :func:`fft_fourstep`: the (..., N1/D, N2) block
    (``reordered=False``) or the natural chunk (``reordered=True``) in,
    this rank's column slab (..., n/D) out.  ``overlap_chunks`` as in
    :func:`fft_fourstep`, over N2."""
    return _complex(y, mesh, True, norm, reordered, batch_axis_name,
                    overlap_chunks, axis_name)
