"""Generic sharded row-column scheme: any separable 2-D transform.

Counterpart of ``cfftpack_tpu/parallel/rowcol.py``: a last-axis
transform over the rows of this rank's (..., n0/D, n1) block, the tiled
all-to-all to column blocks, the column transform (the last-axis
callable on the transposed block), and the all-to-all back; two
all-to-alls, of real tensors for the DCT/DST.
"""
from __future__ import annotations

from functools import partial

from ..config import DEFAULT_NORM, check_norm
from ..ops.dct import dct, dst, idct, idst
from ._comm import all_to_all_tiled, axis_size, on_mesh

__all__ = ["rowcol2d_sharded", "dctn2_sharded", "idctn2_sharded",
           "dstn2_sharded", "idstn2_sharded"]


def rowcol2d_sharded(x, mesh, row_fn, col_fn=None,
                     axis_name: str = "data",
                     batch_axis_name: str | None = None):
    """Apply last-axis transforms to both trailing axes of this rank's
    (..., n0/D, n1) block, rows sharded over ``mesh[axis_name]``.

    ``row_fn``/``col_fn`` take and return a tensor, transforming the
    LAST axis (col_fn defaults to row_fn).  The same rows come back.
    """
    col_fn = row_fn if col_fn is None else col_fn
    x = on_mesh(x, mesh)
    if batch_axis_name is not None:
        axis_size(mesh, batch_axis_name)          # the axis must exist
    d = axis_size(mesh, axis_name)
    n0, n1 = x.shape[-2] * d, x.shape[-1]
    if n1 % d:
        raise ValueError(f"2-D shape ({n0},{n1}) must be divisible by mesh "
                         f"size {d}")
    group = mesh.get_group(axis_name)
    a = all_to_all_tiled(row_fn(x), group, -1, -2)     # (..., n0, n1/D)
    a = col_fn(a.transpose(-1, -2)).transpose(-1, -2)
    return all_to_all_tiled(a, group, -2, -1)


def _trig(fn, t: int, norm: str):
    return partial(fn, type=int(t), axis=-1, norm=check_norm(norm))


def dctn2_sharded(x, mesh, type: int = 3, norm: str = DEFAULT_NORM,
                  axis_name: str = "data",
                  batch_axis_name: str | None = None):
    """Sharded 2-D DCT over the trailing axes (type 3 == the reference's
    dct_2d_forward convention)."""
    return rowcol2d_sharded(x, mesh, _trig(dct, type, norm),
                            axis_name=axis_name,
                            batch_axis_name=batch_axis_name)


def idctn2_sharded(x, mesh, type: int = 3, norm: str = DEFAULT_NORM,
                   axis_name: str = "data",
                   batch_axis_name: str | None = None):
    return rowcol2d_sharded(x, mesh, _trig(idct, type, norm),
                            axis_name=axis_name,
                            batch_axis_name=batch_axis_name)


def dstn2_sharded(x, mesh, type: int = 3, norm: str = DEFAULT_NORM,
                  axis_name: str = "data",
                  batch_axis_name: str | None = None):
    return rowcol2d_sharded(x, mesh, _trig(dst, type, norm),
                            axis_name=axis_name,
                            batch_axis_name=batch_axis_name)


def idstn2_sharded(x, mesh, type: int = 3, norm: str = DEFAULT_NORM,
                   axis_name: str = "data",
                   batch_axis_name: str | None = None):
    return rowcol2d_sharded(x, mesh, _trig(idst, type, norm),
                            axis_name=axis_name,
                            batch_axis_name=batch_axis_name)
