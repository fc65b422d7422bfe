"""The parallel layer's collectives and mesh arithmetic.

The JAX package's layer is single-controller SPMD: one global array, a
``Mesh`` and ``shard_map``.  The port is one process a rank: each rank
holds its own block of the global array (the JAX function's
``PartitionSpec`` at the rank's mesh coordinate) and the mesh is a
``torch.distributed.device_mesh.DeviceMesh``.

:func:`all_to_all_tiled` is the counterpart of
``jax.lax.all_to_all(..., tiled=True)`` and the one all-to-all of the
layer.  :func:`count_collectives` records the collectives a block of
code calls; its counts stand in for the JAX tests' budgets of
collectives in the compiled program.

Gradients.  A tiled all-to-all is a permutation of the global array, so
its adjoint is the tiled all-to-all with the two axes swapped (split
the concat axis, concatenate on the split axis, the same group).  When
autograd records the call (``ops._adjoint.needs_grad`` of the planes),
:func:`all_to_all_tiled` enters the ``torch.autograd.Function``
:class:`_AllToAll`, whose backward is that exchange: one more
``all_to_all_single`` a forward exchange, the tuple of planes in one
call, nothing saved, and a second derivative through the Function
again.  Otherwise it runs with no ``apply``, as before.  The received
planes are views of one receive buffer: under autograd they must not be
modified in place.  The package docstring gives the rules every rank of
a backward follows.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import _adjoint

__all__ = ["COLLECTIVES", "count_collectives", "all_to_all_tiled",
           "check_mesh", "axis_size", "axis_index", "linear_index",
           "all_axes_group", "mesh_device", "shard", "on_mesh"]

COLLECTIVES = ("all_to_all_single", "all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor")
_RECORDERS: list[dict] = []
_ORIGINAL = {}


def _counted(name: str, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        for rec in _RECORDERS:
            rec[name] += 1
        return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def count_collectives():
    """Count the calls of the four collectives in ``COLLECTIVES`` made
    inside the block, by anyone: ``torch.distributed``'s functions are
    replaced by counting ones while a counter is open.  Yields a dict
    from name to count, filled as the block runs."""
    rec = dict.fromkeys(COLLECTIVES, 0)
    if not _RECORDERS:
        for name in COLLECTIVES:
            _ORIGINAL[name] = getattr(dist, name)
            setattr(dist, name, _counted(name, _ORIGINAL[name]))
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS[:] = [r for r in _RECORDERS if r is not rec]
        if not _RECORDERS:
            for name in COLLECTIVES:
                setattr(dist, name, _ORIGINAL.pop(name))


def all_to_all_tiled(t, group, split_axis: int, concat_axis: int,
                     async_op: bool = False):
    """Tiled all-to-all over ``group`` of D ranks: chunk j of
    ``split_axis`` goes to rank j, and the chunk from rank j lands at
    position j of ``concat_axis``, as ``jax.lax.all_to_all(..., tiled=
    True)``.  ``t`` is a tensor or a tuple of same-shape planes, which
    travel in one ``all_to_all_single`` and come back as a tuple.

    The chunks move to dim 0 (``unflatten``/``movedim``) into one
    contiguous send buffer, then ``dist.all_to_all_single``, then back.
    With ``async_op=True`` it returns a function that waits for the
    collective and returns the result.  Under autograd the call is
    recorded as :class:`_AllToAll` (the module docstring gives the
    contract); with ``async_op=True`` it is applied inside that
    function, once the collective is waited on."""
    multi = not isinstance(t, torch.Tensor)
    planes = tuple(t) if multi else (t,)
    nd = planes[0].ndim
    split_axis %= nd
    concat_axis %= nd
    grad = _adjoint.needs_grad(*planes)
    # under grad the pack is not recorded: _AllToAll stands for it
    with torch.no_grad() if grad else contextlib.nullcontext():
        finish = _issue(planes, group, split_axis, concat_axis, async_op)

    def done():
        out = (_AllToAll.apply(group, split_axis, concat_axis, finish,
                               *planes) if grad else finish())
        return out if multi else out[0]

    return done if async_op else done()


def _issue(planes, group, split_axis: int, concat_axis: int,
           async_op: bool):
    """Pack ``planes`` and issue the collective; returns the function
    that waits for it and unpacks the received planes as a tuple."""
    d = dist.get_world_size(group)
    if planes[0].shape[split_axis] % d:
        raise ValueError(f"all_to_all_tiled: axis {split_axis} of length "
                         f"{planes[0].shape[split_axis]} does not split "
                         f"over {d} ranks")
    # (d, P, ...): chunk j of every plane, contiguous, for rank j
    send = torch.stack([p.unflatten(split_axis, (d, -1)).movedim(
        split_axis, 0) for p in planes], dim=1)
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)

    def finish():
        nonlocal send
        if work is not None:
            work.wait()
        send = None                              # free the pack buffer
        return tuple(recv[:, i].movedim(0, concat_axis).reshape(
            recv.shape[2:2 + concat_axis]
            + (d * recv.shape[2 + concat_axis],)
            + recv.shape[3 + concat_axis:]) for i in range(len(planes)))

    return finish


class _AllToAll(torch.autograd.Function):
    """The received planes of an issued exchange (``finish``, which waits
    for it), recorded as a function of the sent planes; the backward is
    the exchange with the axes swapped, on the cotangents."""

    @staticmethod
    def forward(ctx, group, split_axis, concat_axis, finish, *planes):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return finish()

    @staticmethod
    def backward(ctx, *grads):
        split_axis, concat_axis = ctx.axes
        return (None, None, None, None) + all_to_all_tiled(
            grads, ctx.group, concat_axis, split_axis)


def check_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.make_mesh), got {type(mesh).__name__}")
    return mesh


def _dim(mesh: DeviceMesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r} (axes {names})")
    return names.index(name)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """Ranks along mesh axis ``name`` (``mesh.shape[name]`` in JAX)."""
    return mesh.shape[_dim(mesh, name)]


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on mesh axis ``name``
    (``jax.lax.axis_index``)."""
    return mesh.get_coordinate()[_dim(mesh, name)]


def linear_index(mesh: DeviceMesh) -> int:
    """This rank's row-major index over every mesh axis, as the JAX
    package's ``_device_linear_index``."""
    idx = 0
    for size, c in zip(mesh.shape, mesh.get_coordinate()):
        idx = idx * size + c
    return idx


def all_axes_group(mesh: DeviceMesh):
    """The process group of every rank of the mesh (all axes at once)."""
    return mesh.get_group() if mesh.ndim == 1 else mesh._flatten().get_group()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the CPU or the card the process has set."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def shard(x, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``, a
    PartitionSpec-like tuple of mesh axis names (or None) for the leading
    axes of ``x``, as ``shard_map``'s ``in_specs`` would give it."""
    for ax, name in enumerate(spec):
        if name is None:
            continue
        d = axis_size(mesh, name)
        if x.shape[ax] % d:
            raise ValueError(f"axis {ax} of length {x.shape[ax]} must be "
                             f"divisible by the mesh axis {name!r} size {d}")
        b = x.shape[ax] // d
        x = x.narrow(ax, axis_index(mesh, name) * b, b)
    return x


def on_mesh(x, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device, any other array-like
    goes to this rank's device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=mesh_device(mesh))
