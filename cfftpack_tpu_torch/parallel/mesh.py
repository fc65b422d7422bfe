"""Device-mesh helpers over ``torch.distributed``.

Counterpart of ``cfftpack_tpu/parallel/mesh.py``.  The port runs one
process a rank: :func:`init_distributed` joins the process group (NCCL
on the card, gloo when the caller asks for the CPU) and the mesh
helpers build a ``DeviceMesh`` over its first ranks.  Every rank of the
world calls them together.  The card is the default; without one they
raise unless ``devices="cpu"`` is given.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "local_mesh", "init_distributed"]


def _check_device_type(device_type: str) -> str:
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"devices must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): the "
            "parallel layer runs on the card by default; pass "
            "devices=\"cpu\" (device=\"cpu\" to init_distributed) for gloo "
            "on the CPU")
    return device_type


def make_mesh(shape=None, axis_names=("data",),
              devices: str = "cuda") -> DeviceMesh:
    """Build a DeviceMesh of the given logical shape over the first
    ``prod(shape)`` ranks of the process group, on ``devices`` (a device
    type, ``"cuda"`` or ``"cpu"``).

    ``shape=None`` uses every rank on one axis.  Example:
    ``make_mesh((2, 2), ("data", "model"))``.  Ranks past the mesh take
    part in the call and hold no coordinate.
    """
    device_type = _check_device_type(devices)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) > world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, have {world}")
    if len(axis_names) != len(shape):
        raise ValueError("axis_names must match mesh rank")
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def local_mesh(n: int | None = None, axis: str = "data",
               devices: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first ``n`` (default: all) ranks."""
    return make_mesh(None if n is None else (n,), (axis,), devices=devices)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str = "cuda"):
    """Join the process group: NCCL for ``device="cuda"``, gloo for
    ``"cpu"``; there is no fallback from one to the other.

    ``coordinator`` is ``"host:port"`` of rank 0's store; without it the
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` environment
    (as ``torchrun`` sets it) is read.  On the card each process takes
    card ``rank % device_count``.  Returns ``(rank, world_size)``.
    """
    device_type = _check_device_type(device)
    if device_type == "cuda":
        rank = (process_id if process_id is not None
                else int(os.environ.get("RANK", 0)))
        torch.cuda.set_device(int(rank) % torch.cuda.device_count())
    kwargs = {}
    if coordinator is not None:
        kwargs["init_method"] = f"tcp://{coordinator}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            **kwargs)
    return dist.get_rank(), dist.get_world_size()
