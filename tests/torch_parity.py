"""Shared helpers for the parity tests of the PyTorch port.

The same numpy inputs, made from a seed, go through a function of the
JAX package (on the CPU, x64 on, per conftest.py) and through its
counterpart in ``cfftpack_tpu_torch``; the results are compared as
numpy arrays.  Bars are the reference's (conftest.py): an error
relative to max |X| of 1e-4 in float32 and 1e-12 in float64.
"""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

BARS = {np.float32: 1e-4, np.float64: 1e-12,
        np.complex64: 1e-4, np.complex128: 1e-12}


def bar(dtype) -> float:
    return BARS[np.dtype(dtype).type]


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (want must not be all zeros)."""
    got = to_np(got).astype(np.complex128)
    want = to_np(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def real_input(shape, dtype, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def complex_input(shape, dtype, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape) + 1j * r.standard_normal(shape)
    return x.astype(dtype)


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo process group in this process and a 1-D CPU mesh
    ("data") over it; the group is destroyed after the test."""
    from cfftpack_tpu_torch.parallel import init_distributed, make_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        yield make_mesh((1,), ("data",), devices="cpu")
    finally:
        dist.destroy_process_group()
