"""Inputs drawn from the run's seed and a key, so that any part of them
can be drawn again on its own: a generator of its own for each key."""
from __future__ import annotations

import hashlib

import torch


def generator(device, seed: int, *key) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, *key)``."""
    digest = hashlib.blake2b(repr((int(seed),) + key).encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little"))
    return gen


def normal(shape, device, seed: int, *key,
           dtype=torch.float32) -> torch.Tensor:
    """Standard normal values of ``shape``, one draw from the generator of
    ``(seed, *key)``: the same on every call with the same arguments."""
    return torch.randn(shape, generator=generator(device, seed, *key),
                       device=device, dtype=dtype)
