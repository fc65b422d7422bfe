"""The flagship step: the spectral conv-pricer core on one device.

Counterpart of ``__graft_entry__.entry()``: a batched forward real FFT,
a pointwise characteristic-function multiply and an inverse real FFT
(the hot path of every reference app, test/vargamma.c:42-106) at the
mixed-radix length 960 = 2^6*3*5 with batch 64, on inputs made exactly
as the JAX entry makes them.  The transforms are the public names, so
the step has their API spans and NaN check; it runs in the span
``cfftpack.step``, its multiply in ``cfftpack.filter``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .ops import irfft_split, rfft_split
from .utils.profiling import span

N = 960
BATCH = 64


def step(v, phi_r, phi_i):
    with span("cfftpack.step"):
        sr, si = rfft_split(v)                  # (B, n//2+1), fftpack norm
        with span("cfftpack.filter"):
            tr = sr * phi_r - si * phi_i        # pointwise characteristic fn
            ti = sr * phi_i + si * phi_r
        return irfft_split(tr, ti, v.shape[-1])  # back to payoff space


def entry(device=None, batch: int = BATCH):
    """(step, args): the step and its float32 inputs on ``device`` (the
    card unless the caller names another, ``config.resolve_device``).

    At the default batch the inputs are those of the JAX entry: v from
    ``np.random.default_rng(0).standard_normal((batch, 960))``, then
    the phases of phi from the same generator.
    """
    device = resolve_device(device)
    r = np.random.default_rng(0)
    v = r.standard_normal((batch, N))
    ph = np.exp(1j * r.standard_normal(N // 2 + 1))
    args = tuple(torch.as_tensor(a.astype(np.float32)).to(device)
                 for a in (v, ph.real, ph.imag))
    return step, args
