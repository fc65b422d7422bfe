"""Frequency-grid helpers and spectral convolution (PyTorch port).

Counterpart of ``cfftpack_tpu/ops/freq.py``: numpy-compatible
fftfreq/rfftfreq and an FFT circular convolution.  The grid functions
have no tensor argument, so they take the device as a keyword and, like
every entry point, land on the card unless the caller names the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_NORM, _check_length, as_tensor, resolve_device
from .cfft import fft, ifft
from .rfft import irfft, rfft

__all__ = ["fftfreq", "rfftfreq", "circular_convolve"]


def fftfreq(n: int, d: float = 1.0, device=None):
    """Sample frequencies for fft output (numpy semantics), float64."""
    k = np.empty(n, dtype=np.float64)
    pos = (n - 1) // 2 + 1
    k[:pos] = np.arange(pos)
    k[pos:] = np.arange(-(n // 2), 0)
    return torch.from_numpy(k / (n * d)).to(resolve_device(device))


def rfftfreq(n: int, d: float = 1.0, device=None):
    """Sample frequencies for rfft output (numpy semantics), float64."""
    k = np.arange(n // 2 + 1) / (n * d)
    return torch.from_numpy(k).to(resolve_device(device))


def circular_convolve(a, b, axis: int = -1):
    """Circular convolution along ``axis`` via the spectral theorem.

    With the fftpack norm (forward 1/N), conv = N * ifft(fft(a)*fft(b));
    handled internally so the result equals the direct circular sum.
    Real inputs use the r2c path (half the transforms).
    """
    a = as_tensor(a)
    b = as_tensor(b, like=a)
    n = a.shape[axis]
    _check_length(n)
    if b.shape[axis] != n:
        raise ValueError("circular_convolve: axis lengths differ")
    if not (a.is_complex() or b.is_complex()):
        fa = rfft(a, axis=axis, norm=DEFAULT_NORM)
        fb = rfft(b, axis=axis, norm=DEFAULT_NORM)
        return irfft(fa * fb, n, axis=axis, norm=DEFAULT_NORM) * n
    fa = fft(a, axis=axis, norm=DEFAULT_NORM)
    fb = fft(b, axis=axis, norm=DEFAULT_NORM)
    return ifft(fa * fb, axis=axis, norm=DEFAULT_NORM) * n
