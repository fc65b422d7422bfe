"""Normalization conventions and dtype helpers (PyTorch port).

Counterpart of ``cfftpack_tpu/config.py``.  The reference library uses
FFTPACK scaling: the *forward* transform is scaled by 1/N and the
inverse is unscaled; ``"ortho"`` scales both by 1/sqrt(N).

=============  ====================  ====================
norm           forward scale         inverse scale
=============  ====================  ====================
``"fftpack"``  1/N                   1       (reference default)
``"ortho"``    1/sqrt(N)             1/sqrt(N)
``"backward"`` 1                     1/N     (numpy/scipy default)
``"forward"``  1/N                   1       (alias of fftpack)
=============  ====================  ====================

The JAX package's f64 routing policy exists because TPUs lack native
f64; the card has it, so float64 runs natively here: the policy names
(:func:`set_f64_policy`, :func:`f64_policy`) keep their contract and
:func:`hp_route` never routes.

Devices: the port runs on the card unless the caller asks for the CPU.
:func:`resolve_device` is the one place that rule lives; a tensor the
caller hands in keeps its own device.
"""
from __future__ import annotations

import numpy as np
import torch

VALID_NORMS = ("fftpack", "ortho", "backward", "forward")
DEFAULT_NORM = "fftpack"


def check_norm(norm: str | None) -> str:
    if norm is None:
        return DEFAULT_NORM
    if norm not in VALID_NORMS:
        raise ValueError(f"norm must be one of {VALID_NORMS}, got {norm!r}")
    return norm


def fwd_scale(norm: str, n: int) -> float:
    """Scalar applied to the forward transform output."""
    norm = check_norm(norm)
    if norm in ("fftpack", "forward"):
        return 1.0 / n
    if norm == "ortho":
        return float(1.0 / np.sqrt(n))
    return 1.0  # backward


def inv_scale(norm: str, n: int) -> float:
    """Scalar applied to the inverse transform output."""
    norm = check_norm(norm)
    if norm in ("fftpack", "forward"):
        return 1.0
    if norm == "ortho":
        return float(1.0 / np.sqrt(n))
    return 1.0 / n  # backward


# NaN checks at the API layer's exit (``utils.enable_nan_checks``)
NAN_CHECKS = False

# ---------------------------------------------------------- f64 policy

_F64_POLICY = "hp"


def set_f64_policy(policy: str) -> None:
    """Set the f64 policy, ``"hp"`` (default) or ``"native"``; any other
    value raises ``ValueError``.  Both run float64 natively here."""
    global _F64_POLICY
    if policy not in ("hp", "native"):
        raise ValueError(f"f64 policy must be 'hp' or 'native', got "
                         f"{policy!r}")
    _F64_POLICY = policy


def f64_policy() -> str:
    return _F64_POLICY


def hp_route(*arrays) -> bool:
    """Always False: the card has native FP64, so no input is routed to
    a double-float engine."""
    return False


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """Real dtype underlying a complex (or real) dtype."""
    if dtype == torch.complex64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.float64
    return dtype


def complex_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """Complex dtype matching a real (or complex) dtype's precision."""
    if dtype in (torch.float64, torch.complex128):
        return torch.complex128
    return torch.complex64


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    the card.  With no ``device`` and no card it raises; it never picks
    the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): "
            "cfftpack_tpu_torch runs on the card by default; pass "
            "device=\"cpu\" or CPU tensors to run on the CPU")
    return torch.device("cuda")


def as_tensor(x, like=None) -> torch.Tensor:
    """``x`` as a tensor.  A tensor keeps its device; any other
    array-like goes where ``like`` (a tensor) lives or, without one, to
    the default device of :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if like is not None else resolve_device()
    return torch.as_tensor(x, device=device)
