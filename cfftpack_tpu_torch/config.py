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
caller hands in keeps its own device.  The API layer's shared checks
and coercion live here too, below the engine.
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


def _apply_axis(x, axis: int, fn):
    """fn over the last axis, applied along ``axis`` (movedim is a view)."""
    return fn(x.movedim(axis, -1)).movedim(-1, axis)


def _check_axis(x, axis: int) -> None:
    if not -x.ndim <= axis < x.ndim:
        raise ValueError(f"axis {axis} out of range for rank-{x.ndim} input")


def _check_length(n: int) -> None:
    """Every entry point calls this before any table is built."""
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")


def _as_real_plane(x, name: str):
    """Coerce a real-plane operand to a >= 32-bit float dtype: integers
    promote with float32, narrower floats widen to float32 (their
    twiddles would lose ~1e-2), and complex input is rejected (it would
    flow into the real engine silently)."""
    if x.is_complex():
        raise TypeError(
            f"{name}: real input required, got {x.dtype}; take .real "
            "explicitly or use the complex fft API")
    if not x.dtype.is_floating_point:
        return x.to(torch.promote_types(x.dtype, torch.float32))
    if torch.finfo(x.dtype).bits < 32:
        return x.to(torch.float32)
    return x


def as_tensor(x, like=None) -> torch.Tensor:
    """``x`` as a tensor.  A tensor keeps its device; any other
    array-like goes where ``like`` (a tensor) lives or, without one, to
    the default device of :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if like is not None else resolve_device()
    return torch.as_tensor(x, device=device)
