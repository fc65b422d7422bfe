"""Odd-period DCT/DST types V-VIII (Martucci 1994), PyTorch port.

Counterpart of ``cfftpack_tpu/ops/oddtypes.py``.  The C library builds
each type from a zero-padded rfft/gdft of length 2N+-1
(cfftextra.c:481-958); here every type is one phase-ramped mixed-radix
FFT through ``core.s_shifted_dft_real`` --
U[k] = sum_{j<N} x_j e^{-2i pi (j+a)(k+b)/M}:

  ============  =======================  ==============================
  type          (a, b, M)                value
  ============  =======================  ==============================
  DCT-V         (0,   0,   2N-1)         Re U
  DCT-VI        (1/2, 0,   2N-1)         Re U
  DCT-VII       (0,   1/2, 2N-1)         Re U
  DCT-VIII      (1/2, 1/2, 2N+1)         Re U
  DST-V         (1,   1,   2N+1)         -Im U
  DST-VI        (1/2, 1,   2N+1)         -Im U
  DST-VII       (1,   1/2, 2N+1)         -Im U
  DST-VIII      (1/2, 1/2, 2N-1)         -Im U
  ============  =======================  ==============================

Scaling follows the C library exactly (the golden vectors of
``tests/golden/golden.npz`` come from the running library): the V/VI/VII
cosine types carry half-weight boundary corrections inherited from
their symmetric extensions
(e.g. dct5 = 2*naive - x0, the "data[0]*=2 and packed-rfft doubling"
dance of cfftextra.c:517-543), DST-VIII half-weights its last column.
Forward carries the full 1/M scale (or none where the reference's
*_transform is the unscaled side); ortho uses 1/sqrt(M).
"""
from __future__ import annotations

import functools

import numpy as np

from .. import plan
from .core import s_shifted_dft_real

__all__ = [
    "dct5_apply", "dct6_apply", "dct7_apply", "dct8_apply",
    "dst5_apply", "dst6_apply", "dst7_apply", "dst8_apply",
]


@functools.lru_cache(maxsize=64)
def _alt(n: int, dtype, device):
    """(-1)^k, k < n."""
    return plan.to_device((-1.0) ** np.arange(n), dtype, device)


@functools.lru_cache(maxsize=64)
def _last_half(n: int, dtype, device):
    """Ones with 1/2 in the last place."""
    w = np.ones(n)
    w[-1] = 0.5
    return plan.to_device(w, dtype, device)


def _re_u(x, n, m, a, b):
    return s_shifted_dft_real(x, n, m, a, b, n)[0]


def _im_u(x, n, m, a, b):
    return -s_shifted_dft_real(x, n, m, a, b, n)[1]


# Bases: the exact linear maps the reference *_transform functions apply
# before their global scale (golden-verified).

def _base_dct5(x, n):
    m = 2 * n - 1
    return 2.0 * _re_u(x, n, m, 0.0, 0.0) - x[..., :1]


def _base_dct6(x, n):
    m = 2 * n - 1
    s = _alt(n, x.dtype, x.device)
    return 2.0 * _re_u(x, n, m, 0.5, 0.0) - s * x[..., -1:]


def _base_dct7(x, n):
    m = 2 * n - 1
    return 2.0 * _re_u(x, n, m, 0.0, 0.5) - x[..., :1]


def _base_dct8(x, n):
    m = 2 * n + 1
    return 2.0 * _re_u(x, n, m, 0.5, 0.5)


def _base_dst5(x, n):
    m = 2 * n + 1
    return 2.0 * _im_u(x, n, m, 1.0, 1.0)


def _base_dst6(x, n):
    m = 2 * n + 1
    return 2.0 * _im_u(x, n, m, 0.5, 1.0)


def _base_dst7(x, n):
    m = 2 * n + 1
    return 2.0 * _im_u(x, n, m, 1.0, 0.5)


def _base_dst8(x, n):
    m = 2 * n - 1
    # half-weight on the last input column (reference embedding quirk)
    return 2.0 * _im_u(x * _last_half(n, x.dtype, x.device), n, m, 0.5, 0.5)


# mode: +1 fftpack forward, -1 unscaled inverse, 0 ortho — matching the
# reference's forward/inverse/ortho triples for each type.

def dct5_apply(x, n: int, mode: int):
    y = _base_dct5(x, n)
    M = 2 * n - 1
    if mode > 0:
        return y * (1.0 / M)
    if mode < 0:
        return y
    return y * float(1.0 / np.sqrt(M))


def dct6_apply(x, n: int, mode: int):
    y = _base_dct6(x, n)
    M = 2 * n - 1
    if mode == 0:
        return y * float(1.0 / np.sqrt(M))
    return y  # reference dct6_transform is the unscaled side


def dct7_apply(x, n: int, mode: int):
    y = _base_dct7(x, n)
    M = 2 * n - 1
    if mode == 0:
        return y * float(1.0 / np.sqrt(M))
    return y * (1.0 / M)  # reference dct7_transform carries the scale


def dct8_apply(x, n: int, mode: int):
    y = _base_dct8(x, n)
    M = 2 * n + 1
    if mode > 0:
        return y * (1.0 / M)
    if mode < 0:
        return y
    return y * float(1.0 / np.sqrt(M))


def dst5_apply(x, n: int, mode: int):
    y = _base_dst5(x, n)
    M = 2 * n + 1
    if mode > 0:
        return y * (1.0 / M)
    if mode < 0:
        return y
    return y * float(1.0 / np.sqrt(M))


def dst6_apply(x, n: int, mode: int):
    y = _base_dst6(x, n)
    M = 2 * n + 1
    if mode == 0:
        return y * float(1.0 / np.sqrt(M))
    return y * (1.0 / M)  # reference dst6_transform carries the scale


def dst7_apply(x, n: int, mode: int):
    y = _base_dst7(x, n)
    M = 2 * n + 1
    if mode == 0:
        return y * float(1.0 / np.sqrt(M))
    return y  # reference dst7_transform is the unscaled side


def dst8_apply(x, n: int, mode: int):
    y = _base_dst8(x, n)
    M = 2 * n - 1
    if mode > 0:
        return y * (1.0 / M)
    if mode < 0:
        return y
    return y * float(1.0 / np.sqrt(M))
