"""Reference-compatible plan API (PyTorch port).

Counterpart of ``cfftpack_tpu/compat.py``: the C library's surface
(``cfftpack.h``, ``cfftextra.h``) on top of the functional API, with the
reference's conventions that the functional API cleans up:

* ``fft`` ortho: forward = F/n^1.5 and inverse = B*sqrt(n) (the rescale
  stacks on the already-1/n-scaled forward, cfftpack.c:69-101).
* ``rfft`` packing: interior bins are 2*conj(X_k) (cosine/sine series
  coefficients, cfftpack.c:454-480); fft_ortho is ignored by rfft.
* ``dst`` ortho scales index 0 rather than the Nyquist row
  (cfftpack.c:376-431).
* ``dct7`` ortho: sqrt(M)/2M, which does not invert ortho dct6
  (cfftextra.c:585-593).
* ``gdft_inverse`` is the true inverse (the reference's is broken for
  a != 0, cfftextra.c:474-478).

Plans are descriptors: tables are built and cached by the functional
layer, as tensors in the data's dtype on the data's device.  Data that
is not a tensor goes to the default device (``config.as_tensor``).
Errors raise ValueError instead of C return codes.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ops
from .config import as_tensor, real_dtype_of
from .plan import (fft_next_fast_size, fft_next_fast_even_size,  # noqa: F401
                   fft_next_fast_size_2nm1, fft_next_fast_size_2np1)

__all__ = [
    "fft_create", "fft2_create", "rfft_create", "dct_create", "dct1_create",
    "dst_create", "dst1_create", "dct4_create", "dst4_create",
    "dct_2d_create", "gdft_create", "dct5_create", "dct6_create",
    "dct7_create", "dct8_create", "dst5_create", "dst6_create",
    "dst7_create", "dst8_create", "fft_free", "fft_ortho", "fft_stride",
    "fftshift", "ifftshift",
    "fft_next_fast_size", "fft_next_fast_even_size",
    "fft_next_fast_size_2nm1", "fft_next_fast_size_2np1",
]


def _tab(w, like):
    """A host float64 table as a tensor in ``like``'s real dtype, on its
    device."""
    return torch.as_tensor(w, dtype=real_dtype_of(like.dtype),
                           device=like.device)


class _Plan:
    """Base plan object (the fft_t analog, cfftintern.h:31-38)."""

    kind = "?"

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"{self.kind}_create: size must be > 0, got {n}")
        self.n = int(n)
        self.ortho = False
        self.inc = 1

    # C-style free is a no-op: plans hold no device buffers
    def free(self):
        pass

    def _check(self, data):
        data = as_tensor(data)
        if data.shape[-1] != self.n:
            raise ValueError(
                f"{self.kind}: last axis is {data.shape[-1]}, plan wants "
                f"{self.n}")
        return data

    def _run_strided(self, data, fn):
        """fft_stride support: transform the inc-strided last-axis view
        and write the results into a copy of the buffer."""
        inc = self.inc
        if inc == 1:
            return fn(data)
        data = as_tensor(data)
        need = (self.n - 1) * inc + 1
        if data.shape[-1] < need:
            raise ValueError(
                f"{self.kind}: stride {inc} needs a last axis >= {need}, "
                f"got {data.shape[-1]}")
        out = fn(data[..., :need:inc])
        buf = data.to(torch.promote_types(data.dtype, out.dtype), copy=True)
        buf[..., :need:inc] = out
        return buf


def fft_free(f: _Plan):
    f.free()


def fft_ortho(f: _Plan, ortho: bool):
    """Toggle orthonormal scaling (cfftpack.h:54-67 semantics,
    including which transforms ignore it)."""
    f.ortho = bool(ortho)


def fft_stride(f: _Plan, stride: int):
    """Element stride for subsequent transforms (cfftpack.c:51-57: sets
    fft_t.inc; <= 0 resets to 1).

    The plan transforms the ``inc``-strided view of the last axis
    (elements 0, inc, 2*inc, ...) and writes the results into a copy of
    the buffer, leaving the gap elements untouched: the column walk of
    the reference's ``naive_real_2d`` (test/naivepack.c:269-288).  That
    needs a length-preserving plan, so an ``RFFTPlan`` (n real values
    in, n//2+1 bins out) raises ``ValueError`` for a stride above 1.
    """
    inc = int(stride) if stride > 0 else 1
    if inc > 1 and isinstance(f, RFFTPlan):
        raise ValueError(
            "fft_stride: an rfft plan is not length-preserving (n real "
            "values in, n//2+1 bins out), so its output cannot be written "
            "back into the strided view")
    f.inc = inc
    if f.inc > 1 and not getattr(f, "_stride_wrapped", False):
        f._stride_wrapped = True
        for name in ("forward", "inverse"):
            orig = getattr(f, name, None)
            if orig is None:
                continue

            def wrapped(data, _orig=orig, _f=f):
                return _f._run_strided(data, _orig)

            setattr(f, name, wrapped)


fftshift = ops.fftshift
ifftshift = ops.ifftshift


# ------------------------------------------------------------- complex fft

class FFTPlan(_Plan):
    kind = "fft"

    def forward(self, data):
        y = ops.fft(self._check(data))
        if self.ortho:  # reference quirk: extra 1/sqrt(n) on top of 1/n
            y = y * float(1.0 / np.sqrt(self.n))
        return y

    def inverse(self, data):
        y = ops.ifft(self._check(data))
        if self.ortho:  # reference quirk: extra sqrt(n)
            y = y * float(np.sqrt(self.n))
        return y


def fft_create(size: int) -> FFTPlan:
    return FFTPlan(size)


def fft_forward(f: FFTPlan, data):
    return f.forward(data)


def fft_inverse(f: FFTPlan, data):
    return f.inverse(data)


class FFT2Plan(_Plan):
    """2-D plan; data layout (m, l) row-major for fft2_create(l, m)
    (Fortran c(l, m) column-major, cfftpack.c:104-152)."""

    kind = "fft2"

    def __init__(self, l: int, m: int):
        super().__init__(l * m)
        self.l = int(l)
        self.m = int(m)

    def _check2(self, data):
        data = as_tensor(data)
        if tuple(data.shape[-2:]) != (self.m, self.l):
            raise ValueError(
                f"fft2: expected trailing shape ({self.m},{self.l}), got "
                f"{tuple(data.shape[-2:])}")
        return data

    def forward(self, data):
        return ops.fft2(self._check2(data))

    def inverse(self, data):
        return ops.ifft2(self._check2(data))


def fft2_create(l: int, m: int) -> FFT2Plan:
    return FFT2Plan(l, m)


def fft2_forward(f, data):
    return f.forward(data)


def fft2_inverse(f, data):
    return f.inverse(data)


# ---------------------------------------------------------------- real fft

class RFFTPlan(_Plan):
    """Reference packing: interior bins 2*conj(X); ortho ignored."""

    kind = "rfft"

    def _weights(self, interior: float):
        n = self.n
        w = np.ones(n // 2 + 1)
        w[1:n // 2 + n % 2] = interior
        return w

    def forward(self, inp):
        y = ops.rfft(self._check(inp))
        # DC (and even-n Nyquist) are real; conj is identity there
        return torch.conj(y) * _tab(self._weights(2.0), y)

    def inverse(self, spec):
        spec = as_tensor(spec)
        if spec.shape[-1] != self.n // 2 + 1:
            raise ValueError(
                f"rfft_inverse: expected {self.n // 2 + 1} bins, got "
                f"{spec.shape[-1]}")
        return ops.irfft(torch.conj(spec * _tab(self._weights(0.5), spec)),
                         self.n)


def rfft_create(size: int) -> RFFTPlan:
    return RFFTPlan(size)


def rfft_forward(f, inp):
    return f.forward(inp)


def rfft_inverse(f, spec):
    return f.inverse(spec)


# -------------------------------------------------------------- dct family

class _Real1D(_Plan):
    """Shared scaffolding for the real transform plans: forward and
    inverse of type ``fwd_type`` under fftpack, or ortho when set."""

    fwd_type = 0
    is_dst = False

    def _norm(self):
        return "ortho" if self.ortho else "fftpack"

    def forward(self, data):
        fn = ops.dst if self.is_dst else ops.dct
        return fn(self._check(data), self.fwd_type, norm=self._norm())

    def inverse(self, data):
        fn = ops.idst if self.is_dst else ops.idct
        return fn(self._check(data), self.fwd_type, norm=self._norm())


class DCTPlan(_Real1D):
    kind = "dct"
    fwd_type = 3  # FFTPACK: forward DCT is DCT-III (cfftpack.h:143-158)


def dct_create(size: int) -> DCTPlan:
    return DCTPlan(size)


class DCT1Plan(_Real1D):
    kind = "dct1"
    fwd_type = 1

    def __init__(self, n):
        if n <= 1:
            raise ValueError("dct1_create: size must be >= 2")
        super().__init__(n)


def dct1_create(size: int) -> DCT1Plan:
    return DCT1Plan(size)


class DSTPlan(_Real1D):
    """sinq pair with the reference's index-0 ortho quirk
    (cfftpack.c:376-431)."""

    kind = "dst"
    fwd_type = 3
    is_dst = True

    def forward(self, data):
        data = self._check(data)
        if not self.ortho:
            return ops.dst(data, 3)
        n = self.n
        w = np.full(n, np.sqrt(0.5 / n))
        w[0] = np.sqrt(1.0 / n)
        return ops.dst(data * _tab(w, data), 3) * float(n)

    def inverse(self, data):
        y = ops.idst(self._check(data), 3)
        if self.ortho:
            n = self.n
            w = np.full(n, np.sqrt(2.0 / n))
            w[0] = np.sqrt(1.0 / n)
            y = y * _tab(w, y)
        return y


def dst_create(size: int) -> DSTPlan:
    return DSTPlan(size)


class DST1Plan(_Real1D):
    kind = "dst1"
    fwd_type = 1
    is_dst = True


def dst1_create(size: int) -> DST1Plan:
    return DST1Plan(size)


class DCT4Plan(_Real1D):
    kind = "dct4"
    fwd_type = 4

    def __init__(self, n):
        if n % 2:
            raise ValueError("dct4_create: size must be even "
                             "(cfftextra.h:34-36)")
        super().__init__(n)


def dct4_create(size: int) -> DCT4Plan:
    return DCT4Plan(size)


class DST4Plan(DCT4Plan):
    kind = "dst4"
    is_dst = True


def dst4_create(size: int) -> DST4Plan:
    return DST4Plan(size)


class DCT2DPlan(_Plan):
    """2-D DCT; buffer layout (N, M) for dct_2d_create(M, N), the
    implementation's actual layout, which contradicts its own header
    comment (cfftextra.h:138-139 vs the golden-verified behavior)."""

    kind = "dct_2d"

    def __init__(self, M: int, N: int):
        super().__init__(M * N)
        self.M = int(M)
        self.N = int(N)

    def _check2(self, data):
        data = as_tensor(data)
        if tuple(data.shape[-2:]) != (self.N, self.M):
            raise ValueError(
                f"dct_2d: expected trailing shape ({self.N},{self.M}), got "
                f"{tuple(data.shape[-2:])}")
        return data

    def forward(self, data):
        return ops.dctn(self._check2(data), 3, axes=(-2, -1))

    def inverse(self, data):
        return ops.idctn(self._check2(data), 3, axes=(-2, -1))


def dct_2d_create(M: int, N: int) -> DCT2DPlan:
    return DCT2DPlan(M, N)


def dct_2d_forward(f, data):
    return f.forward(data)


def dct_2d_inverse(f, data):
    return f.inverse(data)


# ------------------------------------------------------------------- gdft

class GDFTPlan(_Plan):
    """gdft_create(size, a, b): forward multiplies the time ramp by
    exp(-2i pi j a / n) and the frequency ramp by exp(-2i pi (k+a) b/n),
    which is our gdft(x, a=b, b=a) with fftpack scaling
    (cfftextra.c:397-453).  inverse is the true inverse."""

    kind = "gdft"

    def __init__(self, n, a: float, b: float):
        if not (0 <= a < 1 and 0 <= b < 1):
            raise ValueError("gdft_create: shifts must be in [0, 1)")
        super().__init__(n)
        self.a = float(a)
        self.b = float(b)

    def forward(self, data):
        return ops.gdft(self._check(data), a=self.b, b=self.a)

    def inverse(self, data):
        return ops.igdft(self._check(data), a=self.b, b=self.a)


def gdft_create(size: int, a: float, b: float) -> GDFTPlan:
    return GDFTPlan(size, a, b)


def gdft_forward(f, data):
    return f.forward(data)


def gdft_inverse(f, data):
    return f.inverse(data)


# --------------------------------------------------------- odd types V-VIII

class _OddPlan(_Real1D):
    def transform(self, data):  # dct6/dct7/dst6/dst7 expose *_transform
        return self.forward(data)


class DCT5Plan(_OddPlan):
    kind = "dct5"
    fwd_type = 5


class DCT6Plan(_OddPlan):
    kind = "dct6"
    fwd_type = 6


class DCT7Plan(_OddPlan):
    kind = "dct7"
    fwd_type = 7

    def forward(self, data):
        if self.ortho:
            # reference quirk: base/(2 sqrt M), half the invertible scale
            return ops.dct(self._check(data), 7, norm="ortho") * 0.5
        return ops.dct(self._check(data), 7)


class DCT8Plan(_OddPlan):
    kind = "dct8"
    fwd_type = 8


class DST5Plan(_OddPlan):
    kind = "dst5"
    fwd_type = 5
    is_dst = True


class DST6Plan(_OddPlan):
    kind = "dst6"
    fwd_type = 6
    is_dst = True


class DST7Plan(_OddPlan):
    kind = "dst7"
    fwd_type = 7
    is_dst = True


class DST8Plan(_OddPlan):
    kind = "dst8"
    fwd_type = 8
    is_dst = True


def dct5_create(size):
    return DCT5Plan(size)


def dct6_create(size):
    return DCT6Plan(size)


def dct7_create(size):
    return DCT7Plan(size)


def dct8_create(size):
    return DCT8Plan(size)


def dst5_create(size):
    return DST5Plan(size)


def dst6_create(size):
    return DST6Plan(size)


def dst7_create(size):
    return DST7Plan(size)


def dst8_create(size):
    return DST8Plan(size)
