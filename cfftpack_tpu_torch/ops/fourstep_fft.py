"""K10: the four-step FFT for n = 64*n2, n2 in {16, 64, ..., 4096}.

Counterpart of ``cfftpack_tpu/ops/pallas_fourstep.py`` (the Pallas kernel
``_make_kernel`` behind ``sfft_fourstep_pallas``).  With j = j1*n2 + j2
and k = k1 + 64*k2,

    X[k1 + 64*k2] = sum_j2 W_n2^{j2 k2} * W_n^{k1 j2}
                    * sum_j1 x[j1*n2 + j2] W_64^{j1 k1}

stage A is a dense 64-point DFT over j1 as a matrix product, then the
outer twiddle, then stage B, the n2-point radix-4 Stockham transform
over j2; natural order in and out, both signs.  The CUDA kernels live in
``csrc/fourstep_fft.cu``: two passes through scratch planes (32 bytes an
element, which bounds it), the dense product on the tensor cores in the
float32-accurate 3xTF32 split of ``csrc/cgemm.cuh``, the DFT matrix
split into its TF32 halves here (:func:`_tf32_split`) and resident in
shared memory; below n2 = 128 a tile of that product spans several
transforms of the batch (:func:`_column_groups`).

On a CPU tensor :func:`sfft_fourstep` runs the plain PyTorch version
(:func:`sfft_fourstep_plain`: ``torch.matmul`` on the same DFT matrix
and ``fused_fft._stockham`` on the same stage tables); on a CUDA tensor
it launches the kernel or raises, each launch counted in
``utils.profiling.launches["K10"]``.
The kernel is opt-in (``fft_split(..., impl="pallas")``): the engine's
dispatch does not pick it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import plan
from ..utils import profiling
from . import _adjoint, _build, fused_fft, stream_fft

__all__ = ["fourstep_eligible", "sfft_fourstep", "sfft_fourstep_plain"]

_N1 = 64           # the dense outer DFT's length
_TAIL = 16
_MAX_N2 = 4096     # the reference's cap, kept so the eligible lengths agree
_TILE_COLS = 128   # columns of a tile of stage A's product (FS_TJ)


def fourstep_eligible(n: int, dtype) -> bool:
    """float32 and n = 64 * 16 * 4^k with n / 64 <= 4096 (the
    reference's rule): 1024, 4096, 16384, 65536 and 262144."""
    if dtype != torch.float32 or n % _N1:
        return False
    n2 = n // _N1
    if n2 > _MAX_N2:
        return False
    while n2 > _TAIL and n2 % 4 == 0:
        n2 //= 4
    return n2 == _TAIL


def _column_groups(n2: int, b: int) -> tuple[int, int]:
    """How the kernel's stage A tiles the columns of a batch (the rule
    of ``fourstep_fft_f32`` in ``csrc/fourstep_fft.cu``, mirrored here to
    be tested without the card): the transforms a 128-column tile spans
    (8 at n2 = 16, 2 at n2 = 64, 1 from n2 = 256 up) and the number of
    tiles over the batch; the last group is masked where the batch is
    ragged."""
    group = max(1, _TILE_COLS // n2)
    if group > 1:
        return group, -(-b // group)
    return 1, b * (n2 // _TILE_COLS)


def _tf32_split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A float32 array as hi + lo, both TF32 values (10 mantissa bits,
    rounded to nearest, ties away from zero, as ``cvt.rna.tf32.f32``): hi
    is a rounded, lo is the rounded rest.  a - hi is exact in float32."""
    def rna(x):
        bits = x.view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)
    a = np.ascontiguousarray(a, dtype=np.float32)
    hi = rna(a)
    return hi, rna(a - hi)


@functools.lru_cache(maxsize=16)
def _tables(n: int, inverse: bool):
    """The (64, 64) DFT matrix and the (64, n2) outer twiddle
    W_n^{k1 j2} at [k1, j2], in the transform's sign, as float32 planes
    built in float64."""
    n2 = n // _N1
    sgn = 2j * np.pi if inverse else -2j * np.pi
    k1 = np.arange(_N1)[:, None]
    j2 = np.arange(n2)[None, :]
    t1 = np.exp(sgn * k1 * j2 / n)
    D = plan.dft_matrix(_N1)
    if inverse:
        D = np.conj(D)
    f32 = np.float32
    return (D.real.astype(f32), D.imag.astype(f32),
            t1.real.astype(f32), t1.imag.astype(f32))


@functools.lru_cache(maxsize=16)
def _device_tables(n: int, inverse: bool, device):
    with profiling.planning():
        return tuple(torch.from_numpy(t).to(device)
                     for t in _tables(n, inverse))


@functools.lru_cache(maxsize=4)
def _device_split_dft(inverse: bool, device):
    """The kernel's DFT matrix: (4, 64, 64) float32, re and im of the hi
    halves, then of the lo halves, of the matrix of :func:`_tables`."""
    with profiling.planning():
        Dr, Di = _tables(_N1 * _TAIL, inverse)[:2]
        (rh, rl), (ih, il) = _tf32_split(Dr), _tf32_split(Di)
        return torch.from_numpy(np.stack([rh, ih, rl, il])).to(device)


def sfft_fourstep_plain(xr, xi, n: int, inverse: bool):
    """K10's plain PyTorch version on any device: (b, n) float32 planes
    in, the same decomposition and tables as the kernel."""
    n2 = n // _N1
    b = xr.shape[0]
    Dr, Di, t1r, t1i = _device_tables(n, inverse, xr.device)
    x3r = xr.reshape(b, _N1, n2)
    x3i = xi.reshape(b, _N1, n2)
    Ar = torch.matmul(Dr, x3r) - torch.matmul(Di, x3i)
    Ai = torch.matmul(Dr, x3i) + torch.matmul(Di, x3r)
    Tr, Ti = fused_fft._cmul_tab(Ar, Ai, t1r, t1i)
    Yr, Yi = fused_fft._stockham(Tr, Ti, n2, inverse)    # [k1, k2]
    return (Yr.transpose(1, 2).reshape(b, n),
            Yi.transpose(1, 2).reshape(b, n))


def _launch(xr, xi, n: int, inverse: bool):
    if not (xr.is_cuda and xi.is_cuda) or xr.device != xi.device:
        raise ValueError(f"K10 needs both planes on one CUDA device, got "
                         f"{xr.device} and {xi.device}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"K10 takes float32 planes, got {xr.dtype} and "
                        f"{xi.dtype}")
    if not fourstep_eligible(n, xr.dtype):
        raise ValueError(f"K10 does not take n={n}")
    if tuple(xr.shape[1:]) != (n,) or xi.shape != xr.shape:
        raise ValueError(f"K10 takes (b, {n}) planes, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    with profiling.span("cfftpack.pack"):
        xr = xr.contiguous()
        xi = xi.contiguous()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    b = xr.shape[0]
    if b == 0:
        return yr, yi
    sr = torch.empty_like(xr)
    si = torch.empty_like(xi)
    n2 = n // _N1
    t1r, t1i = _device_tables(n, inverse, xr.device)[2:]
    d4 = _device_split_dft(inverse, xr.device)
    t = plan.device_tables(n2, xr.dtype, xr.device)
    fac = np.asarray(t.factors, dtype=np.int32)
    off = np.asarray(t.offs[:-1], dtype=np.int32)
    # pass B holds R rows k1 of one transform in 16*R*n2 bytes of ping-pong
    # buffers: R by the rule measured for the stream kernels' column pass
    rshift = stream_fft._col_lanes(n2).bit_length() - 1
    err = _build.call(
        "K10", _build.load().fourstep_fft_f32, xr.device, xr.data_ptr(),
        xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), sr.data_ptr(),
        si.data_ptr(), d4.data_ptr(), t1r.data_ptr(), t1i.data_ptr(),
        t.twr.data_ptr(), t.twi.data_ptr(), len(fac), fac.ctypes.data,
        off.ctypes.data, b, n2, rshift, int(inverse))
    if err != 0:
        raise RuntimeError(f"K10 launch failed at n={n}, b={b}: CUDA error "
                           f"{err}")
    return yr, yi


def sfft_fourstep(xr, xi, n: int, inverse: bool):
    """Unscaled DFT over the last axis through K10.

    Same contract as ``core.sfft`` (any leading shape, any batch); the
    caller guarantees ``fourstep_eligible(n, dtype)``.  The adjoint is the
    other direction.
    """
    if _adjoint.needs_grad(xr, xi):
        return _adjoint.linear(
            lambda a, b: sfft_fourstep(a, b, n, inverse),
            lambda a, b: sfft_fourstep(a, b, n, not inverse), xr, xi)
    shape = xr.shape
    xr2 = xr.reshape(-1, n)
    xi2 = xi.reshape(-1, n)
    if xr.device.type == "cpu":
        yr, yi = sfft_fourstep_plain(xr2, xi2, n, inverse)
    else:
        yr, yi = _launch(xr2, xi2, n, inverse)
    return yr.reshape(shape), yi.reshape(shape)
