"""The step's spectral multiply and its adjoint (``csrc/cmul.cu``).

The flagship step multiplies the packed spectrum (sr, si), (..., h1)
planes, by one filter (fr, fi) of h1 bins broadcast over the rows:
t = s * F, ``tr = sr*fr - si*fi``, ``ti = sr*fi + si*fr``.  Under JAX,
XLA fused it into its neighbours (no Pallas kernel); here one CUDA kernel
does it in one pass that reads each plane element once and writes it
once, and a second pair computes its adjoint: the spectrum's gradient
``g * conj(F)`` and the filter's, the row sums of ``conj(s) * g``, summed
in float64 over strips of rows and then over the strips in a fixed order
(no atomics: the same bits every run).

:func:`spectral_mul` is the wrapper.  On a CPU tensor it runs the plain
version (:func:`cmul_plain`, the two lines above); on a CUDA tensor it
launches ``cmul_f32``/``cmul_f64`` or raises.  Under autograd it enters
``_adjoint.bilinear`` as one map of (sr, si, fr, fi), whose adjoint
computes only what ``needs`` asks for: both gradients in one launch of
``cmul_adj_*`` (the kernel and the reduce), the spectrum's alone as the
forward kernel with the conjugate filter, the filter's alone without the
plane stores.  When the backward itself is differentiated (grad mode on
in it), the adjoint composes two differentiable maps instead: the same
forward with the conjugate filter, and the row sums :func:`cmul_sums`,
whose adjoint is the forward map again, so every derivative order runs
these kernels.  Launches count under ``utils.profiling.launches["cmul"]``
in the span ``cfftpack.cmul``.  ``ops.core.spectral_mul`` chooses this
wrapper (:func:`cmul_eligible`) or the plain expression.
"""
from __future__ import annotations

import functools

import torch

from ..utils import profiling
from . import _adjoint, _build

__all__ = ["cmul_eligible", "spectral_mul", "cmul_sums", "cmul_plain",
           "adjoint_plain"]

_DTYPES = (torch.float32, torch.float64)
_ALIGN = 16                 # the kernels' 16-byte vector loads and stores
_THREADS = 256              # CM_THREADS
_UNROLL = 4                 # CM_UNROLL
_BLOCKS_PER_SM = 32         # the forward's grid, from a sweep of 4-32
_ADJ_THREADS = 512          # CMA_THREADS
_ADJ_BLOCKS_PER_SM = 1      # the adjoint's strips: one wave of blocks


def cmul_eligible(sr, si, fr, fi) -> bool:
    """Whether :func:`spectral_mul` takes the planes and filter: one device
    and one dtype (float32 or float64) for all four, planes of one shape,
    contiguous on a 16-byte aligned base, and a contiguous 1-D filter of
    the planes' last-axis length, which is not 0.  Per-row filters,
    broadcast shapes and views take the plain expression
    (``ops.core.spectral_mul``)."""
    return (sr.dtype in _DTYPES
            and all(t.dtype == sr.dtype for t in (si, fr, fi))
            and all(t.device == sr.device for t in (si, fr, fi))
            and sr.ndim >= 1 and sr.shape == si.shape and sr.shape[-1] > 0
            and fr.ndim == 1 and fi.ndim == 1
            and fr.shape[0] == fi.shape[0] == sr.shape[-1]
            and all(t.is_contiguous() for t in (sr, si, fr, fi))
            and sr.data_ptr() % _ALIGN == 0 and si.data_ptr() % _ALIGN == 0)


# ------------------------------------------------------ plain versions

def cmul_plain(sr, si, fr, fi, conj: bool = False):
    """s * F (``conj``: s * conj(F)) in PyTorch: the step's two lines."""
    if conj:
        fi = -fi
    return sr * fr - si * fi, sr * fi + si * fr


def adjoint_plain(gr, gi, sr, si, fr, fi, conj: bool, planes: bool):
    """The adjoint in PyTorch: (g * conj(F), with F conjugated where
    ``conj``) where ``planes`` (else None, None), and the filter's
    gradient, the row sums of Re and Im of conj(s) * g in float64 (the
    imaginary one negated where ``conj``), in the filter's dtype."""
    xr = xi = None
    if planes:
        xr, xi = cmul_plain(gr, gi, fr, fi, not conj)
    dfr, dfi = _sums_plain(gr, gi, sr, si)
    return xr, xi, dfr, (-dfi if conj else dfi)


def _sums_plain(gr, gi, sr, si):
    h1 = sr.shape[-1]

    def rowsum(t):
        return t.reshape(-1, h1).sum(0, dtype=torch.float64).to(sr.dtype)
    return rowsum(gr * sr + gi * si), rowsum(gi * sr - gr * si)


# -------------------------------------------------------- the launches

@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(planes, fr=None, fi=None) -> None:
    """Raise on what the kernels do not take (the filter where given)."""
    a = planes[0]
    ts = (*planes, *(t for t in (fr, fi) if t is not None))
    if not all(t.is_cuda and t.device == a.device for t in ts):
        raise ValueError(f"cmul needs its planes and filter on one CUDA "
                         f"device, got {[t.device for t in ts]}")
    if a.dtype not in _DTYPES or any(t.dtype != a.dtype for t in ts):
        raise TypeError(f"cmul takes float32 or float64 planes and filter "
                        f"of one dtype, got {[t.dtype for t in ts]}")
    if any(t.shape != a.shape for t in planes) or a.ndim < 1:
        raise ValueError(f"cmul takes planes of one shape, got "
                         f"{[tuple(t.shape) for t in planes]}")
    if fr is not None and not (fr.ndim == fi.ndim == 1 and fr.shape[0]
                               == fi.shape[0] == a.shape[-1]):
        raise ValueError(f"cmul takes a 1-D filter of the planes' "
                         f"{a.shape[-1]} bins, got {tuple(fr.shape)}, "
                         f"{tuple(fi.shape)}")
    if not all(t.is_contiguous() for t in ts) or any(
            t.data_ptr() % _ALIGN for t in planes):
        raise ValueError("cmul takes contiguous planes on a 16-byte aligned "
                         "base and a contiguous filter")
    if a.numel() // max(1, a.shape[-1]) >= 2 ** 31:
        raise ValueError(f"cmul takes fewer than 2^31 rows, got "
                         f"{a.numel() // a.shape[-1]}")


def _rows(t):
    """A cotangent plane as the kernels take it: contiguous on an aligned
    base, copied once under ``cfftpack.pack`` where it is not so."""
    if not t.is_contiguous() or t.data_ptr() % _ALIGN:
        with profiling.span("cfftpack.pack"):
            t = t.clone(memory_format=torch.contiguous_format)
    return t


def _launch(sr, si, fr, fi, conj: bool = False):
    """One launch of the forward kernel on CUDA planes: new (tr, ti)."""
    _check((sr, si), fr, fi)
    tr, ti = torch.empty_like(sr), torch.empty_like(si)
    total = sr.numel()
    if total:
        lib = _build.load()
        fn = lib.cmul_f32 if sr.dtype == torch.float32 else lib.cmul_f64
        vectors = total * sr.element_size() // _ALIGN
        blocks = max(1, min(-(-vectors // (_THREADS * _UNROLL)),
                            _sms(sr.device) * _BLOCKS_PER_SM))
        err = _build.call("cmul", fn, sr.device, sr.data_ptr(),
                          si.data_ptr(), fr.data_ptr(), fi.data_ptr(),
                          tr.data_ptr(), ti.data_ptr(), total, sr.shape[-1],
                          int(conj), blocks)
        if err != 0:
            raise RuntimeError(f"cmul launch failed at {tuple(sr.shape)}, "
                               f"{sr.dtype}: CUDA error {err}")
    return tr, ti


def _strips(rows: int, h1: int, itemsize: int, device):
    """(blocks, groups a block, threads, N) of the adjoint: groups of N
    rows (16-byte vectors of N elements), a thread a vector of a group up
    to 512 threads, _ADJ_BLOCKS_PER_SM blocks an SM, each a strip."""
    n = _ALIGN // itemsize
    groups = -(-rows // n)
    threads = min(_ADJ_THREADS, 32 * -(-h1 // 32))
    per_block = -(-groups // (_sms(device) * _ADJ_BLOCKS_PER_SM))
    return -(-groups // per_block), per_block, threads, n


def _adj_launch(gr, gi, sr, si, fr, fi, conj: bool, planes: bool):
    """One call of the adjoint entry (the strips and the reduce) on CUDA
    planes: (xr, xi) where ``planes`` (else None, None) and the filter's
    gradient (dfr, dfi).  Without ``planes`` the filter is not read and
    may be None."""
    _check((gr, gi, sr, si), *((fr, fi) if planes else ()))
    h1 = sr.shape[-1]
    rows = sr.numel() // h1
    xr = xi = None
    if planes:
        xr, xi = torch.empty_like(sr), torch.empty_like(si)
    if not rows:
        dfr = torch.zeros(h1, dtype=sr.dtype, device=sr.device)
        return xr, xi, dfr, dfr.clone()
    dfr = torch.empty(h1, dtype=sr.dtype, device=sr.device)
    dfi = torch.empty(h1, dtype=sr.dtype, device=sr.device)
    blocks, per_block, threads, n = _strips(rows, h1, sr.element_size(),
                                            sr.device)
    part = torch.empty(2 * blocks * n * h1, dtype=torch.float64,
                       device=sr.device)
    lib = _build.load()
    fn = lib.cmul_adj_f32 if sr.dtype == torch.float32 else lib.cmul_adj_f64
    err = _build.call(
        "cmul", fn, sr.device, gr.data_ptr(), gi.data_ptr(), sr.data_ptr(),
        si.data_ptr(), fr.data_ptr() if planes else None,
        fi.data_ptr() if planes else None,
        xr.data_ptr() if planes else None, xi.data_ptr() if planes else None,
        part.data_ptr(), dfr.data_ptr(), dfi.data_ptr(), rows, h1, int(conj),
        blocks, per_block, threads)
    if err != 0:
        raise RuntimeError(f"cmul adjoint launch failed at "
                           f"{tuple(sr.shape)}, {sr.dtype}: CUDA error {err}")
    return xr, xi, dfr, dfi


# ----------------------------------------------------------- the maps

def spectral_mul(sr, si, fr, fi, conj: bool = False):
    """(tr, ti) = s * F over the last axis, F = fr + i fi broadcast over
    the rows (``conj``: s * conj(F)).  The caller guarantees
    :func:`cmul_eligible`.  Differentiable in the planes and the filter
    (one bilinear map, :func:`_mul_adjoint`)."""
    if _adjoint.needs_grad(sr, si, fr, fi):
        return _adjoint.bilinear(
            lambda a, b, c, d: spectral_mul(a, b, c, d, conj),
            lambda g, saved, needs: _mul_adjoint(g, saved, needs, conj),
            sr, si, fr, fi)
    run = cmul_plain if sr.device.type == "cpu" else _launch
    return run(sr, si, fr, fi, conj)


def _mul_adjoint(g, saved, needs, conj: bool):
    """The gradients of :func:`spectral_mul` for the cotangents ``g`` that
    ``needs`` (sr, si, fr, fi) asks for, None for the others."""
    sr, si, fr, fi = saved
    gr, gi = g
    if sr.is_cuda:
        gr, gi = _rows(gr), _rows(gi)
    want_s, want_f = needs[0] or needs[1], needs[2] or needs[3]
    xr = xi = dfr = dfi = None
    if _adjoint.needs_grad(gr, gi, sr, si, fr, fi):
        # the backward is differentiated: differentiable maps only
        if want_s:
            xr, xi = spectral_mul(gr, gi, fr, fi, not conj)
        if want_f:
            dfr, dfi = cmul_sums(gr, gi, sr, si)
            if conj:
                dfi = -dfi
    elif want_f:
        run = adjoint_plain if sr.device.type == "cpu" else _adj_launch
        xr, xi, dfr, dfi = run(gr, gi, sr, si, fr, fi, conj, want_s)
    elif want_s:
        xr, xi = spectral_mul(gr, gi, fr, fi, not conj)
    return tuple(x if n else None for x, n in zip((xr, xi, dfr, dfi), needs))


def cmul_sums(gr, gi, sr, si):
    """The filter's gradient of s * F for the cotangent g: the sums over
    every row of Re(conj(s) g) and Im(conj(s) g), (h1,) each.  Linear in g
    and in s apart; its adjoint for the cotangent c is s * c in g and
    g * conj(c) in s, :func:`spectral_mul` with c as the filter."""
    if _adjoint.needs_grad(gr, gi, sr, si):
        return _adjoint.bilinear(cmul_sums, _sums_adjoint, gr, gi, sr, si)
    if sr.device.type == "cpu":
        return _sums_plain(gr, gi, sr, si)
    return _adj_launch(gr, gi, sr, si, None, None, False, False)[2:]


def _sums_adjoint(c, saved, needs):
    gr, gi, sr, si = saved
    cr, ci = c
    if sr.is_cuda:
        cr, ci = cr.contiguous(), ci.contiguous()
    out = [None] * 4
    if needs[0] or needs[1]:
        out[:2] = spectral_mul(sr, si, cr, ci)
    if needs[2] or needs[3]:
        out[2:] = spectral_mul(gr, gi, cr, ci, True)
    return tuple(x if n else None for x, n in zip(out, needs))
