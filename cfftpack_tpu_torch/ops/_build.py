"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds),
loaded with ``ctypes``.  The library lands in ``build/cfftpack_tpu_torch/``
at the root of the checkout, named by a hash of the sources and flags,
so an edited source builds anew and an unchanged one loads at once;
``ptxas`` reports each kernel's registers and spills into a ``.log``
beside it.  This runs at the first kernel launch on a CUDA tensor,
never at import.  Every C entry is called through :func:`call`, which
holds the entry's span and counts its launches
(``utils.profiling``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..utils import profiling

_SPANS = {k: "cfftpack." + k for k in profiling.KERNELS}
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "cfftpack_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# xr, xi, yr, yi, twr, twi, dr, di, ptw, B, n, nstages, factors,
# tw_offs, dense_offs, npass, pass_len, inverse, tb, threads, scale, stream
_K1_ARGTYPES = ([_P] * 9 + [_I, _I, _I] + [_P] * 3 + [_I, _P, _I, _I, _I,
                                                      ctypes.c_double, _P])
# mode, a0, a1, b0, b1, tab, ptw, B, h, nstages, factors, npass, pass_len,
# tb, threads, scale, stream
_K1_REAL_ARGTYPES = ([_I] + [_P] * 6 + [_I] * 3 + [_P, _I, _P, _I, _I,
                                                 ctypes.c_double, _P])
# x, y, ptw, B, n, nstages, factors, npass, pass_len, inverse, tb, threads,
# scale, stream
_K1_CPLX_ARGTYPES = ([_P] * 3 + [_I] * 3 + [_P, _I, _P, _I, _I, _I,
                                            ctypes.c_double, _P])
# xr, xi, yr, yi, sr, si, t1r, t1i, ctwr, ctwi, cstages, cfac, coff,
# rtwr, rtwi, rstages, rfac, roff, cptw, rptw, fr, fi, nfilt, b, m, mode,
# csize, lshift, in_rs, ys, scale, stream
_STREAM_ARGTYPES = ([_P] * 10 + [_I, _P, _P] + [_P] * 2 + [_I, _P, _P]
                    + [_P] * 4 + [_I] * 6 + [_L, _L, ctypes.c_float, _P])
# xr, xi, yr, yi, sr, si, t1r, t1i, ctwr, ctwi, cstages, cfac, coff, spr,
# spi, split, ptw, rptw, fr, fi, b, m, lshift, in_rs, out_rs, scale, conj,
# stream
_SPLIT_ARGTYPES = ([_P] * 10 + [_I, _P, _P] + [_P] * 2 + [_I] + [_P] * 4
                   + [_I] * 3 + [_L, _L, ctypes.c_float, _I, _P])
# xr, xi, yr, yi, sr, si, t1r, t1i, ctwr, ctwi, cstages, cfac, coff,
# rtwr, rtwi, rstages, rfac, roff, cptw, rptw, b, m, inverse, csize,
# lshift, scale, stream
_NAT_ARGTYPES = ([_P] * 10 + [_I, _P, _P] + [_P] * 2 + [_I, _P, _P]
                 + [_P] * 2 + [_I] * 5 + [ctypes.c_float, _P])
# xr, xi, xs, yr, yi, sr, si, t1r, t1i, ctwr, ctwi, cstages, cfac, coff,
# rtwr, rtwi, rstages, rfac, roff, par, pai, pbr, pbi, cptw, rptw, b, m,
# mode, csize, lshift, scale, w0, dst, stream
_RSTREAM_ARGTYPES = ([_P] * 2 + [ctypes.c_longlong] + [_P] * 8
                     + [_I, _P, _P] + [_P] * 2 + [_I, _P, _P] + [_P] * 6
                     + [_I] * 5 + [ctypes.c_float] * 2 + [_I, _P])
# xr, xi, yr, yi, twr, twi, nstages, fac, off, ptw, npass, pass_len, phr,
# phi, w, b, n0, n1, mode, lshift, csize, scale, stream
_COL_ARGTYPES = ([_P] * 6 + [_I, _P, _P, _P, _I] + [_P] * 4 + [_I] * 6
                 + [ctypes.c_float, _P])
# xr, xi, yr, yi, sr, si, d4, t1r, t1i, twr, twi, nstages, fac, off,
# b, n2, rshift, inverse, stream
_FOURSTEP_ARGTYPES = [_P] * 11 + [_I, _P, _P] + [_I] * 4 + [_P]
# xr, xi, yr, yi, sr, si (null in one pass), dmr, dmi, d1r, d1i, t1r, t1i,
# b, m, inverse, natural, stream
_MM2_ARGTYPES = [_P] * 12 + [_I] * 4 + [_P]
# sr, si, fr, fi, tr, ti, total, h1, conj, blocks, stream
_CMUL_ARGTYPES = [_P] * 6 + [_L, _I, _I, _I, _P]
# gr, gi, sr, si, fr, fi, xr, xi, part, dfr, dfi, rows, h1, conj, blocks,
# groups_per_block, threads, stream
_CMUL_ADJ_ARGTYPES = [_P] * 11 + [_I] * 6 + [_P]
# ar, ai, a_sb, a_si, a_sk, br, bi, b_sb, b_sk, b_sj, cr, ci, c_sb, c_si,
# c_sj, tr, ti, M, N, K, batch, stream
_CGEMM_ARGTYPES = (([_P] * 2 + [_L] * 3) * 3 + [_P] * 2 + [_I] * 4 + [_P])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcfftpack_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = str(Path(tmp) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{err}")
            log.append(err)
        lib = str(Path(tmp) / out.name)
        cmd = [nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        out.with_suffix(".log").write_text("".join(log))
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, types in (("cfft_stockham_f32", _K1_ARGTYPES),
                        ("cfft_stockham_f64", _K1_ARGTYPES),
                        ("k1_real_f32", _K1_REAL_ARGTYPES),
                        ("k1_real_f64", _K1_REAL_ARGTYPES),
                        ("k1_cplx_f32", _K1_CPLX_ARGTYPES),
                        ("k1_cplx_f64", _K1_CPLX_ARGTYPES),
                        ("stream_fft_f32", _STREAM_ARGTYPES),
                        ("stream_split_f32", _SPLIT_ARGTYPES),
                        ("stream_nat_f32", _NAT_ARGTYPES),
                        ("rstream_fft_f32", _RSTREAM_ARGTYPES),
                        ("col_fft_f32", _COL_ARGTYPES),
                        ("fourstep_fft_f32", _FOURSTEP_ARGTYPES),
                        ("mm2_fft_f32", _MM2_ARGTYPES),
                        ("cgemm_f32", _CGEMM_ARGTYPES),
                        ("cmul_f32", _CMUL_ARGTYPES),
                        ("cmul_f64", _CMUL_ARGTYPES),
                        ("cmul_adj_f32", _CMUL_ADJ_ARGTYPES),
                        ("cmul_adj_f64", _CMUL_ADJ_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def call(kernel: str, fn, device, *args) -> int:
    """Call the C entry ``fn`` of ``kernel`` (its key in
    ``profiling.KERNELS``) with PyTorch's current stream on ``device`` as
    its last argument and ``device`` as the current CUDA device, inside
    the span ``cfftpack.<kernel>``; returns the entry's CUDA error code,
    and counts the launch in ``profiling.launches`` when it is 0."""
    with profiling.span(_SPANS[kernel]):
        err = _enter(fn, device, args)
    if err == 0:
        profiling.launches[kernel] += 1
    return err


def _enter(fn, device, args) -> int:
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def ints(values) -> ctypes.Array:
    """A C int array of ``values``, for an entry's small host tables."""
    return (ctypes.c_int * max(1, len(values)))(*values)
