"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds) and
loaded with ``ctypes``.  The library lands in ``build/cfftpack_tpu_torch/``
at the root of the checkout, named by a hash of the sources and flags,
so an edited source builds anew and an unchanged one loads at once.
This runs at the first kernel launch on a CUDA tensor, never at import.
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

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "cfftpack_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# xr, xi, yr, yi, twr, twi, dr, di, B, n, nstages, factors, tw_offs,
# dense_offs, inverse, tb, threads, stream
_K1_ARGTYPES = [_P] * 8 + [_I, _I, _I] + [_P] * 3 + [_I, _I, _I, _P]


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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cus = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name in ("cfft_stockham_f32", "cfft_stockham_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _K1_ARGTYPES
        fn.restype = ctypes.c_int
    return lib
