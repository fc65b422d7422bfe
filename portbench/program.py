"""What the benchmark takes from the program besides the calls its
configurations make: the kernel library and the names of its kernels."""
from __future__ import annotations

import re
import time
from pathlib import Path


def load_library() -> float | None:
    """Load the port's kernel library, building it first where the
    checkout has none; the seconds the build took, or None."""
    from cfftpack_tpu_torch.ops import _build
    built = _build.library_path().is_file()
    t = time.perf_counter()
    _build.load()
    return None if built else time.perf_counter() - t


def kernel_names() -> frozenset:
    """The names of the port's hand-written kernels: every ``__global__``
    function in its ``csrc/`` sources."""
    import cfftpack_tpu_torch
    csrc = Path(cfftpack_tpu_torch.__file__).resolve().parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*[(<]")
    return frozenset(m.group(1) for f in sorted(csrc.glob("*.cu*"))
                     for m in pat.finditer(f.read_text()))
