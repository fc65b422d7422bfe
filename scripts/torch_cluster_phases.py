"""Where the time of the port's cluster kernels (K2, K3, K4, K7, K8)
goes, block by block, on one CUDA card.

    python3 scripts/torch_cluster_phases.py

Copies ``cfftpack_tpu_torch/csrc`` into ``build/cluster_phases/``, adds a
read of the card's nanosecond timer (``%globaltimer``) at each phase
boundary of ``cl_fft``, of ``cl_fft_rows_first`` and of the kernels'
stores (thread 0 of each block), builds that copy into its own library
and runs K3 and K7 at 2^22 elements, K8 (dct4), K4 (one filter slice)
and K2 both ways at (64, 65536), once each after a warm-up.  Prints, for
each call, the spread of the blocks' start times (the waves in which the
card runs them) and the median and 90th percentile of each phase a
block: columns first (K3, K7, K8, K2's forward), the column phase (the
first pass's loads and the m-point register passes), the first cluster
barrier, the exchange's loads, the second barrier, the 128-point row
passes, the store; rows first (K4, K2's inverse), the row phase (the row
loads, with K4's filter, and the 128-point passes), the first barrier,
the exchange's loads, the second
barrier, the m-point column passes with the store in the last.  Needs
the card; the kernels it builds are the committed ones with the timer
reads added, nothing else changed.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cfftpack_tpu_torch.ops import _build, rstream, stream_fft  # noqa: E402

MARKS = ("start", "column phase", "cluster barrier 1", "exchange loads",
         "cluster barrier 2", "row passes", "before the store", "store")
RF_MARKS = ("start", "row phase", "cluster barrier 1", "exchange loads",
            "cluster barrier 2", "column passes, store")
MAX_BLOCKS = 32768

TIMER = """
__device__ unsigned long long cl_ts[%d][8];
__device__ __forceinline__ unsigned long long cl_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define CL_MARK(i) \\
  if (threadIdx.x == 0 && blockIdx.x < %d) cl_ts[blockIdx.x][i] = cl_now();
""" % (MAX_BLOCKS, MAX_BLOCKS)

READ = """
extern "C" int %s(void* dst, int nblocks) {
  return (int)cudaMemcpyFromSymbol(dst, cl_ts, (size_t)nblocks * 64);
}
"""


def _patch(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"the source changed: {old!r} is not there once")
        text = text.replace(old, new)
    return text


def timed_sources(dst: Path) -> None:
    """The committed sources with the timer reads added."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build._CSRC, dst)
    head = dst / "cluster_pass.cuh"
    head.write_text(_patch(head.read_text(), [
        ('#include "stream_pass.cuh"\n', '#include "stream_pass.cuh"\n' + TIMER),
        ("  const int c = (int)cooperative_groups::this_cluster().block_rank();",
         "  CL_MARK(0)\n"
         "  const int c = (int)cooperative_groups::this_cluster().block_rank();"),
        ("                                   typename ClCol<M>::type{});\n  }\n"
         "  cooperative_groups::this_cluster().sync();",
         "                                   typename ClCol<M>::type{});\n  }\n"
         "  CL_MARK(1)\n  cooperative_groups::this_cluster().sync();\n"
         "  CL_MARK(2)"),
        ("  __device__ __forceinline__ void after_load() const {\n"
         "    cooperative_groups::this_cluster().sync();",
         "  __device__ __forceinline__ void after_load() const {\n"
         "    CL_MARK(3)\n    cooperative_groups::this_cluster().sync();\n"
         "    CL_MARK(4)"),
        ("                                     -1.0f, ClRow{});\n  }\n"
         "  return sh;",
         "                                     -1.0f, ClRow{});\n  }\n"
         "  CL_MARK(5)\n  return sh;"),
        # the rows-first order
        ("  const int rank = (int)cooperative_groups::this_cluster().block_rank();",
         "  CL_MARK(0)\n"
         "  const int rank = (int)cooperative_groups::this_cluster().block_rank();"),
        ("                                     -1.0f, ClRow{});\n  }\n"
         "  cl_sync();",
         "                                     -1.0f, ClRow{});\n  }\n"
         "  CL_MARK(1)\n  cl_sync();\n  CL_MARK(2)"),
        ("  __device__ __forceinline__ void after_load() const { cl_sync(); }",
         "  __device__ __forceinline__ void after_load() const {\n"
         "    CL_MARK(3)\n    cl_sync();\n    CL_MARK(4)\n  }"),
        ("                                   typename ClCol<M>::type{});\n"
         "  }\n}\n",
         "                                   typename ClCol<M>::type{});\n"
         "  }\n  CL_MARK(5)\n}\n")]))
    k3 = dst / "stream_fft.cu"
    k3.write_text(_patch(k3.read_text(), [
        ("  md.template store<M>(ClTile{cl_nat_smem, sh});\n}",
         "  CL_MARK(6)\n  md.template store<M>(ClTile{cl_nat_smem, sh});\n"
         "  CL_MARK(7)\n}"),
        ("  md.store(ClTile{cl_perm_smem, sh});\n}",
         "  CL_MARK(6)\n  md.store(ClTile{cl_perm_smem, sh});\n"
         "  CL_MARK(7)\n}")]) + READ % "cl_ts_k3")
    k7 = dst / "rstream_fft.cu"
    # its own copy of the table: the two files build separately
    k7.write_text("#define cl_ts cl_ts_rs\n" + _patch(k7.read_text(), [
        ("  md.template store<M>(ClTile{cl_rs_smem, sh});\n",
         "  CL_MARK(6)\n  md.template store<M>(ClTile{cl_rs_smem, sh});\n"
         "  CL_MARK(7)\n")]) + READ % "cl_ts_k7")


def report(read, name: str, nblocks: int, marks=MARKS) -> None:
    buf = np.zeros((nblocks, 8), dtype=np.uint64)
    if read(buf.ctypes.data, nblocks) != 0:
        raise RuntimeError("reading the timer table failed")
    t = buf.astype(np.float64)[:, :len(marks)] / 1e3    # us
    last = len(marks) - 1
    start = t[:, 0] - t[:, 0].min()
    span = (t[:, last] - t[:, 0].min()).max()
    q = np.percentile(start, [25, 50, 75, 100])
    print(f"  {name}: {nblocks} blocks in {span:.1f} us; block start "
          f"times p25/p50/p75/max {q[0]:.1f} / {q[1]:.1f} / {q[2]:.1f} / "
          f"{q[3]:.1f} us")
    for i in range(1, len(marks)):
        d = t[:, i] - t[:, i - 1]
        print(f"    {marks[i]:22s} median {np.median(d):6.2f}  p90 "
              f"{np.percentile(d, 90):6.2f} us")
    d = t[:, last] - t[:, 0]
    print(f"    {'a block':22s} median {np.median(d):6.2f}  p90 "
          f"{np.percentile(d, 90):6.2f} us")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_cluster_phases: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out = ROOT / "build" / "cluster_phases"
    timed_sources(out / "csrc")
    _build._CSRC = out / "csrc"
    _build.BUILD_DIR = out / "lib"
    lib = _build.load()
    for fn in (lib.cl_ts_k3, lib.cl_ts_k7):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in (16384, 65536, 131072):
        b = (1 << 22) // n
        C = stream_fft._cluster_size(n // 128)
        xr = torch.randn((b, n), generator=g, device="cuda")
        xi = torch.randn((b, n), generator=g, device="cuda")
        for _ in range(100):
            stream_fft.sfft_stream(xr, xi, n, False)
        stream_fft.sfft_stream(xr, xi, n, False)
        torch.cuda.synchronize()
        report(lib.cl_ts_k3, f"K3 ({b}, {n}) C={C}", b * C)
    n = 65536
    x = torch.randn((64, n), generator=g, device="cuda")
    C = stream_fft._cluster_size(n // 128)
    for mode in ("rfft", "dct2", "dct3"):
        for _ in range(100):
            rstream.launch(mode, n, x)
        rstream.launch(mode, n, x)
        torch.cuda.synchronize()
        report(lib.cl_ts_k7, f"K7 {mode} (64, {n}) C={C}", 32 * C)
    # K8 runs each row as one transform of n/2 = 128*256
    C = stream_fft._cluster_size(n // 256)
    for _ in range(100):
        rstream.launch("dct4", n, x)
    rstream.launch("dct4", n, x)
    torch.cuda.synchronize()
    report(lib.cl_ts_k7, f"K8 dct4 (64, {n}) C={C}", 64 * C)
    m = n // 128
    C = stream_fft._filter_cluster_size(m)
    xr = torch.randn((64, m, 128), generator=g, device="cuda")
    xi = torch.randn((64, m, 128), generator=g, device="cuda")
    fr = torch.randn((1, m, 128), generator=g, device="cuda")
    fi = torch.randn((1, m, 128), generator=g, device="cuda")
    for _ in range(100):
        stream_fft._launch(xr, xi, n, "filter", fr, fi)
    stream_fft._launch(xr, xi, n, "filter", fr, fi)
    torch.cuda.synchronize()
    report(lib.cl_ts_k3, f"K4 filter (64, {m}, 128) C={C}", 64 * C, RF_MARKS)
    for mode, C, marks in (("fwd", stream_fft._cluster_size(m), MARKS),
                           ("inv", C, RF_MARKS)):
        for _ in range(100):
            stream_fft._launch(xr, xi, n, mode)
        stream_fft._launch(xr, xi, n, mode)
        torch.cuda.synchronize()
        report(lib.cl_ts_k3, f"K2 {mode} (64, {m}, 128) C={C}", 64 * C, marks)


if __name__ == "__main__":
    main()
