"""Drive cfftpack_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout (K1,
``cfftpack_tpu_torch/csrc/stockham_fft.cu``; K2, K3, K4 and K5,
``csrc/stream_fft.cu``, K3 and K2's forward at m = 128 .. 1024 on the
thread-block cluster of ``csrc/cluster_pass.cuh`` and at 2048 and 4096
on K5's register kernels, K4 and K2's inverse on the cluster in its
rows-first order; K7 and K8, ``csrc/rstream_fft.cu``, both on the same cluster
engine at those m; K6 and K9,
``csrc/col_fft.cu``; K10, ``csrc/fourstep_fft.cu``; K11,
``csrc/mm2_fft.cu``), holds each against its plain PyTorch version and
``torch.fft`` or scipy at the main path's shapes, then drives the main
path through the public entry points (the bench headline ``fft_split``
at n = 1024 x 4096, the flagship rfft -> multiply -> irfft step, the
conv option pricer in float64 and in float32 at the 2^20 grid,
Bluestein and four-step lengths, ``fft_split`` through the stream
kernel at 65536 and its split (K5) at 2^20 and 2^21 under every norm
and at 786432 and 1572864 (the stage-loop column pass),
the streaming filter at 65536 and at 2^20,
``rfft_split``/``irfft_split`` and the DCT/DST types 2-4 at
(64, 65536), ``dct`` at (4096, 1024), ``dctn`` at (4, 1024, 1024), a
float64 DCT round trip, and the 2-D path through the column kernels:
``fft2_split``/``ifft2_split`` at (4, 1024, 1024) and
(64, 1024, 1024), complex ``fft2``, ``rfft2_split``/``irfft2_split``
and ``dctn``/``idctn`` at (64, 1024, 1024), ``fft_split`` and
``ifft_split`` with ``impl="pallas"`` through the four-step kernel at
(1024, 4096), (64, 65536) and (16, 262144), the two-matmul FFT at
(2048, 2048) and (128, 32768), ``gdft``/``igdft``, the DCT/DST types
5-8 and ``circular_convolve`` at (4096, 1024); the float64 ``*_hp``
names at (4096, 1024), (64, 65536) and (4, 1024, 1024), every
``compat`` family on the golden inputs and two plans over (4096, 1024),
the QMC Asian option against the reference binary and at 2^20 x 128 in
float32, the VG distribution and Monte-Carlo at 2^24 draws, and the
callable bond on the short-rate lattice; then, in phase 36, the
backward of every kernel at its PERF.md §6 shape and of the full-width
paths (the flagship step at batch 64 and 4096, ``fft_split`` at (4096,
1024), ``rfilter_split`` at (64, 65536) and (16, 2^20), ``dct``/``idct``
type 2 and ``dst`` type 4 at (64, 65536), ``fft2_split``,
``rfft2_split`` and ``dctn`` at (64, 1024, 1024), ``fft_hp`` at (4096,
1024) complex128) with every plain version refused on the card, its
launches, its gradients against torch.fft's autograd, autograd through
the plain versions or scipy, and its times and peak memory); in phase
37 the backward through the parallel layer on a one-rank NCCL group
(``fft_fourstep_split`` at (64, 2^20) in both orders and
``fft_fourstep`` with ``overlap_chunks=4``, ``fft2_sharded_split`` and
``rfft2_sharded_split`` at (16, 4096, 4096), ``dctn2_sharded`` at
(64, 1024, 1024)) against float64 oracles, with its collectives
counted; in phase 38 the port's demos and validation (the five tables of
``examples/torch_pricing_demo.py``, ``examples/torch_sharded_demo.py``
on a one-rank NCCL group and the float32 golden table of
``scripts/torch_validate.py``) with every plain version refused, their
launches and wall times, the deterministic tables against their CPU
runs; in phase 39 K1's interleaved complex mode under ``fft``/``ifft``
at every register length in both dtypes and on every input layout
(conjugate and negative bits, strided and transposed rows, offsets, no
rows) against ``torch.fft``, one K1 launch a transform, and a profiled
contiguous round trip at (4096, 1024) complex128 launching K1 alone;
and checks each result.  Each path runs with the launch
counts set to 0 just before it and read just after.  Prints CUDA-event
times of the kernels, their plain versions and the PyTorch calls that
compute the same functions, the measurements behind K1's rows a block,
one JSON line of the backwards (phase 36) and one of phase 37, a
profiler breakdown of the 2-D routes, of K10's and K11's passes and of
K1, K2, K3, K4, K5, K7 and K8 with their kernel rows a call, sweeps of
the cluster size, K6 and K9 alone by device time with a sweep of K6's
lanes and cluster size, one JSON line describing the kernels (each with
its bound on this card), and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero; without a CUDA card it exits non-zero before printing a
result.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import scipy.fft
import torch

import cfftpack_tpu_torch as ct
from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.config import fwd_scale, inv_scale
from cfftpack_tpu_torch.entry import entry
from cfftpack_tpu_torch.models import (bs_cf, conv_bsvg_option,
                                       conv_option_price)
from cfftpack_tpu_torch.ops import _adjoint, _build, cmul, colfft, core
from cfftpack_tpu_torch.ops import fourstep_fft, fused_fft, rstream, stream_fft
from cfftpack_tpu_torch.utils import profiling

# the modules, not the functions of the same names that ops exports
dct_ops = importlib.import_module("cfftpack_tpu_torch.ops.dct")

DEV = "cuda"
# the reference's variance-gamma benchmark (test/vargamma.c:108-121) and
# the reference binary's conv price at N = 2^16 (tests/test_models.py)
VG = dict(S=100.0, K=98.0, sigma=0.12, theta=-0.14, kappa=0.2, t=1.0, r=0.05)
VG_CONV = 9.342473370823516
# phase 2: the CPU test's lengths plus every length of the register
# kernel (480 .. 8192; 8192 is float32 only), ragged and full batches
K1_SIZES = (4, 8, 60, 64, 243, 480, 512, 899, 960, 1024, 2048, 4096, 8192)
K1_BATCHES = (37, 4096)
# the worst errors of the previous version of this script on an H100
# (700 W), before K1's register passes and the fused K5 route, printed
# beside this run's: phase 2, K1 vs plain and torch.fft per dtype; phase 9,
# the K5 route vs plain (the backward forward) and torch.fft (that and the
# forward-norm inverse; that version checked fewer norms)
BEFORE_WORST = {"K1 float32": (3.200e-07, 2.815e-07),
                "K1 float64": (5.532e-16, 9.266e-15),
                "K5": (4.93e-07, 1.98e-07)}
# phase 3: m = 16, 32, 48 (radix 3), 80 (radix 5), 512, 768, 4096 (the cap)
STREAM_SIZES = (2048, 4096, 6144, 10240, 65536, 98304, 524288)
STREAM_MODES = ("fwd", "inv", "fwd_nat", "inv_nat", "filter")
STREAM_KERNEL = {"fwd": "K2", "inv": "K2", "fwd_nat": "K3", "inv_nat": "K3",
                 "filter": "K4"}
# phase 3: K3 on each of its routes, both ways with a scale: the cluster
# route (m = 128 .. 1024), the register route (2048, 4096), the stage loop
# (768)
K3_M = (128, 256, 512, 1024, 2048, 4096, 768)
# phase 3: K4 on its cluster (m = 128 .. 1024) and on the stage loop
# (768), s = 1 and 2, with a scale, into the strided planes of paired rows
K4_M = (128, 256, 512, 1024, 768)
# phase 3: K2 on each of its routes, both ways, the forward also from
# the strided planes of paired rows: the cluster (m = 128 .. 1024), the
# forward's register kernels (2048, 4096), the stage loop (48, 768 and
# the inverse at 2048, 4096)
K2_M = (128, 256, 512, 1024, 2048, 4096, 48, 768)
# phase 3b: K7 at n = 128*m and K8 (dct4 and dst4) at n = 2*128*m,
# m = 16, 48 (radix 3), 80 (radix 5), 128, 256, 512 and 1024 (the cluster
# route), 4096
RSTREAM_M = (16, 48, 80, 128, 256, 512, 1024, 4096)
# phase 25c: the cluster sizes swept at m = 512 (K3 and K7) and 256 (K8),
# K4's at every m of its cluster, and K2's both ways at m = 128, 256, 512
C_SWEEP = (4, 8, 16)
K4_C_SWEEP = (2, 4, 8, 16)
K2_SWEEP_M = (128, 256, 512)
# phase 3c: K6 and K9 at every compiled register length (512 .. 4096, the
# cap) and at stage-loop lengths (16, radix 3 and 5); n1 = 513 is the
# packed width of rfft2 at 1024, n1 = 5 is under every lane count
COL_N0 = (16, 48, 80, 512, 1024, 2048, 4096)
COL_N1 = (5, 128, 513, 1024)
# phase 19: K6's lanes a block and blocks a cluster, (L, C), swept on the
# register route
COL_LANE_SWEEP = (((64, 512, 1024), ((8, 1), (16, 1), (32, 1))),
                  ((64, 1024, 1024), ((4, 1), (8, 1), (8, 2), (16, 1))),
                  ((64, 2048, 1024), ((4, 1), (4, 4), (8, 1), (8, 2))),
                  ((16, 4096, 1024), ((2, 1), (4, 1), (4, 2), (4, 4),
                                      (4, 8))))
# phase 3d: every K10 length (ragged column groups at the two lengths
# whose pass A tiles span several transforms), and K11 at the smallest m,
# odd and ragged m, the edges of the one-pass kernel's three tile heights
# (16, 32, 64 = the one-pass cap), cap + 1, 128 and the cap of the kernel
K10_SIZES = (1024, 4096, 16384, 65536, 262144)
K10_RAGGED = {1024: (1, 5), 4096: (1, 5)}
K11_M = (2, 3, 16, 17, 32, 33, 64, 65, 100, 128, 255, 256)
# the product alone: (M, N, K) of K10's pass A, of K11's cap, and ragged
PRODUCT_SHAPES = ((64, 1024, 64), (256, 128, 256), (3, 128, 3),
                  (255, 128, 255))
# (inverse, natural spectrum): K11's four forms
K11_FORMS = ((False, True), (False, False), (True, True), (True, False))
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
           "K11", "cmul")
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s,
# float32 flop/s outside the tensor cores, and dense TF32 flop/s in them;
# a float32-accurate 3xTF32 product does a third of that in useful work
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
X3_FLOP_S = TF32_FLOP_S / 3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok  {what}")


def fmt_pair(was) -> str:
    return ", ".join("not measured" if v is None else f"{v:.3e}" for v in was)


def rel_err(got, want) -> float:
    got = got.to(torch.complex128) if got.is_complex() else got.double()
    want = want.to(torch.complex128) if want.is_complex() else want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def real(shape, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEV, dtype=dtype)


def pair(shape, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=DEV, dtype=dtype),
            torch.randn(shape, generator=g, device=DEV, dtype=dtype))


def rstream_plain(mode, n, x, xi=None, *, scale=1.0, w0=1.0, dst=False):
    """The plain version of each K7/K8 mode, in ``rstream.launch``'s
    contract."""
    if mode == "irfft":
        h1 = n // 2 + 1
        return rstream._irfft_plain(x.reshape(-1, h1), xi.reshape(-1, h1), n,
                                    scale)
    if mode == "dct4":
        return dct_ops._dct4_stream_plain(x.reshape(-1, n), n, scale, dst)
    if mode == "rfft":
        return rstream._rfft_plain(x.reshape(-1, n), n, scale)
    fn = {"dct2": rstream._dct2_plain, "dct3": rstream._dct3_plain}[mode]
    return fn(x.reshape(-1, n), n, scale, w0)


def colfft_plain_launch(mode, x, xi=None, w=None, scale=1.0):
    """The plain version of each K6/K9 mode, in ``colfft._launch``'s
    contract."""
    if mode in ("fwd", "inv"):
        return colfft.colfft_plain(x, xi, mode == "inv", scale)
    return colfft.coldct_plain(x, int(mode[-1]), w, scale)


def bound_ms(nbytes: float, flops: float):
    """The least time this card could take: the larger of the bytes over
    its memory rate and the operations over its float32 rate, and which
    of the two it is."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fft_flops(count: float, n: int) -> float:
    """5 n log2 n for each of ``count`` complex transforms of length n."""
    return 5.0 * count * n * np.log2(n)


@contextlib.contextmanager
def plain_engine():
    """Run the transform path with the kernels' plain versions in place
    of the kernels, on the same card, for comparison and timing only."""
    kernel, stream_launch = fused_fft.sfft_fused, stream_fft._launch
    real_launch, cplx_launch = fused_fft._real_launch, fused_fft._cplx_launch
    rstream_launch, col_launch = rstream.launch, colfft._launch
    four_launch, mm2_launch = fourstep_fft._launch, stream_fft._mm2_launch
    cmul_launch, cmul_adj_launch = cmul._launch, cmul._adj_launch

    def plain(xr, xi, n, inverse, scale=1.0):
        shape = xr.shape
        yr, yi = fused_fft.sfft_plain(xr.reshape(-1, n), xi.reshape(-1, n),
                                      n, inverse)
        return (yr * scale).reshape(shape), (yi * scale).reshape(shape)

    fused_fft.sfft_fused = plain
    fused_fft._real_launch = fused_fft._real_plain_rows
    fused_fft._cplx_launch = fused_fft._cplx_plain
    stream_fft._launch = stream_fft.stream_plain
    rstream.launch = rstream_plain
    colfft._launch = colfft_plain_launch
    fourstep_fft._launch = fourstep_fft.sfft_fourstep_plain
    stream_fft._mm2_launch = stream_fft.sfft_mm2_plain
    cmul._launch, cmul._adj_launch = cmul.cmul_plain, cmul.adjoint_plain
    try:
        yield
    finally:
        fused_fft.sfft_fused = kernel
        fused_fft._real_launch = real_launch
        fused_fft._cplx_launch = cplx_launch
        stream_fft._launch = stream_launch
        rstream.launch = rstream_launch
        colfft._launch = col_launch
        fourstep_fft._launch = four_launch
        stream_fft._mm2_launch = mm2_launch
        cmul._launch, cmul._adj_launch = cmul_launch, cmul_adj_launch


@contextlib.contextmanager
def no_stream():
    """Take the stream kernels out of the dispatch (the routes before
    them: the four-step with K1 on its rows), for timing only."""
    cap = stream_fft._MAX_M
    stream_fft._MAX_M = 0
    try:
        yield
    finally:
        stream_fft._MAX_M = cap


@contextlib.contextmanager
def no_rstream():
    """Take K7 and K8 out of the dispatch (the half-length routes before
    them: K3 at n/2 between deinterleave and merge passes; the streaming
    filter too, which shares K7's gate), for timing only."""
    use, ok = core._use_rstream, dct_ops._dct4_stream_ok
    core._use_rstream = lambda *a: False
    dct_ops._dct4_stream_ok = lambda *a: False
    try:
        yield
    finally:
        core._use_rstream, dct_ops._dct4_stream_ok = use, ok


@contextlib.contextmanager
def k1_rows(tb: int):
    """K1's register kernel at tb rows a block, for timing."""
    rule = fused_fft._reg_tile_rows
    fused_fft._reg_tile_rows = lambda n, dtype: tb
    plan._LAUNCH_PLANS.clear()
    try:
        yield
    finally:
        fused_fft._reg_tile_rows = rule
        plan._LAUNCH_PLANS.clear()


@contextlib.contextmanager
def no_colfft():
    """Take K6 and K9 out of the dispatch (the route before them: the
    axis moved last around K1), for timing only."""
    gate = colfft.colfft_eligible
    colfft.colfft_eligible = lambda *a: False
    try:
        yield
    finally:
        colfft.colfft_eligible = gate


@contextlib.contextmanager
def col_lanes(n0: int, lanes: int, csize: int):
    """K6/K9's register route at n0 with ``lanes`` lanes a block and
    ``csize`` blocks a cluster."""
    rule = colfft._REG_LANES[n0], colfft._REG_CLUSTER[n0]
    colfft._REG_LANES[n0], colfft._REG_CLUSTER[n0] = lanes, csize
    plan._LAUNCH_PLANS.clear()
    try:
        yield
    finally:
        colfft._REG_LANES[n0], colfft._REG_CLUSTER[n0] = rule
        plan._LAUNCH_PLANS.clear()


def drive(fn, total: dict):
    """Run one main path with the counts set to 0 just before it; return
    its result and its launches, which are added to ``total``."""
    profiling.reset()
    out = fn()
    torch.cuda.synchronize()
    got = dict(profiling.launches)
    for k in KERNELS:
        total[k] += got[k]
    return out, got


def plain_run(fn, what: str):
    """fn's result under :func:`plain_engine`, which must launch no
    kernel: the comparison holds the kernels against their plain
    versions, not against themselves."""
    profiling.reset()
    with plain_engine():
        out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in profiling.launches.items() if v}
    check(not got, f"{what}: the plain engine launched no kernel ({got})")
    return out


def stream_reference(x, n: int, mode: str, f=None):
    """torch.fft (complex128) of what a stream mode computes, in the
    mode's output layout."""
    b, m = x.shape[0], n // 128
    xc = x.to(torch.complex128)
    if mode == "fwd":
        X = torch.fft.fft(xc.reshape(b, n)).reshape(b, 128, m)
        return X.transpose(1, 2)
    if mode == "fwd_nat":
        return torch.fft.fft(xc.reshape(b, n)).reshape(b, 128, m)
    if mode == "filter":
        xc = xc * f.to(torch.complex128)[torch.arange(b, device=x.device)
                                         % f.shape[0]]
    if mode in ("inv", "filter"):
        xc = xc.transpose(1, 2)
    return (torch.fft.ifft(xc.reshape(b, n)) * n).reshape(b, m, 128)


def host_us(fn, reps: int = 30) -> float:
    """Host time a call: the wall time of ``reps`` calls enqueued back to
    back (no synchronisation between them) over ``reps``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def median_ms(fn, reps: int = 30, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_route(name: str, fn, card: str, calls: int = 10) -> dict:
    """torch.profiler over ``calls`` calls of fn after 3 warm-up calls:
    device time and rows per call by kernel (kernel rows only), the
    CUDA-event time per call without the profiler, and the idle share
    1 - kernel time / event time.  A trace that records no device row at
    all, or kernel rows that are not a whole number a call (the profiler
    on the card has dropped some of a trace, at times several in a row),
    is taken again, up to five times, half a second apart."""
    from torch.profiler import ProfilerActivity, profile
    event_ms = median_ms(fn, reps=calls, warm=3)
    for attempt in range(6):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows, count, per_call = {}, {}, 0
        for k in prof.key_averages():
            # NCCL's ranges on the device timeline ("nccl:...") and the
            # port's spans there ("cfftpack.*", utils.profiling) span the
            # kernels or copies they issue: not kernel rows
            if (k.device_type == torch.autograd.DeviceType.CUDA
                    and not k.key.startswith(("nccl:", "cfftpack."))):
                t = getattr(k, "self_device_time_total", None)
                if t is None:
                    t = k.self_cuda_time_total
                rows[k.key] = t / calls
                count[k.key] = k.count / calls
                per_call += k.count
        if rows and per_call % calls == 0:
            break
        print(f"  profile {name}: {per_call} device rows in the trace of "
              f"{calls} calls, taken again")
    kern_us = sum(rows.values())
    idle = 1.0 - kern_us / (event_ms * 1e3)
    print(f"  profile {name}: {event_ms * 1e3:.1f} us per call, kernels "
          f"{kern_us:.1f} us in {per_call / calls:g} kernel rows a call, "
          f"idle {idle:.3f}  [{card}]")
    for kname, us in sorted(rows.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us:9.1f} us  {kname[:90]}")
    return {"event_us": event_ms * 1e3, "kernel_us": kern_us, "idle": idle,
            "rows": rows, "count": count, "launches": per_call / calls}


def mm2_reference(x, n: int, inverse: bool, natural: bool):
    """torch.fft (complex128) of what a K11 form computes on (b, n)
    complex input, in the form's layout."""
    b, m = x.shape[0], n // 128
    xc = x.to(torch.complex128)
    if not inverse:
        X = torch.fft.fft(xc)
        return X if natural else X.reshape(b, 128, m).transpose(
            1, 2).reshape(b, n)
    if not natural:
        xc = xc.reshape(b, m, 128).transpose(1, 2).reshape(b, n)
    return torch.fft.ifft(xc) * n


def mm2_dense_flops(b: int, n: int) -> float:
    """Real flops of K11's dense form in four-product complex
    arithmetic: 8*128*m*(m + 128) a transform."""
    m = n // 128
    return 8.0 * b * 128 * m * (m + 128)


def dense_rate(flops: float, us: float) -> str:
    """A dense product's rate beside its two yardsticks."""
    rate = flops / (us * 1e-6)
    return (f"{rate / 1e12:.2f} TFLOP/s of useful work: "
            f"{rate / X3_FLOP_S:.2f} of the 3xTF32 yardstick "
            f"({X3_FLOP_S / 1e12:.0f} TFLOP/s on {TF32_FLOP_S / 1e12:.0f} "
            f"TFLOP/s TF32), {rate / F32_FLOP_S:.2f} of the "
            f"{F32_FLOP_S / 1e12:.0f} TFLOP/s float32 rate")


def product_alone(lib, M: int, N: int, K: int, batch: int, case: str):
    """The product of csrc/cgemm.cuh alone, in one stride case of K11's
    callers, against a complex128 matmul: the error over max |C|."""
    tw = None
    if case == "A shared [k][i], B rows, C rows, twiddle":
        # the DFT matrix read with i contiguous, as both kernels read it
        ph = torch.rand(K, M, device=DEV) * 6.283185
        Ar, Ai = torch.cos(ph).t()[None], torch.sin(ph).t()[None]
        Br, Bi = pair((batch, K, N), torch.float32, seed=M + K)
        tw = pair((M, N), torch.float32, seed=N)
    else:
        Br, Bi = pair((1, K, N), torch.float32, seed=N + K)
        if case.startswith("A batch [k][i]"):
            Ar, Ai = (v.transpose(1, 2) for v in
                      pair((batch, K, M), torch.float32, seed=M))
            tw = pair((M, N), torch.float32, seed=N)
        else:
            Ar, Ai = pair((batch, M, K), torch.float32, seed=M)
    if case.endswith("C columns"):
        Cr, Ci = (torch.empty(batch, N, M, device=DEV).transpose(1, 2)
                  for _ in range(2))
    else:
        Cr, Ci = (torch.empty(batch, M, N, device=DEV) for _ in range(2))

    def strides(v):
        return (0 if v.shape[0] == 1 else v.stride(0), v.stride(1),
                v.stride(2))

    err = _build.call(
        "cgemm", lib.cgemm_f32, Ar.device, Ar.data_ptr(), Ai.data_ptr(),
        *strides(Ar), Br.data_ptr(), Bi.data_ptr(), *strides(Br),
        Cr.data_ptr(), Ci.data_ptr(), *Cr.stride(),
        *((None, None) if tw is None
          else (tw[0].data_ptr(), tw[1].data_ptr())), M, N, K, batch)
    if err != 0:
        raise RuntimeError(f"cgemm_f32 failed: CUDA error {err}")
    torch.cuda.synchronize()
    want = torch.matmul(torch.complex(Ar.double(), Ai.double()),
                        torch.complex(Br.double(), Bi.double()))
    if tw is not None:
        want = want * torch.complex(tw[0].double(), tw[1].double())
    return rel_err(torch.complex(Cr, Ci), want)


PRODUCT_CASES = ("A shared [k][i], B rows, C rows, twiddle",
                 "A batch [i][k], B shared, C rows",
                 "A batch [i][k], B shared, C columns",
                 "A batch [k][i], B shared, C rows, twiddle")


def pass_a_flops(b: int, n: int) -> float:
    """Real flops of K10's dense DFT-64 in four-product complex
    arithmetic: 8*64*n a transform."""
    return 8.0 * b * 64 * n


def k5_before(xr, xi, n: int):
    """The unfused K5 route, timed beside the fused one: the s-point DFT
    and the split twiddle as torch ops, K2 at s-fold batch, the riffle as
    a torch permute copy."""
    s = stream_fft._filter_split_factor(n)
    n_in, b = n // s, xr.shape[0]
    m = n_in // 128
    zr, zi = stream_fft._split_pre(xr.reshape(b, s, n_in),
                                   xi.reshape(b, s, n_in), n, s)
    Cr, Ci = stream_fft._launch(zr.reshape(b * s, m, 128),
                                zi.reshape(b * s, m, 128), n_in, "fwd")
    return (Cr.reshape(b, s, m, 128).permute(0, 3, 2, 1).reshape(b, n),
            Ci.reshape(b, s, m, 128).permute(0, 3, 2, 1).reshape(b, n))


def k5_filter_before(x, fr, fi, n: int):
    """The unfused streaming filter past the cap, timed beside the fused one:
    the filter's extension and permuted slices, the split pre-pass as
    torch ops, K2 forward and K4 at s-fold batch through copies of the
    paired rows, the conjugate twiddle and inverse butterfly as torch ops,
    and the stack of the two planes."""
    h = n // 2
    ffr = torch.cat([fr, fr[1:h].flip(-1)])
    ffi = torch.cat([fi, -fi[1:h].flip(-1)])
    s = stream_fft._filter_split_factor(n)
    n_in, P = n // s, x.shape[0] // 2
    m = n_in // 128
    xp = x.reshape(P, 2, s, n_in)
    zr, zi = stream_fft._split_pre(xp[:, 0], xp[:, 1], n, s)
    Zr, Zi = stream_fft._launch(zr.reshape(P * s, m, 128),
                                zi.reshape(P * s, m, 128), n_in, "fwd")
    fpr = ffr.reshape(128, m, s).permute(2, 1, 0).contiguous()
    fpi = ffi.reshape(128, m, s).permute(2, 1, 0).contiguous()
    wr, wi = stream_fft._launch(Zr, Zi, n_in, "filter", fpr, fpi)
    twr, twi = stream_fft._device_split(n, s, x.device)
    ur, ui = fused_fft._cmul_tab(wr.reshape(P, s, n_in),
                                 wi.reshape(P, s, n_in), twr.reshape(s, -1),
                                 -twi.reshape(s, -1))
    wr, wi = fused_fft._butterfly(ur, ui, s, inverse=True)
    return torch.stack([wr.reshape(P, n), wi.reshape(P, n)], dim=1)


def bs_closed_form(S, K, sigma, t, r):
    from scipy.special import ndtr
    d1 = (np.log(S / K) + t * (r + 0.5 * sigma * sigma)) / (sigma * np.sqrt(t))
    d2 = d1 - sigma * np.sqrt(t)
    return S * ndtr(d1) - K * ndtr(d2) * np.exp(-r * t)


# phase 31-33 widths: the (batch, n) of the *_hp calls, the long and 2-D
# fft_hp shapes, the sfft_hp quad, the f32 Asian QMC samples, the VG
# Monte-Carlo draws
HP_SHAPE, HP_LONG, HP_2D, HP_QUAD = ((4096, 1024), (64, 65536),
                                     (4, 1024, 1024), (64, 4096))
ASIAN_SAMPLES, VG_SAMPLES = 1 << 20, 1 << 24


def hp_oracles(x, xc):
    """float64 references of phase 31's calls, from torch.fft in
    complex128 and scipy on a host copy (the fftpack norm: the forward
    scaled by 1/n, the inverse unscaled)."""
    n = x.shape[-1]
    xh = x.cpu().numpy()
    return {
        "fft_hp": torch.fft.fft(xc, norm="forward"),
        "ifft_hp": torch.fft.ifft(xc, norm="forward"),
        "rfft_hp": torch.fft.rfft(x, norm="forward"),
        "dct_hp 2": torch.from_numpy(scipy.fft.dct(xh, 2) / n).to(DEV),
        "dct4_hp": torch.from_numpy(scipy.fft.dct(xh, 4) / n).to(DEV),
    }


def dst7_definition(x):
    """2 sum_j x[j] sin(pi (2k+1)(j+1) / (2n+1)), the fftpack DST-VII, as
    a float64 product on the card; the angle's integer part is reduced
    exactly before the sine."""
    n = x.shape[-1]
    k = torch.arange(n, device=DEV, dtype=torch.int64)
    m = torch.outer(2 * k + 1, k + 1) % (2 * (2 * n + 1))
    W = torch.sin(np.pi * m.double() / (2 * n + 1))
    return 2.0 * x @ W.T


def phase_f64_surface(total: dict, card: str) -> None:
    """Phase 31: the *_hp names in float64 at full width, each against
    torch.fft in complex128 or scipy and against its plain-engine run at
    1e-12 of max |X|, K1 launched by the one and no kernel by the
    other."""
    bar = 1e-12
    x = real(HP_SHAPE, torch.float64, seed=131)
    xc = torch.complex(*pair(HP_SHAPE, torch.float64, seed=132))
    n = HP_SHAPE[-1]
    oracle = hp_oracles(x, xc)
    calls = [("fft_hp", lambda: ct.fft_hp(xc), oracle["fft_hp"]),
             ("ifft_hp", lambda: ct.ifft_hp(xc), oracle["ifft_hp"]),
             ("rfft_hp", lambda: ct.rfft_hp(x), oracle["rfft_hp"]),
             ("dct_hp type 2", lambda: ct.dct_hp(x, 2), oracle["dct_hp 2"]),
             ("dct4_hp", lambda: ct.dct4_hp(x), oracle["dct4_hp"]),
             ("dst_hp type 7", lambda: ct.dst_hp(x, 7), dst7_definition(x))]
    inverses = {"fft_hp": ct.ifft_hp,
                "rfft_hp": lambda y: ct.irfft_hp(y, n),
                "dct_hp type 2": lambda y: ct.idct_hp(y, 2),
                "dct4_hp": lambda y: ct.idct4_hp(y),
                "dst_hp type 7": lambda y: ct.idst_hp(y, 7)}
    for name, fn, want in calls:
        print(f"phase 31: {name} {HP_SHAPE} f64 fftpack")
        t0 = time.perf_counter()
        y, got = drive(fn, total)
        wall = time.perf_counter() - t0
        check(got["K1"] > 0, f"K1 launched by {name} ({got})")
        plain = plain_run(fn, f"{name} plain")
        e_o, e_p = rel_err(y, want), rel_err(y, plain)
        check(y.dtype in (torch.float64, torch.complex128) and bool(
            torch.isfinite(torch.view_as_real(y) if y.is_complex()
                           else y).all()), "float64 output, finite")
        check(e_o < bar and e_p < bar, f"{name} vs oracle {e_o:.2e}, vs plain "
              f"{e_p:.2e} < {bar:g}; {wall * 1e3:.1f} ms wall [{card}]")
        if name in inverses:
            src = xc if name == "fft_hp" else x
            e_r = rel_err(inverses[name](y), src)
            check(e_r < bar, f"inverse of {name} vs x {e_r:.2e} < {bar:g}")
    del oracle, calls
    xl = torch.complex(*pair(HP_LONG, torch.float64, seed=133))
    for name, fn, want in (
            ("fft_hp", ct.fft_hp, torch.fft.fft(xl, norm="forward")),
            ("ifft_hp", ct.ifft_hp, torch.fft.ifft(xl, norm="forward"))):
        print(f"phase 31: {name} {HP_LONG} complex128 fftpack")
        y, got = drive(lambda: fn(xl), total)
        check(got["K1"] > 0, f"K1 launched by {name} ({got})")
        plain = plain_run(lambda: fn(xl), f"{name} {HP_LONG} plain")
        e_o, e_p = rel_err(y, want), rel_err(y, plain)
        check(e_o < bar and e_p < bar, f"{name} vs torch.fft {e_o:.2e}, vs "
              f"plain {e_p:.2e} < {bar:g}")
    del xl, y, plain, want
    print(f"phase 31: fft2_hp {HP_2D} complex128 fftpack")
    x2 = torch.complex(*pair(HP_2D, torch.float64, seed=134))
    y, got = drive(lambda: ct.fft2_hp(x2), total)
    check(got["K1"] > 0, f"K1 launched by fft2_hp ({got})")
    plain = plain_run(lambda: ct.fft2_hp(x2), "fft2_hp plain")
    e_o = rel_err(y, torch.fft.fft2(x2, norm="forward"))
    e_p = rel_err(y, plain)
    check(e_o < bar and e_p < bar, f"fft2_hp vs torch.fft {e_o:.2e}, vs plain "
          f"{e_p:.2e} < {bar:g}")
    del x2, y, plain
    print(f"phase 31: sfft_hp {HP_QUAD} quad, both ways")
    xq = torch.complex(*pair(HP_QUAD, torch.float64, seed=135))
    nq = HP_QUAD[-1]
    quad = []
    for v in (xq.real, xq.imag):
        hi = v.float()
        quad += [hi, (v - hi.double()).float()]
    for inverse in (False, True):
        q, got = drive(lambda: ct.sfft_hp(*quad, nq, inverse), total)
        check(got["K1"] > 0, f"K1 launched by sfft_hp ({got})")
        y = torch.complex(q[0].double() + q[1].double(),
                          q[2].double() + q[3].double())
        want = (torch.fft.ifft(xq, norm="forward") if inverse
                else torch.fft.fft(xq))
        p = plain_run(lambda: ct.sfft_hp(*quad, nq, inverse),
                      f"sfft_hp inverse={inverse} plain")
        plain = torch.complex(p[0].double() + p[1].double(),
                              p[2].double() + p[3].double())
        e_o, e_p = rel_err(y, want), rel_err(y, plain)
        check(all(v.dtype == torch.float32 for v in q) and e_o < bar
              and e_p < bar, f"sfft_hp inverse={inverse} quad vs torch.fft "
              f"{e_o:.2e}, vs plain {e_p:.2e} < {bar:g}")
    hp_ms = median_ms(lambda: ct.fft_hp(xc))
    torch_ms = median_ms(lambda: torch.fft.fft(xc, norm="forward"))
    print(f"  fft_hp {HP_SHAPE} complex128: {hp_ms:.4f} ms, torch.fft.fft "
          f"complex128 {torch_ms:.4f} ms ({hp_ms / torch_ms:.2f}x)  [{card}]")


GOLDEN = "tests/golden/golden.npz"
COMPAT_FAMILIES = ("fft", "rfft", "dct", "dct1", "dst", "dst1", "dct4", "dst4",
                   "dct5", "dct6", "dct7", "dct8", "dst5", "dst6", "dst7",
                   "dst8")


def golden_tol(n) -> float:
    """tests/test_golden.py's bar: absolute, 1e-12 * max(1, sqrt(n))."""
    return 1e-12 * max(1.0, n ** 0.5)


def phase_compat(total: dict, card: str) -> None:
    """Phase 32: every compat family, forward and inverse, on the golden
    inputs moved to the card at test_golden.py's bars; then two plans
    over a (4096, 1024) float64 batch against the plain engine, which
    launches no kernel."""
    from cfftpack_tpu_torch import compat as cc
    gold = np.load(Path(__file__).resolve().parent / GOLDEN)

    def dev(key):
        return torch.from_numpy(gold[key]).to(DEV)

    def close(got, key, atol, what):
        err = float(np.abs(got.cpu().numpy() - gold[key]).max())
        check(err <= atol, f"{what} vs golden {err:.2e} <= {atol:.2e}")

    print("phase 32: compat families on the golden inputs, on the card")
    t0 = time.perf_counter()
    profiling.reset()
    for fam in COMPAT_FAMILIES:
        sizes = sorted(int(k.split("_")[-1]) for k in gold.files
                       if k.startswith(f"{fam}_in_"))
        for n in sizes:
            if (fam == "dct1" and n < 2) or (fam in ("dct4", "dst4")
                                             and n % 2):
                continue
            for ortho, sfx in ((False, ""), (True, "_ortho")):
                f = getattr(cc, f"{fam}_create")(n)
                cc.fft_ortho(f, ortho)
                x = dev(f"{fam}_in_{n}")
                fwd = getattr(f, "transform", f.forward)
                bar = golden_tol(n) * (n if (fam, ortho) == ("dct1", True)
                                       else 1)
                close(fwd(x), f"{fam}_fwd_{n}{sfx}", bar,
                      f"{fam}{sfx} forward n={n}")
                if f"{fam}_inv_{n}{sfx}" in gold.files:
                    close(f.inverse(x), f"{fam}_inv_{n}{sfx}",
                          golden_tol(n) * n, f"{fam}{sfx} inverse n={n}")
                if fam == "rfft":
                    back = f.inverse(dev(f"rfft_fwd_{n}{sfx}"))
                    err = float((back - x).abs().max())
                    check(err <= golden_tol(n), f"rfft{sfx} round trip n={n} "
                          f"{err:.2e}")
    for l, m in ((4, 4), (8, 6), (6, 10)):
        f = cc.fft2_create(l, m)
        x = dev(f"fft2_in_{l}x{m}")
        close(cc.fft2_forward(f, x), f"fft2_fwd_{l}x{m}", golden_tol(l * m),
              f"fft2 forward {l}x{m}")
        close(cc.fft2_inverse(f, x), f"fft2_inv_{l}x{m}",
              golden_tol(l * m) * l * m, f"fft2 inverse {l}x{m}")
    for M, N in ((4, 4), (8, 6), (6, 10), (64, 48)):
        f = cc.dct_2d_create(M, N)
        x = dev(f"dct2d_in_{M}x{N}")
        close(cc.dct_2d_forward(f, x), f"dct2d_fwd_{M}x{N}",
              golden_tol(M * N), f"dct_2d forward {M}x{N}")
        close(cc.dct_2d_inverse(f, x), f"dct2d_inv_{M}x{N}",
              golden_tol(M * N) * M * N, f"dct_2d inverse {M}x{N}")
    for n in (4, 8, 16, 60, 960):
        for a, b in ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5),
                     (0.25, 0.1)):
            key = f"{n}_{a}_{b}"
            f = cc.gdft_create(n, a, b)
            x = dev(f"gdft_in_{key}")
            y = cc.gdft_forward(f, x)
            close(y, f"gdft_fwd_{key}", golden_tol(n), f"gdft forward {key}")
            err = float((cc.gdft_inverse(f, y) - x).abs().max())
            check(err <= golden_tol(n), f"gdft round trip {key} {err:.2e}")
    torch.cuda.synchronize()
    got = dict(profiling.launches)
    for k in KERNELS:
        total[k] += got[k]
    check(got["K1"] > 0, f"K1 launched by the golden families ({got}); "
          f"{time.perf_counter() - t0:.2f} s wall [{card}]")
    for name, plan, x in (
            (f"FFTPlan({HP_SHAPE[-1]})", cc.fft_create(HP_SHAPE[-1]),
             torch.complex(*pair(HP_SHAPE, torch.float64, seed=141))),
            (f"DCTPlan({HP_SHAPE[-1]})", cc.dct_create(HP_SHAPE[-1]),
             real(HP_SHAPE, torch.float64, seed=142))):
        for ortho in (False, True):
            cc.fft_ortho(plan, ortho)
            print(f"phase 32: {name} ortho={ortho} over {HP_SHAPE} f64")
            for way in ("forward", "inverse"):
                fn = getattr(plan, way)
                y, got = drive(lambda: fn(x), total)
                check(got["K1"] > 0, f"K1 launched by {name}.{way} ({got})")
                want = plain_run(lambda: fn(x), f"{name}.{way} plain")
                e_p = rel_err(y, want)
                check(e_p < 1e-12, f"{name}.{way} vs plain {e_p:.2e} < 1e-12")


# the reference binary's anchors (tests/test_models.py)
ASIAN_ANCHORS = (1.331389466495620, 1.330757038060973, 1.326960062625530)
VG_CDF_ANCHORS = {512: 0.000098313654346, 1024: 0.344910732462461,
                  1536: 0.999999669680804, 2047: 1.000000000000000}
VG_TARGET = 9.3424659413582116       # QuantLib (vargammaql.cpp)


def timed_drive(name: str, fn, total: dict, card: str):
    t0 = time.perf_counter()
    out, got = drive(fn, total)
    wall = time.perf_counter() - t0
    print(f"  {name}: {wall * 1e3:.1f} ms wall, launches {got}  [{card}]")
    return out, got


def phase_models(total: dict, card: str) -> None:
    """Phase 33: the Monte-Carlo, QMC and short-rate models on the card
    at full width, against the reference binary's anchors, their
    float64 runs and their CPU runs."""
    from cfftpack_tpu_torch.models import (asian_option_qmc,
                                           asian_option_qmc_device,
                                           callable_bond_demo,
                                           vg_mc_price_device)
    from cfftpack_tpu_torch.models.montecarlo import vg_distribution_grid

    print("phase 33: asian_option_qmc samples=500 steps=128 f64, runs 0..2")
    for run, want in enumerate(ASIAN_ANCHORS):
        v, got = timed_drive(f"asian_option_qmc run {run}", lambda: (
            asian_option_qmc(steps=128, samples=500, run_index=run,
                             device=DEV)), total, card)
        check(got["K1"] > 0, f"K1 launched ({got})")
        check(abs(v - want) < 1e-12, f"run {run}: {v!r} vs the reference "
              f"binary {want!r}, {abs(v - want):.2e} < 1e-12")
    print(f"phase 33: asian_option_qmc_device samples={ASIAN_SAMPLES} "
          "steps=128 f32")
    v32, got = timed_drive("asian_option_qmc_device f32", lambda: (
        asian_option_qmc_device(steps=128, samples=ASIAN_SAMPLES,
                                device=DEV)), total, card)
    check(got["K1"] > 0, f"K1 launched by the f32 pipeline ({got})")
    v64, _ = timed_drive("asian_option_qmc_device f64", lambda: (
        asian_option_qmc_device(steps=128, samples=ASIAN_SAMPLES, device=DEV,
                                dtype=torch.float64)), total, card)
    check(np.isfinite(v32) and abs(v32 - v64) < 2e-3,
          f"f32 {v32!r} vs f64 {v64!r}, {abs(v32 - v64):.2e} < 2e-3")
    print("phase 33: vg_distribution_grid n=2048 f64")
    (_, pdf), got = timed_drive("vg_distribution_grid", lambda: (
        vg_distribution_grid(0.12, -0.14, 0.2, 0.05, 1.0, 2048, device=DEV)),
        total, card)
    check(got["K1"] > 0, f"K1 launched ({got})")
    cum = np.cumsum(pdf)
    err = max(abs(cum[i] - w) for i, w in VG_CDF_ANCHORS.items())
    check(err < 1e-12, f"CDF vs the reference binary {err:.2e} < 1e-12")
    print(f"phase 33: vg_mc_price_device n=2048 samples={VG_SAMPLES} f32")
    vg, got = timed_drive("vg_mc_price_device", lambda: vg_mc_price_device(
        n=2048, samples=VG_SAMPLES, device=DEV), total, card)
    check(got["K1"] > 0, f"K1 launched ({got})")
    check(abs(vg - VG_TARGET) < 0.2,
          f"{vg!r} vs the QuantLib target {abs(vg - VG_TARGET):.2e} < 0.2")
    print("phase 33: callable_bond_demo model=1 nstep=200 n_fft=1024 f64")
    bond, got = timed_drive("callable_bond_demo", lambda: callable_bond_demo(
        model=1, nstep=200, n_fft=1024, device=DEV), total, card)
    check(got["K1"] > 0, f"K1 launched ({got})")
    t0 = time.perf_counter()
    host = callable_bond_demo(model=1, nstep=200, n_fft=1024, device="cpu")
    print(f"  callable_bond_demo on the CPU: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall")
    err = max(abs(a - b) / abs(b) for a, b in zip(bond, host))
    check(err < 1e-9, f"{bond} vs the CPU run {host}: {err:.2e} < 1e-9 "
          "relative")


# phase 34 widths: BASELINE configs[2] (one long transform, 2^20 x 64)
# and configs[3] (the 2-D FFT, 4096^2 x 64), complex64, and the real
# 2-D FFT at 16 images
FOURSTEP_SHAPE = (64, 1 << 20)
FFT2_SHAPE, RFFT2_SHAPE = (64, 4096, 4096), (16, 4096, 4096)


# the plain versions that the kernels' wrappers call on CPU tensors, as
# (module, name): no_plain_on_card makes each raise on a CUDA tensor
PLAIN_VERSIONS = (
    (fused_fft, "sfft_plain"), (fused_fft, "real_plain"),
    (fused_fft, "_cplx_plain"), (fused_fft, "_stockham"),
    (stream_fft, "stream_plain"), (stream_fft, "sfft_mm2_plain"),
    (rstream, "_rfft_plain"), (rstream, "_irfft_plain"),
    (rstream, "_dct2_plain"), (rstream, "_dct3_plain"),
    (dct_ops, "_dct4_stream_plain"), (colfft, "colfft_plain"),
    (colfft, "coldct_plain"), (colfft, "coldct2_plain"),
    (colfft, "coldct3_plain"), (fourstep_fft, "sfft_fourstep_plain"),
    (cmul, "cmul_plain"), (cmul, "adjoint_plain"))


@contextlib.contextmanager
def no_plain_on_card():
    """Every kernel's plain version raises on a CUDA tensor while a path
    runs (the parallel layer, the backwards): it must launch the
    kernels."""
    saved = [getattr(mod, name) for mod, name in PLAIN_VERSIONS]

    def guard(fn):
        def call(xr, *args, **kwargs):
            if xr.is_cuda:
                raise RuntimeError(f"{fn.__name__} ran on the card")
            return fn(xr, *args, **kwargs)
        return call

    for (mod, name), fn in zip(PLAIN_VERSIONS, saved):
        setattr(mod, name, guard(fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(PLAIN_VERSIONS, saved):
            setattr(mod, name, fn)


def counted(fn):
    """fn's result and the collectives it called."""
    from cfftpack_tpu_torch.parallel._comm import count_collectives
    with count_collectives() as cc:
        out = fn()
    return out, cc


def check_collectives(cc: dict, want: dict, what: str) -> None:
    full = {"all_to_all_single": 0, "all_reduce": 0,
            "all_gather_into_tensor": 0, "reduce_scatter_tensor": 0, **want}
    check(cc == full, f"{what}: collectives {cc}")


def chunked_rel_err(got, fn, want_of, step: int = 8) -> float:
    """max |got - want| / max |want| over the leading axis in steps of
    ``step`` (``want_of(i, j)`` gives the reference of rows i:j), so the
    reference of an 8 GiB tensor is never whole."""
    err = peak = 0.0
    for i in range(0, got.shape[0], step):
        w = want_of(i, i + step)
        err = max(err, float((fn(got[i:i + step]) - w).abs().max()))
        peak = max(peak, float(w.abs().max()))
    return err / peak


def phase_parallel(total: dict, card: str) -> None:
    """Phase 34: the parallel layer at world size 1 on a one-rank NCCL
    group: the four-step at 2^20 x 64 and the sharded 2-D FFT at
    4096^2 x 64 against torch.fft, the real 2-D FFT, the dry run and
    the pricers with mesh=, each with its collectives counted and its
    K1 and K6 launches, beside the single-device entry's time."""
    import socket
    import torch.distributed as dist
    from cfftpack_tpu_torch import parallel as par
    from cfftpack_tpu_torch.dryrun import dryrun_multichip
    from cfftpack_tpu_torch.models import (asian_option_qmc_device,
                                           vg_mc_price_device)

    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    par.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        with no_plain_on_card():
            mesh = par.make_mesh((1,), ("data",))
            print(f"phase 34: one-rank NCCL group, mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
                  f"{torch.cuda.get_device_name(0)}")
            parallel_fourstep(par, mesh, total, card)
            parallel_fft2(par, mesh, total, card)
            print("phase 34: dryrun_multichip(1, device=\"cuda\")")
            res, got = timed_drive("dryrun_multichip(1)", lambda: (
                dryrun_multichip(1, device="cuda")), total, card)
            check(got["K1"] > 0 and got["K6"] > 0,
                  f"the dry run launched K1 and K6 ({got})")
            print("phase 34: the pricers with mesh=, against mesh=None")
            for name, fn in (
                    ("conv_option_price 80 strikes n=4096 f64",
                     lambda **kw: conv_option_price(
                         100.0, np.arange(80.0, 120.0, 0.5), 0.25, 0.03,
                         lambda u: bs_cf(u, 0.25, 0.2, 0.03), n=4096,
                         grid_sigma=0.2, **kw)),
                    (f"asian_option_qmc_device {ASIAN_SAMPLES} x 128 f32",
                     lambda **kw: asian_option_qmc_device(
                         steps=128, samples=ASIAN_SAMPLES, **kw)),
                    (f"vg_mc_price_device n=2048 {VG_SAMPLES} draws f32",
                     lambda **kw: vg_mc_price_device(
                         n=2048, samples=VG_SAMPLES, **kw))):
                (v, cc), got = timed_drive(f"{name} mesh=", lambda: counted(
                    lambda: fn(mesh=mesh)), total, card)
                check(got["K1"] > 0, f"{name}: K1 launched ({got})")
                check_collectives(cc, {"all_gather_into_tensor": 1}
                                  if "conv" in name else {"all_reduce": 1},
                                  name)
                one = fn(device=DEV)
                err = float(np.abs(np.asarray(v) - np.asarray(one)).max())
                check(err < 1e-12, f"{name}: mesh= vs mesh=None {err:.2e}")
                t_mesh = median_ms(lambda: fn(mesh=mesh), 5, 1)
                t_one = median_ms(lambda: fn(device=DEV), 5, 1)
                print(f"  {name}: mesh= {t_mesh:.3f} ms, mesh=None "
                      f"{t_one:.3f} ms  [{card}]")
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def parallel_fourstep(par, mesh, total: dict, card: str) -> None:
    from cfftpack_tpu_torch.parallel.fourstep_split import _split
    b, n = FOURSTEP_SHAPE
    n1, n2 = _split(n, 1)
    print(f"phase 34: fft_fourstep/ifft_fourstep n=2^20 batch={b} complex64")
    g = torch.Generator(device=DEV).manual_seed(340)
    x = torch.randn((b, n), generator=g, device=DEV, dtype=torch.complex64)
    want = torch.fft.fft(x, norm="forward")
    wmax, xmax = float(want.abs().max()), float(x.abs().max())
    layouts = {False: want.reshape(b, n2, n1).transpose(1, 2), True: want}
    for natural in (False, True):
        for c in (1, 2):
            what = f"fft_fourstep reorder={natural} overlap_chunks={c}"
            (y, cc), got = timed_drive(what, lambda: counted(
                lambda: par.fft_fourstep(x, mesh, reorder=natural,
                                         overlap_chunks=c)), total, card)
            check(got["K1"] > 0 and got["K6"] > 0,
                  f"{what}: K1 and K6 launched ({got})")
            check_collectives(cc, {"all_to_all_single": c + natural}, what)
            err = float((y - layouts[natural]).abs().max()) / wmax
            check(err < 1e-4, f"{what}: vs torch.fft.fft {err:.2e} < 1e-4 "
                  "of max |X|")
            what = f"ifft_fourstep reordered={natural} overlap_chunks={c}"
            (back, cc), got = timed_drive(what, lambda: counted(
                lambda: par.ifft_fourstep(y, mesh, reordered=natural,
                                          overlap_chunks=c)), total, card)
            check(got["K1"] > 0 and got["K6"] > 0,
                  f"{what}: K1 and K6 launched ({got})")
            check_collectives(cc, {"all_to_all_single": c + natural}, what)
            err = float((back - x).abs().max()) / xmax
            check(err < 1e-4, f"{what}: round trip {err:.2e} < 1e-4 of "
                  "max |x|")
            del y, back
    del want, layouts
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    times = {
        "fft_fourstep reorder=False": lambda: par.fft_fourstep(
            x, mesh, reorder=False),
        "fft_fourstep reorder=False overlap_chunks=2": lambda: (
            par.fft_fourstep(x, mesh, reorder=False, overlap_chunks=2)),
        "fft_fourstep reorder=True": lambda: par.fft_fourstep(x, mesh),
        "fft_fourstep_split reorder=True": lambda: par.fft_fourstep_split(
            xr, xi, mesh),
        "single-device fft (K5)": lambda: ct.fft(x),
        "single-device fft_split (K5)": lambda: ct.fft_split(xr, xi),
        "torch.fft.fft": lambda: torch.fft.fft(x, norm="forward")}
    for name, fn in times.items():
        print(f"  {name} (64, 2^20): {median_ms(fn, 10, 2):.4f} ms  [{card}]")
    del x, xr, xi


def parallel_fft2(par, mesh, total: dict, card: str) -> None:
    b, n0, n1 = FFT2_SHAPE
    print(f"phase 34: fft2_sharded/ifft2_sharded shape {FFT2_SHAPE} "
          "complex64 (8 GiB a tensor)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=DEV).manual_seed(341)
    x = torch.randn(FFT2_SHAPE, generator=g, device=DEV,
                    dtype=torch.complex64)
    (y, cc), got = timed_drive("fft2_sharded", lambda: counted(
        lambda: par.fft2_sharded(x, mesh)), total, card)
    check(got["K1"] > 0 and got["K6"] > 0, f"K1 and K6 launched ({got})")
    check_collectives(cc, {"all_to_all_single": 2}, "fft2_sharded")
    err = chunked_rel_err(y, lambda t: t, lambda i, j: torch.fft.fft2(
        x[i:j], norm="forward"))
    check(err < 1e-4, f"fft2_sharded vs torch.fft.fft2 (8 images at a time) "
          f"{err:.2e} < 1e-4 of max |X|")
    (back, cc), got = timed_drive("ifft2_sharded", lambda: counted(
        lambda: par.ifft2_sharded(y, mesh)), total, card)
    check(got["K1"] > 0 and got["K6"] > 0, f"K1 and K6 launched ({got})")
    check_collectives(cc, {"all_to_all_single": 2}, "ifft2_sharded")
    del y
    err = chunked_rel_err(back, lambda t: t, lambda i, j: x[i:j])
    check(err < 1e-4, f"ifft2_sharded round trip {err:.2e} < 1e-4 of max |x|")
    del back
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB"
          f"  [{card}]")
    for name, fn in (("fft2_sharded", lambda: par.fft2_sharded(x, mesh)),
                     ("single-device fft2", lambda: ct.fft2(x))):
        print(f"  {name} {FFT2_SHAPE}: {median_ms(fn, 5, 1):.4f} ms  "
              f"[{card}]")
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    del x
    for name, fn in (("fft2_sharded_split",
                      lambda: par.fft2_sharded_split(xr, xi, mesh)),
                     ("single-device fft2_split",
                      lambda: ct.fft2_split(xr, xi))):
        print(f"  {name} {FFT2_SHAPE}: {median_ms(fn, 5, 1):.4f} ms  "
              f"[{card}]")
    del xr, xi
    torch.cuda.empty_cache()
    print(f"phase 34: rfft2_sharded_split shape {RFFT2_SHAPE} f32")
    v = torch.randn(RFFT2_SHAPE, generator=g, device=DEV)
    ((yr, yi), cc), got = timed_drive("rfft2_sharded_split", lambda: counted(
        lambda: par.rfft2_sharded_split(v, mesh)), total, card)
    check(got["K1"] > 0 and got["K6"] > 0, f"K1 and K6 launched ({got})")
    check_collectives(cc, {"all_to_all_single": 2}, "rfft2_sharded_split")
    y = torch.complex(yr, yi)
    err = chunked_rel_err(y, lambda t: t, lambda i, j: torch.fft.rfft2(
        v[i:j], norm="forward"))
    check(err < 1e-4, f"rfft2_sharded_split vs torch.fft.rfft2 {err:.2e} < "
          "1e-4 of max |X|")
    (back, cc), got = timed_drive("irfft2_sharded_split", lambda: counted(
        lambda: par.irfft2_sharded_split(yr, yi, n1, mesh)), total, card)
    check_collectives(cc, {"all_to_all_single": 2}, "irfft2_sharded_split")
    err = chunked_rel_err(back, lambda t: t, lambda i, j: v[i:j])
    check(err < 1e-4, f"irfft2_sharded_split round trip {err:.2e} < 1e-4")
    t_par = median_ms(lambda: par.rfft2_sharded_split(v, mesh), 5, 1)
    t_one = median_ms(lambda: ct.rfft2_split(v), 5, 1)
    print(f"  rfft2_sharded_split {RFFT2_SHAPE}: {t_par:.4f} ms, "
          f"single-device rfft2_split {t_one:.4f} ms  [{card}]")
    del v, y, yr, yi, back


# ---- phase 36: gradients on the card

@contextlib.contextmanager
def plain_autograd():
    """Autograd through the plain versions on the card: the kernels'
    plain versions in their place (:func:`plain_engine`) and every
    wrapper's autograd Function out, so that autograd records the plain
    versions' torch ops.  For the oracles of phase 36 only."""
    gate = _adjoint.needs_grad
    _adjoint.needs_grad = lambda *t: False
    try:
        with plain_engine():
            yield
    finally:
        _adjoint.needs_grad = gate


def as_tuple(y) -> tuple:
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)


def planes(z) -> tuple:
    return z.real, z.imag


def leaves(xs) -> list:
    return [x.detach().clone().requires_grad_() for x in xs]


def fwd_bwd(fn, xs, cots):
    """The gradients of sum(cot * y) over fn's outputs y on leaves copied
    from xs (torch.autograd.grad: nothing accumulates)."""
    ls = leaves(xs)
    return torch.autograd.grad(as_tuple(fn(*ls)), ls, cots)


def pair_filter(x, ffr, ffi, scale: float):
    """The streaming filter's forward (``stream_fft.sfilter_stream``) with
    torch.fft in float64, any filter planes: row pairs z = x[2p] +
    i*x[2p+1], w = scale * n * ifft(F * fft(z)), rows Re w and Im w."""
    n = x.shape[-1]
    xp = x.double().reshape(-1, 2, n)
    F = torch.complex(ffr.double(), ffi.double())
    w = torch.fft.ifft(F * torch.fft.fft(torch.complex(xp[:, 0], xp[:, 1])))
    y = torch.stack([w.real, w.imag], dim=1).reshape(x.shape) * (n * scale)
    return y.to(x.dtype)


def packed_filter_ext(fr, fi):
    """rfilter_split's conjugate-symmetric extension of a packed filter
    (``core._rfilter_stream``)."""
    h = fr.shape[-1] - 1
    return (torch.cat([fr, fr[1:h].flip(-1)]),
            torch.cat([fi, -fi[1:h].flip(-1)]))


def packed_filter(n: int, seed: int):
    """A packed (n/2 + 1)-bin float32 filter with real DC and Nyquist
    bins, rfilter_split's contract."""
    fr, fi = pair((n // 2 + 1,), torch.float32, seed)
    fi[0] = fi[-1] = 0.0
    return fr, fi


def grad_rows():
    """(name, shape, inputs, fn, oracle, oracle kind, torch.fft function
    of the same map (True: the oracle) or None, the backward's expected
    launches) for each kernel at its PERF.md §6 row shape: the backward
    of fn, on the kernels, against the oracle's gradient by autograd
    through torch.fft ("torch.fft"), through the plain versions called
    directly ("plain") or through the filter written with torch.fft in
    float64 ("torch.fft f64")."""
    f32 = torch.float32
    n, b = 65536, 64
    h, m = n // 2, n // 128
    ortho = float(1 / np.sqrt(n))

    def cx(xr, xi):
        return torch.complex(xr, xi)

    def perm(X, rows, length):
        return X.reshape(rows, 128, length // 128).transpose(1, 2).reshape(
            rows, length)

    big = list(pair((b, n), f32, seed=360))
    x = real((b, n), f32, seed=361)
    ffr, ffi = packed_filter_ext(*packed_filter(n, seed=362))
    spec = list(pair((b, h + 1), f32, seed=363))
    img = real((64, 1024, 1024), f32, seed=364)
    w2, w3 = dct_ops._tab("weights", 1024, img)[:2]
    k7s = float(np.sqrt(2.0 / n))
    k7w = (float(np.sqrt(0.5)), float(np.sqrt(2.0)))
    return [
        ("K1 sfft_fused fwd", (4096, 1024),
         list(pair((4096, 1024), f32, 365)),
         lambda a, c: fused_fft.sfft_fused(a, c, 1024, False, 1 / 32),
         lambda a, c: planes(torch.fft.fft(cx(a, c), norm="ortho")),
         "torch.fft", True, {"K1": 1}),
        ("K2 sfft_stream_permuted fwd", (b, n), big,
         lambda a, c: stream_fft.sfft_stream_permuted(a, c, n, False),
         lambda a, c: planes(perm(torch.fft.fft(cx(a, c)), *a.shape)),
         "torch.fft", True, {"K2": 1}),
        ("K2 sfft_stream_permuted inv", (b, n), big,
         lambda a, c: stream_fft.sfft_stream_permuted(a, c, n, True),
         lambda a, c: planes(torch.fft.ifft(
             cx(a, c).reshape(b, m, 128).transpose(1, 2).reshape(b, n),
             norm="forward")), "torch.fft", True, {"K2": 1}),
        ("K3 sfft_stream fwd", (b, n), big,
         lambda a, c: stream_fft.sfft_stream(a, c, n, False, ortho),
         lambda a, c: planes(torch.fft.fft(cx(a, c), norm="ortho")),
         "torch.fft", True, {"K3": 1}),
        ("K3 sfft_stream inv", (b, n), big,
         lambda a, c: stream_fft.sfft_stream(a, c, n, True, ortho),
         lambda a, c: planes(torch.fft.ifft(cx(a, c), norm="ortho")),
         "torch.fft", True, {"K3": 1}),
        ("K4 sfilter_stream, input and filter", (b, n), [x, ffr, ffi],
         lambda v, p, q: stream_fft.sfilter_stream(v, p, q, n, 1 / n),
         lambda v, p, q: pair_filter(v, p, q, 1 / n), "torch.fft f64",
         lambda v, p, q: torch.fft.irfft(
             torch.fft.rfft(v) * torch.complex(p[:h + 1], q[:h + 1]), n),
         {"K2": 1, "K4": 1, "K3": 2}),
        ("K5 sfft_stream_split fwd", (8, 1 << 20),
         list(pair((8, 1 << 20), f32, 366)),
         lambda a, c: stream_fft.sfft_stream_split(a, c, 1 << 20, False,
                                                   1 / 1024),
         lambda a, c: planes(torch.fft.fft(cx(a, c), norm="ortho")),
         "torch.fft", True, {"K5": 1}),
        ("K6 scolfft fwd", (64, 1024, 1024),
         list(pair((64, 1024, 1024), f32, 367)),
         lambda a, c: colfft.scolfft(a, c, False, a.shape[-2] ** -0.5),
         lambda a, c: planes(torch.fft.fft(cx(a, c), dim=-2,
                                           norm="ortho")),
         "torch.fft", True, {"K6": 1}),
        ("K7 srfft_stream", (b, n), [x],
         lambda v: rstream.srfft_stream(v, n, 1 / n),
         lambda v: planes(torch.fft.rfft(v, norm="forward")), "torch.fft",
         True, {"K7": 1}),
        ("K7 sirfft_stream", (b, n), spec,
         lambda a, c: rstream.sirfft_stream(a, c, n, 1 / n),
         lambda a, c: rstream._irfft_plain(a, c, n, 1 / n), "plain",
         lambda a, c: torch.fft.irfft(cx(a, c), n, norm="forward"),
         {"K7": 1}),
        ("K7 sdct2_stream ortho", (b, n), [x],
         lambda v: rstream.sdct2_stream(v, n, k7s, k7w[0]),
         lambda v: rstream._dct2_plain(v, n, k7s, k7w[0]), "plain", None,
         {"K7": 1}),
        ("K7 sdct3_stream ortho", (b, n), [x],
         lambda v: rstream.sdct3_stream(v, n, k7s, k7w[1]),
         lambda v: rstream._dct3_plain(v, n, k7s, k7w[1]), "plain", None,
         {"K7": 1}),
        ("K8 _dct4_stream ortho", (b, n), [x],
         lambda v: dct_ops._dct4_stream(v, n, k7s, False),
         lambda v: dct_ops._dct4_stream_plain(v, n, k7s, False), "plain",
         None, {"K8": 1}),
        ("K8 _dct4_stream dst ortho", (b, n), [x],
         lambda v: dct_ops._dct4_stream(v, n, k7s, True),
         lambda v: dct_ops._dct4_stream_plain(v, n, k7s, True), "plain",
         None, {"K8": 1}),
        ("K9 scoldct type 2 ortho", (64, 1024, 1024), [img],
         lambda v: colfft.scoldct(v, 2, w2),
         lambda v: colfft.coldct_plain(v, 2, w2), "plain", None, {"K9": 1}),
        ("K9 scoldct type 3 ortho", (64, 1024, 1024), [img],
         lambda v: colfft.scoldct(v, 3, w3),
         lambda v: colfft.coldct_plain(v, 3, w3), "plain", None, {"K9": 1}),
        ("K10 sfft_fourstep fwd", (b, n), big,
         lambda a, c: fourstep_fft.sfft_fourstep(a, c, n, False),
         lambda a, c: planes(torch.fft.fft(cx(a, c))), "torch.fft", True,
         {"K10": 1}),
        ("K11 sfft_mm2 fwd", (128, 32768),
         list(pair((128, 32768), f32, 368)),
         lambda a, c: stream_fft.sfft_mm2(a, c, 32768, False),
         lambda a, c: planes(torch.fft.fft(cx(a, c))), "torch.fft", True,
         {"K11": 1}),
        ("K11 sfft_mm2_permuted fwd", (128, 32768),
         list(pair((128, 32768), f32, 369)),
         lambda a, c: stream_fft.sfft_mm2_permuted(a, c, 32768, False),
         lambda a, c: planes(perm(torch.fft.fft(cx(a, c)), *a.shape)),
         "torch.fft", True, {"K11": 1}),
    ]


def grad_times(fn, xs, cots, torch_fn, reps: int = 10) -> dict:
    """CUDA-event medians of fn alone (on inputs that need no grad), of fn
    with its backward and of torch_fn with its backward; the peak device
    memory of one forward and backward above what was allocated before
    it."""
    ls = leaves(xs)
    out = {"fwd_ms": median_ms(lambda: fn(*xs), reps),
           "fwd_bwd_ms": median_ms(lambda: torch.autograd.grad(
               as_tuple(fn(*ls)), ls, cots), reps),
           "torch_fwd_bwd_ms": None}
    if torch_fn is not None:
        out["torch_fwd_bwd_ms"] = median_ms(lambda: torch.autograd.grad(
            as_tuple(torch_fn(*ls)), ls, cots), reps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.autograd.grad(as_tuple(fn(*ls)), ls, cots)
    torch.cuda.synchronize()
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    return out


def grad_check(name: str, fn, xs, cots, want, total: dict, card: str,
               expect, torch_fn=None) -> dict:
    """fn's backward on the kernels with every plain version refused on
    the card, run right after the forward with no sync between them: the
    launches it makes (those of the forward and backward less those of
    the forward alone; ``expect``: the exact counts, or the kernels that
    must appear), its gradients against ``want`` to 1e-4 of max |g|, and
    its times."""
    with no_plain_on_card():
        _, fwd = drive(lambda: fn(*xs), total)
        ls = leaves(xs)
        grads, both = drive(lambda: torch.autograd.grad(
            as_tuple(fn(*ls)), ls, cots), total)
    bwd = {k: both[k] - fwd[k] for k in both if both[k] != fwd[k]}
    if isinstance(expect, dict):
        check(bwd == expect, f"{name}: the backward launched {bwd}, "
              f"expected {expect}")
    else:
        check(all(bwd.get(k, 0) > 0 for k in expect),
              f"{name}: the backward launched {bwd} ({', '.join(expect)} "
              "expected)")
    err = max(rel_err(g, w) for g, w in zip(grads, want))
    check(all(bool(torch.isfinite(g).all()) for g in grads) and err < 1e-4,
          f"{name}: gradients finite, vs the oracle {err:.2e} < 1e-4 of "
          "max |g|")
    del grads
    t = grad_times(fn, xs, cots, torch_fn)
    lib = ("not measured" if t["torch_fwd_bwd_ms"] is None
           else f"{t['torch_fwd_bwd_ms']:.4f} ms")
    print(f"  grad {name}: fwd {t['fwd_ms']:.4f} ms, fwd+bwd "
          f"{t['fwd_bwd_ms']:.4f} ms, torch.fft fwd+bwd {lib}, peak "
          f"{t['peak_mib']:.1f} MiB  [{card}]")
    return {"name": name, "bwd_launches": bwd, "max_rel_err": err, **t}


def cotangents(fn, xs) -> list:
    """Random cotangents of fn's outputs (the forward run once)."""
    return [real(tuple(y.shape), y.dtype, seed=370 + i)
            for i, y in enumerate(as_tuple(fn(*xs)))]


def phase_grad(total: dict, card: str) -> list:
    """Phase 36: every kernel's backward at its PERF.md §6 row shape and
    the full-width paths forward and backward through the public entries,
    each against an oracle with the plain versions refused on the card;
    K3's and K4's backward again on a side stream."""
    records = []
    print("phase 36: each kernel's backward (the adjoint on its kernels)")
    for name, shape, xs, fn, oracle, kind, torch_fn, expect in grad_rows():
        cots = cotangents(fn, xs)
        if kind == "plain":
            with plain_autograd():
                want = fwd_bwd(oracle, xs, cots)
        else:
            want = fwd_bwd(oracle, xs, cots)
        rec = grad_check(f"{name} {shape} vs {kind}", fn, xs, cots, want,
                         total, card, expect,
                         oracle if torch_fn is True else torch_fn)
        records.append({**rec, "shape": list(shape)})
        del want
        if name.startswith(("K3 sfft_stream fwd", "K4")):
            # the same backward on a side stream, with no sync between the
            # forward and the backward on either stream
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), no_plain_on_card():
                ls = leaves(xs)
                g_side = torch.autograd.grad(as_tuple(fn(*ls)), ls, cots)
            torch.cuda.current_stream().wait_stream(side)
            g_main = fwd_bwd(fn, xs, cots)
            err = max(rel_err(a, c) for a, c in zip(g_side, g_main))
            check(err < 1e-6, f"{name}: the backward on a side stream vs "
                  f"the current stream {err:.2e} < 1e-6")
            del g_side, g_main
    torch.cuda.empty_cache()
    records += phase_grad_paths(total, card)
    return records


def phase_grad_paths(total: dict, card: str) -> list:
    """Phase 36's full-width paths, forward and backward through the
    public entries: the flagship step, the bench headline, the streaming
    filter at (64, 65536) and at the float32 pricer's 2^20 (K5), the
    DCT/DST at (64, 65536), the 2-D forms at (64, 1024, 1024) and the
    float64 fft_hp."""
    records = []
    f32 = torch.float32
    print("phase 36: paths forward and backward through the public entries")
    for batch in (64, 4096):
        step, args = entry(DEV, batch=batch)
        cots = cotangents(step, args)
        with plain_autograd():
            want = fwd_bwd(step, args, cots)
        rec = grad_check(f"flagship step ({batch}, 960) d/d(v, phi_r, "
                         "phi_i) vs plain", step, list(args), cots, want,
                         total, card, {"K1": 2, "cmul": 1})
        records.append({**rec, "shape": [batch, 960]})
    paths = [("fft_split (4096, 1024) ortho",
              list(pair((4096, 1024), f32, seed=380)),
              lambda a, c: ct.fft_split(a, c, norm="ortho"),
              lambda a, c: planes(torch.fft.fft(torch.complex(a, c),
                                                norm="ortho")),
              ("K1",), True)]
    for b, n in ((64, 65536), (16, 1 << 20)):
        paths.append((f"rfilter_split ({b}, {n}) d/d(x, fr, fi)",
                      [real((b, n), f32, seed=381), *packed_filter(n, 382)],
                      lambda v, p, q: ct.rfilter_split(v, p, q),
                      lambda v, p, q, n=n: pair_filter(
                          v, *packed_filter_ext(p, q), 1 / n),
                      ("K2", "K4", "K3") if n == 65536 else ("K5",),
                      lambda v, p, q, n=n: torch.fft.irfft(
                          torch.fft.rfft(v) * torch.complex(p, q), n)))
    x = real((64, 65536), f32, seed=383)
    for name, fn, inv, kern in (
            ("dct type 2", lambda v: ct.dct(v, 2, norm="ortho"),
             lambda w: scipy.fft.idct(w, 2, norm="ortho"), "K7"),
            ("idct type 2", lambda v: ct.idct(v, 2, norm="ortho"),
             lambda w: scipy.fft.dct(w, 2, norm="ortho"), "K7"),
            ("dst type 4", lambda v: ct.dst(v, 4, norm="ortho"),
             lambda w: scipy.fft.dst(w, 4, norm="ortho"), "K8")):
        paths.append((f"{name} (64, 65536) ortho", [x], fn, inv, (kern,),
                      None))
    img = list(pair((64, 1024, 1024), f32, seed=384))
    paths += [
        ("fft2_split (64, 1024, 1024)", img,
         lambda a, c: ct.fft2_split(a, c),
         lambda a, c: planes(torch.fft.fft2(torch.complex(a, c),
                                            norm="forward")),
         ("K6", "K1"), True),
        ("rfft2_split (64, 1024, 1024)", img[:1],
         lambda v: ct.rfft2_split(v),
         lambda v: planes(torch.fft.rfft2(v, norm="forward")),
         ("K6", "K1"), True),
        ("dctn type 2 (64, 1024, 1024) ortho", img[:1],
         lambda v: ct.dctn(v, 2, axes=(-2, -1), norm="ortho"),
         lambda w: scipy.fft.idctn(w, 2, axes=(-2, -1), norm="ortho"),
         ("K9", "K1"), None),
        ("fft_hp (4096, 1024) complex128",
         [torch.complex(*pair((4096, 1024), torch.float64, seed=385))],
         lambda v: ct.fft_hp(v),
         lambda v: torch.fft.fft(v, norm="forward"), ("K1",), True)]
    for name, xs, fn, oracle, kern, torch_fn in paths:
        cots = cotangents(fn, xs)
        if torch_fn is None:
            # an orthonormal transform: the gradient is the inverse
            # transform of the cotangent (scipy, float64, on the host)
            want = [torch.from_numpy(oracle(
                cots[0].double().cpu().numpy())).to(DEV)]
        else:
            want = fwd_bwd(oracle, xs, cots)
        rec = grad_check(name, fn, xs, cots, want, total, card, kern,
                         oracle if torch_fn is True else torch_fn)
        records.append({**rec, "shape": list(xs[0].shape)})
        del want
    torch.cuda.empty_cache()
    return records


# ---- phase 37: gradients through the parallel layer

# phase 37 widths: the four-step at BASELINE configs[2] (phase 34's
# shape); the 2-D forms at 16 of configs[3]'s 64 images (forward alone
# peaks at 48.9 GiB at 64, and the backward's cotangents, gradients and
# exchange buffers would not fit in 80 GiB); dctn2 at (64, 1024, 1024)
PAR_GRAD_FFT2 = (16, 4096, 4096)
PAR_GRAD_DCT = (64, 1024, 1024)


def par_grad_rows(par, mesh):
    """(name, inputs, fn, oracle in float64, torch.fft function of the same
    map in float32 or None, the kernels the backward must launch) of
    phase 37."""
    f32 = torch.float32
    from cfftpack_tpu_torch.parallel.fourstep_split import _split
    b, n = FOURSTEP_SHAPE
    n1, n2 = _split(n, 1)

    def fourstep_oracle(natural, dt):
        def fn(a, c):
            y = torch.fft.fft(torch.complex(a.to(dt), c.to(dt)),
                              norm="forward")
            return planes(y if natural else y.reshape(b, n2, n1).transpose(
                1, 2))
        return fn

    rows = []
    xs = list(pair(FOURSTEP_SHAPE, f32, seed=371))
    for natural in (False, True):
        rows.append((f"fft_fourstep_split reorder={natural} (64, 2^20)", xs,
                     lambda a, c, nat=natural: par.fft_fourstep_split(
                         a, c, mesh, reorder=nat),
                     fourstep_oracle(natural, torch.float64),
                     fourstep_oracle(natural, f32), ("K6", "K1")))
    rows.append(("fft_fourstep reorder=False overlap_chunks=4 (64, 2^20) "
                 "complex64 from the planes", xs,
                 lambda a, c: planes(par.fft_fourstep(
                     torch.complex(a, c), mesh, reorder=False,
                     overlap_chunks=4)),
                 fourstep_oracle(False, torch.float64),
                 fourstep_oracle(False, f32), ("K6", "K1")))

    def fft2(dt):
        return lambda a, c: planes(torch.fft.fft2(
            torch.complex(a.to(dt), c.to(dt)), norm="forward"))

    def rfft2(dt):
        return lambda v: planes(torch.fft.rfft2(v.to(dt), norm="forward"))

    img = list(pair(PAR_GRAD_FFT2, f32, seed=372))
    rows.append((f"fft2_sharded_split {PAR_GRAD_FFT2}", img,
                 lambda a, c: par.fft2_sharded_split(a, c, mesh),
                 fft2(torch.float64), fft2(f32), ("K1", "K6")))
    rows.append((f"rfft2_sharded_split {PAR_GRAD_FFT2}", img[:1],
                 lambda v: par.rfft2_sharded_split(v, mesh),
                 rfft2(torch.float64), rfft2(f32), ("K1", "K6")))
    rows.append((f"dctn2_sharded type 2 ortho {PAR_GRAD_DCT}",
                 [real(PAR_GRAD_DCT, f32, seed=373)],
                 lambda v: par.dctn2_sharded(v, mesh, type=2, norm="ortho"),
                 None, None, ("K1",)))
    return rows


def par_grad_check(name: str, fn, xs, want, torch_fn, kern, total: dict,
                   card: str) -> dict:
    """One row of phase 37 with every plain version refused on the card:
    the collectives of the forward and of the forward and backward, the
    backward's launches, the gradients against ``want`` to 1e-6 of max
    |g|, and the times and peak memory of :func:`grad_times`."""
    cots = cotangents(fn, xs)
    if want is None:
        # the ortho DCT-II is orthonormal: the gradient is the 2-D
        # DCT-III of the cotangent (scipy, float64, on the host)
        want = [torch.from_numpy(scipy.fft.idctn(
            cots[0].double().cpu().numpy(), 2, axes=(-2, -1),
            norm="ortho")).to(DEV)]
    else:
        want = fwd_bwd(want, [x.double() for x in xs],
                       [c.double() for c in cots])
    with no_plain_on_card():
        (_, fwd_cc), fwd = drive(lambda: counted(lambda: fn(*xs)), total)
        ls = leaves(xs)
        (grads, both_cc), both = drive(lambda: counted(
            lambda: torch.autograd.grad(as_tuple(fn(*ls)), ls, cots)), total)
    bwd = {k: both[k] - fwd[k] for k in both if both[k] != fwd[k]}
    check(all(bwd.get(k, 0) > 0 for k in kern),
          f"{name}: the backward launched {bwd} ({', '.join(kern)} "
          "expected)")
    a2a = fwd_cc["all_to_all_single"]
    check_collectives(fwd_cc, {"all_to_all_single": a2a}, f"{name} forward")
    check_collectives(both_cc, {"all_to_all_single": 2 * a2a},
                      f"{name} forward and backward")
    err = max(rel_err(g, w) for g, w in zip(grads, want))
    check(all(bool(torch.isfinite(g).all()) for g in grads) and err < 1e-6,
          f"{name}: gradients vs the float64 oracle {err:.2e} < 1e-6 of "
          "max |g|")
    del grads, want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*xs)
    torch.cuda.synchronize()
    fwd_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    del out
    t = grad_times(fn, xs, cots, torch_fn, reps=5)
    lib = ("not measured" if t["torch_fwd_bwd_ms"] is None
           else f"{t['torch_fwd_bwd_ms']:.4f} ms")
    print(f"  grad {name}: fwd {t['fwd_ms']:.4f} ms, fwd+bwd "
          f"{t['fwd_bwd_ms']:.4f} ms, torch.fft fwd+bwd {lib}, peak fwd "
          f"{fwd_peak / 1024:.2f} GiB, fwd+bwd {t['peak_mib'] / 1024:.2f} "
          f"GiB, all_to_all_single {a2a} -> {2 * a2a}  [{card}]")
    torch.cuda.empty_cache()
    return {"name": name, "bwd_launches": bwd, "max_rel_err": err,
            "all_to_all_single": [a2a, 2 * a2a], "fwd_peak_mib": fwd_peak,
            **t}


def phase_parallel_grad(total: dict, card: str) -> None:
    """Phase 37: gradients through the parallel layer at world size 1 on a
    one-rank NCCL group, each row's backward on the kernels and the
    collectives with every plain version refused on the card."""
    import socket
    import torch.distributed as dist
    from cfftpack_tpu_torch import parallel as par

    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    par.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = par.make_mesh((1,), ("data",))
        print(f"phase 37: gradients through the parallel layer, one-rank "
              f"NCCL group on {torch.cuda.get_device_name(0)}")
        print(f"  reduced: fft2_sharded_split and rfft2_sharded_split at "
              f"{PAR_GRAD_FFT2} (16 of BASELINE configs[3]'s 64 images: the "
              "backward's buffers beside phase 34's 48.9 GiB forward would "
              "not fit in 80 GiB)")
        records = []
        for name, xs, fn, want, torch_fn, kern in par_grad_rows(par, mesh):
            records.append(par_grad_check(name, fn, xs, want, torch_fn, kern,
                                          total, card))
            del xs
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    print(json.dumps({"parallel_grad": records}))


# ---- phase 38: the port's demos and validation table on the card

def load_script(rel: str):
    """A script of the checkout (not a package) as a module."""
    path = Path(__file__).resolve().parent / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launched(got: dict) -> dict:
    return {k: v for k, v in got.items() if v}


def norm_err(got, want) -> float:
    """max |got - want| / max |want| over the numbers of a table."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max() / np.abs(want).max())


def phase_demos(total: dict, card: str) -> None:
    """Phase 38: the pricing demo's five tables, the sharded demo on a
    one-rank NCCL group and the float32 validation table, each at its
    full width with every plain version refused on the card, its
    launches and wall time printed; the deterministic rows against the
    port's CPU run of the same function."""
    import io
    import torch.distributed as dist
    from cfftpack_tpu_torch import parallel as par
    from cfftpack_tpu_torch.dryrun import _free_port

    pricing = load_script("examples/torch_pricing_demo.py")
    sharded = load_script("examples/torch_sharded_demo.py")
    validate = load_script("scripts/torch_validate.py")
    print("phase 38: the demos and the validation table on the card "
          "(every plain version refused)")
    t0 = time.perf_counter()
    tables, kernels = {}, {}
    with no_plain_on_card():
        for name, fn in pricing.DEMOS.items():
            tables[name], got = timed_drive(
                f"pricing demo {name}", lambda: fn(DEV), total, card)
            kernels[f"pricing {name}"] = launched(got)
        par.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
        try:
            shard_res, got = timed_drive("sharded demo, one NCCL rank",
                                         lambda: sharded.main([]), total,
                                         card)
        finally:
            dist.destroy_process_group()
        kernels["sharded"] = launched(got)
        rows, got = timed_drive("torch_validate", lambda: (
            validate.validate(DEV)), total, card)
        kernels["validate"] = launched(got)
    bad = validate.report(rows)
    for name, got in kernels.items():
        print(f"  launches of {name}: {got}")
        check(bool(got), f"{name} launched a kernel")
    check(bad == 0, f"torch_validate: {bad} of {len(rows)} rows FAIL")
    for line, (err, rel) in shard_res["rows"].items():
        check(rel <= 1e-4, f"sharded demo {line}: {rel:.2e} <= 1e-4 of "
              "max |X|")

    with contextlib.redirect_stdout(io.StringIO()):
        host = {name: pricing.DEMOS[name]("cpu")
                for name in ("bsvg", "strikes", "qmc", "shortrate")}
    for col, what in ((1, "BS"), (3, "VG")):
        err = norm_err([r[col] for r in tables["bsvg"]],
                       [r[col] for r in host["bsvg"]])
        check(err < 1e-12, f"bsvg {what} column vs the CPU run {err:.2e} "
              "< 1e-12")
    err = norm_err([r[2] for r in tables["strikes"]],
                   [r[2] for r in host["strikes"]])
    check(err < 1e-12, f"strikes vs the CPU run {err:.2e} < 1e-12")
    for got, want in zip(tables["qmc"], host["qmc"]):
        if got[1]:
            err = norm_err(got[4], want[4])
            check(err < 1e-12, f"QMC samples={got[0]} vs the CPU run "
                  f"{err:.2e} < 1e-12")
        else:
            qmc_mean = next(r[2] for r in tables["qmc"]
                            if r[0] == got[0] and r[1])
            check(abs(got[2] - qmc_mean) < 0.2,
                  f"MC samples={got[0]} mean {got[2]:.6f} within 0.2 of "
                  f"the QMC mean {qmc_mean:.6f}")
    for way, price in tables["vgmc"]:
        check(abs(price - VG_TARGET) < 0.2, f"vgmc {way} {price:.6f} vs "
              f"the QuantLib target {abs(price - VG_TARGET):.2e} < 0.2")
    for got, want in zip(tables["shortrate"], host["shortrate"]):
        err = max(abs(a - b) / abs(b) for a, b in zip(got[1:], want[1:]))
        check(err < 1e-9, f"shortrate model {got[0]} vs the CPU run "
              f"{err:.2e} < 1e-9 relative")
    print(f"  phase 38: {time.perf_counter() - t0:.1f} s wall, the CPU runs "
          f"included  [{card}]")


def cplx_views(cdt, n: int, b: int, seed: int) -> dict:
    """Phase 39's inputs of (b, n) complex rows on the card by layout: a
    contiguous block, the conjugate and negative bits, rows of a
    transposed block, strided rows, a storage offset, no rows, one row."""
    base = torch.view_as_complex(real((b + 1, 2 * n, 2), cdt.to_real(),
                                      seed))
    x = base[1:, :n].contiguous()
    return {"contiguous": x, "conj": x.conj(), "neg_bit": torch._neg_view(x),
            "transposed": x.T.contiguous().T, "strided": base[1:, ::2],
            "offset": base.reshape(-1)[n:n + b * n].view(b, n),
            "no_rows": x[:0], "one_row": x[:1]}


def phase_cplx_k1(total: dict, card: str) -> None:
    """Phase 39: K1's interleaved complex mode under ``fft``/``ifft`` at
    every register length in both dtypes, on every input layout of
    :func:`cplx_views` at 3 and 4096 rows (and the 16384 rows of
    ``c2c1024.stream`` at 1024 in complex128), against ``torch.fft`` in
    complex128 and against the mode's plain version ``_cplx_plain`` on
    the same card inputs (1e-5 of max |X| in complex64, 1e-12 in
    complex128), one K1 launch a transform and no other entry, every
    plain version refused inside the path; then, profiled, a contiguous
    ``fft`` and ``ifft`` at (4096, 1024) complex128 launch K1 alone: no
    kernel inside ``cfftpack.pack`` or ``cfftpack.unpack``."""
    from torch.profiler import ProfilerActivity, profile
    print("phase 39: K1's interleaved complex mode (fft/ifft at the "
          "register lengths vs torch.fft and its plain version, every "
          "plain version refused inside the path)")
    bars = {torch.complex64: 1e-5, torch.complex128: 1e-12}
    cplx_plain = fused_fft._cplx_plain
    for cdt in (torch.complex64, torch.complex128):
        worst_o = worst_p = 0.0
        bad, maps, calls = [], 0, 0
        for n in plan.REG_LENGTHS[cdt.to_real()]:
            rows = (3, 4096) + ((16384,) if (cdt, n) == (torch.complex128,
                                                         1024) else ())
            for b in rows:
                for kind, v in cplx_views(cdt, n, b, seed=n + b).items():
                    v128 = v.resolve_conj().resolve_neg().to(
                        torch.complex128)
                    for inv, norm in ((False, "fftpack"), (True, "fftpack"),
                                      (False, "ortho")):
                        fn = ct.ifft if inv else ct.fft
                        with no_plain_on_card():
                            y, got = drive(lambda: fn(v, norm=norm), total)
                        calls += 1
                        maps += profiling.complex_maps["interleaved"]
                        what = f"n={n} {kind} b={b} inverse={inv} {norm}"
                        if launched(got) != ({"K1": 1} if v.numel() else {}):
                            bad.append(f"{what}: launches {got}")
                        if not v.numel():
                            continue
                        s = (inv_scale(norm, n) if inv
                             else fwd_scale(norm, n))
                        ref = (torch.fft.ifft(v128) * n if inv
                               else torch.fft.fft(v128)) * s
                        plain = cplx_plain(
                            v.resolve_conj().resolve_neg().reshape(-1, n),
                            n, inv, s).reshape(v.shape)
                        e_o, e_p = rel_err(y, ref), rel_err(y, plain)
                        worst_o, worst_p = max(worst_o, e_o), max(worst_p, e_p)
                        if not (e_o < bars[cdt] and e_p < bars[cdt]
                                and y.dtype == cdt):
                            bad.append(f"{what}: vs torch.fft {e_o:.3e}, vs "
                                       f"plain {e_p:.3e}, {y.dtype}")
                    del v128
        check(not bad, f"{cdt}: every length, layout and row count, one K1 "
              f"launch a transform, within {worst_o:.3e} of torch.fft and "
              f"{worst_p:.3e} of the plain version < {bars[cdt]:.0e} "
              f"{bad[:3]}")
        check(maps == calls, f"{cdt}: {maps} of {calls} calls took the "
              "interleaved route")
    x = real((4096, 1024, 2), torch.float64, seed=391)
    x = torch.view_as_complex(x)
    for _ in range(2):
        ct.ifft(ct.fft(x))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ct.ifft(ct.fft(x))
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("cfftpack.")]
    spans = {e.name for e in prof.events() if e.name.startswith("cfftpack.")}
    print(f"  (4096, 1024) complex128 fft+ifft: device ops {kernels}, spans "
          f"{sorted(spans)}")
    check(len(kernels) == 2 and all("k1_reg_kernel" in k and "K1CplxIO" in k
                                    for k in kernels),
          "a contiguous fft and ifft launch K1's interleaved mode alone")
    check(not spans & {"cfftpack.pack", "cfftpack.unpack"},
          "no cfftpack.pack or cfftpack.unpack span on a contiguous input")
    n = plan.REG_LENGTHS[torch.float64][3]
    ms = median_ms(lambda: ct.fft(x))
    print(f"  fft (4096, {n}) complex128 through K1's interleaved mode: "
          f"{ms:.4f} ms a call, event time  [{card}]")


def phase_cmul(total: dict, card: str) -> None:
    """Phase 40: the step's filter map (``ops.cmul``) on the card at book's
    shape, (65536, 481) float32: the forward and the adjoint (both
    gradients, the reduce in the same call) against their plain versions
    on the same card inputs (1e-6 of max |t| for the planes, 1e-5 for the
    filter's gradient), two adjoint runs the same bit for bit, every plain
    version refused; their device times (profiler) and event times beside
    their bounds, 504 MB and 756 MB at 3.35 TB/s, and the plain forward's;
    then ``profiling.counts()`` over one book call and one greeks call of
    the step."""
    print("phase 40: the step's filter map (cmul) at (65536, 481) f32 vs its "
          "plain version, times beside the bounds, the step's counts")
    rows, h1 = 65536, 481
    f32 = torch.float32
    sr, si = pair((rows, h1), f32, seed=400)
    gr, gi = pair((rows, h1), f32, seed=401)
    fr, fi = pair((h1,), f32, seed=402)
    with no_plain_on_card():
        (tr, ti), got = drive(lambda: cmul.spectral_mul(sr, si, fr, fi),
                              total)
        check(launched(got) == {"cmul": 1}, f"forward: one cmul launch "
              f"({launched(got)})")
        adj, got = drive(lambda: cmul._adj_launch(gr, gi, sr, si, fr, fi,
                                                  False, True), total)
        again = cmul._adj_launch(gr, gi, sr, si, fr, fi, False, True)
        check(launched(got) == {"cmul": 1}, f"adjoint: one cmul call "
              f"({launched(got)})")
    want = cmul.cmul_plain(sr, si, fr, fi)
    e_f = max(rel_err(a, b) for a, b in zip((tr, ti), want))
    check(e_f < 1e-6, f"forward vs plain {e_f:.3e} < 1e-6")
    want = cmul.adjoint_plain(gr, gi, sr, si, fr, fi, False, True)
    e_s = max(rel_err(a, b) for a, b in zip(adj[:2], want[:2]))
    e_g = max(rel_err(a, b) for a, b in zip(adj[2:], want[2:]))
    check(e_s < 1e-6 and e_g < 1e-5, f"adjoint vs plain: planes {e_s:.3e} "
          f"< 1e-6, filter's gradient {e_g:.3e} < 1e-5")
    check(all(torch.equal(a, b) for a, b in zip(adj[2:], again[2:])),
          "two adjoint runs give the same filter gradient bit for bit")
    del tr, ti, want, adj, again
    fwd_bound = bound_ms(4 * rows * h1 * 4, 0)[0]
    adj_bound = bound_ms(6 * rows * h1 * 4, 0)[0]
    for name, fn, bound in (
            ("forward", lambda: cmul._launch(sr, si, fr, fi), fwd_bound),
            ("adjoint", lambda: cmul._adj_launch(gr, gi, sr, si, fr, fi,
                                                 False, True), adj_bound),
            ("adjoint, filter alone",
             lambda: cmul._adj_launch(gr, gi, sr, si, fr, fi, False, False),
             bound_ms(4 * rows * h1 * 4, 0)[0]),
            ("plain forward", lambda: cmul.cmul_plain(sr, si, fr, fi),
             fwd_bound)):
        prof = profile_route(f"cmul {name}", fn, card)
        print(f"  cmul {name}: device {prof['kernel_us']:.1f} us, event "
              f"{prof['event_us']:.1f} us, bound {bound * 1e3:.1f} us "
              f"({bound * 1e3 / prof['kernel_us']:.3f} of the bound's rate)"
              f"  [{card}]")
    del sr, si, gr, gi
    step, args = entry(DEV, batch=rows)
    v, phr, phi = (t.clone().requires_grad_(True) for t in args)
    cot = real((rows, 960), f32, seed=403)
    for _ in range(2):
        step(*args)
        torch.autograd.grad(step(v, phr, phi), (v, phr, phi), cot)
    torch.cuda.synchronize()
    _, book = drive(lambda: step(*args), total)
    _, greeks = drive(lambda: torch.autograd.grad(
        step(v, phr, phi), (v, phr, phi), cot), total)
    print(f"  counts: book {launched(book)}, greeks {launched(greeks)}")
    check(launched(book) == {"K1": 2, "cmul": 1}
          and launched(greeks) == {"K1": 4, "cmul": 2},
          "a book call launches K1 2, cmul 1; a greeks call K1 4, cmul 2 "
          "(the forward, and the adjoint's one call: strips and reduce)")


def phase_utils(card: str) -> None:
    """Phase 35: the four small utils on the card."""
    import tempfile
    from cfftpack_tpu_torch import utils as pu

    print("phase 35: warm_plans, precompile, trace, Timer, check_finite")
    pu.warm_plans([1009, 4096], device=DEV)
    dev = torch.device("cuda", torch.cuda.current_device())
    check(all((n, torch.float32, dev) in plan._DEVICE_TABLES
              for n in (1009, 4096)), "warm_plans built the device tables")
    x = real((4096, 1024), torch.float32, seed=350)
    run = pu.precompile(ct.rfft_split, x)
    yr, yi = run(x)
    err = rel_err(torch.complex(yr, yi), torch.fft.rfft(x, norm="forward"))
    check(err < 1e-5, f"precompile(rfft_split) vs torch.fft.rfft {err:.2e}")
    xr, xi = pair((4096, 1024), torch.float32, seed=351)
    with tempfile.TemporaryDirectory() as logdir:
        with pu.trace(logdir):
            ct.fft_split(xr, xi)
        events = json.loads((Path(logdir) / "trace.json").read_text())
    kern = sorted({e["name"] for e in events["traceEvents"]
                   if e.get("cat") == "kernel"})
    check(bool(kern), f"trace.json names kernel rows: {kern[:2]}")
    with pu.Timer(sync=xr) as t:
        ct.fft_split(xr, xi)
    check(t.seconds > 0.0, f"Timer on CUDA events: {t.seconds * 1e3:.4f} ms "
          f"[{card}]")
    bad = torch.tensor([1.0, float("nan")], device=DEV)
    raised = False
    try:
        pu.check_finite(bad)
    except FloatingPointError as e:
        raised = True
        print(f"  check_finite raised: {e}")
    check(raised, "check_finite raises on a NaN")
    pu.enable_nan_checks(True)
    raised = False
    try:
        ct.fft(bad)
    except FloatingPointError:
        raised = True
    finally:
        pu.enable_nan_checks(False)
    check(raised, "enable_nan_checks: fft of a NaN raises at the API exit")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # ---- phase 1: setup and build
    print("phase 1: setup and build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    # the plain versions' matmuls must run at full float32
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "float32 matmul runs without TF32")
    t0 = time.perf_counter()
    _build.load()
    print(f"  K1-K11 built and loaded in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    for line in _build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  {line.strip()}")

    # ---- phase 2: K1 against its plain version and torch.fft, both
    # directions unscaled and the forward with a scale in its store, ragged
    # and full batches, and rows that start 4 or 8 bytes past an alignment
    print("phase 2: K1 vs plain version and torch.fft")
    bars = {torch.float32: 1e-5, torch.float64: 1e-12}
    for dt in (torch.float32, torch.float64):
        worst_p = worst_o = 0.0
        for n in K1_SIZES:
            if not fused_fft.fused_eligible(n, dt):
                continue
            reg = n in plan.REG_LENGTHS[dt]
            for b in K1_BATCHES + ((5,) if reg else ()):
                xr, xi = pair((b, n), dt, seed=n + b)
                if b == 5:
                    # an unaligned view: the planes start one element in
                    buf = real((2, b * n + 1), dt, seed=n)
                    xr, xi = (v[1:].view(b, n) for v in buf)
                x64 = torch.complex(xr.double(), xi.double())
                for inv, sc in ((False, 1.0), (True, 1.0), (False, 0.125)):
                    yr, yi = fused_fft.sfft_fused(xr, xi, n, inv, sc)
                    pr, pi = fused_fft.sfft_plain(xr, xi, n, inv)
                    torch.cuda.synchronize()
                    want = (torch.fft.ifft(x64) * n if inv
                            else torch.fft.fft(x64)) * sc
                    ep = rel_err(torch.complex(yr, yi),
                                 torch.complex(pr, pi) * sc)
                    eo = rel_err(torch.complex(yr, yi), want)
                    check(ep < bars[dt] and eo < bars[dt],
                          f"K1 {dt} n={n} b={b} inv={inv} scale={sc} "
                          f"({'register passes' if reg else 'stage loop'}):"
                          f" vs plain {ep:.2e}, vs torch.fft {eo:.2e} < "
                          f"{bars[dt]:g}")
                    worst_p, worst_o = max(worst_p, ep), max(worst_o, eo)
        was = BEFORE_WORST[f"K1 {str(dt).split('.')[-1]}"]
        print(f"  {dt}: worst vs plain {worst_p:.3e}, vs torch.fft "
              f"{worst_o:.3e} (before: {fmt_pair(was)})")

    # ---- phase 2b: K1's real modes (core.srfft/sirfft at even n with
    # n/2 a register length) against their plain versions and torch.fft,
    # both table sets of each mode (not counted in the main path)
    print("phase 2b: K1's real modes vs plain version and torch.fft")
    for dt in (torch.float32, torch.float64):
        for h in plan.REG_LENGTHS[dt]:
            n = 2 * h
            for b in (3, max(4, (1 << 21) // n)):
                x = real((b, n), dt, seed=n + b)
                yr, yi = fused_fft.srfft_real(x, n, 0.5)
                back = fused_fft.sirfft_real(yr, yi, n, 2.0 / n)
                gr, gi = real((2, b, h + 1), dt, seed=n + b + 1)
                g = fused_fft.srfft_real(x, n, 0.5, "irfft_adj")
                u = fused_fft.sirfft_real(gr, gi, n, 0.5, "rfft_adj")
                plain = [fused_fft._real_plain_rows(x, None, n, "rfft", 0.5),
                         fused_fft._real_plain_rows(x, None, n, "irfft_adj",
                                                    0.5),
                         fused_fft._real_plain_rows(gr, gi, n, "rfft_adj",
                                                    0.5)]
                torch.cuda.synchronize()
                want = torch.fft.rfft(x.double()) * 0.5
                ep = max(rel_err(torch.complex(yr, yi),
                                 torch.complex(*plain[0])),
                         rel_err(torch.complex(*g), torch.complex(*plain[1])),
                         rel_err(u, plain[2]))
                eo = max(rel_err(torch.complex(yr, yi), want),
                         rel_err(back, x))
                zero = bool((yi[:, 0] == 0).all() and (yi[:, h] == 0).all())
                bar = 1e-5 if dt == torch.float32 else 1e-12
                check(ep < bar and eo < bar and zero,
                      f"K1 real modes {dt} n={n} b={b}: vs plain {ep:.2e}, "
                      f"vs torch.fft {eo:.2e} < {bar:g}, imag DC and "
                      f"Nyquist zero")

    # ---- phase 3: K2, K3, K4 against their plain versions and torch.fft
    print("phase 3: K2/K3/K4 vs plain version and torch.fft")
    stream_err = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    worst_p = worst_o = 0.0
    for n in STREAM_SIZES:
        m = n // 128
        for b in (3, (1 << 22) // n):
            for mode, s in [(md, 1) for md in STREAM_MODES] + [("filter", 2)]:
                shape = (b, 128, m) if mode == "inv_nat" else (b, m, 128)
                xr, xi = pair(shape, torch.float32, seed=n + b + s)
                fr = fi = None
                if mode == "filter":
                    fr, fi = pair((s, m, 128), torch.float32, seed=n + s)
                yr, yi = stream_fft._launch(xr, xi, n, mode, fr, fi)
                pr, pi = stream_fft.stream_plain(xr, xi, n, mode, fr, fi)
                torch.cuda.synchronize()
                got = torch.complex(yr, yi)
                want = stream_reference(
                    torch.complex(xr, xi), n, mode,
                    None if fr is None else torch.complex(fr, fi))
                ep = rel_err(got, torch.complex(pr, pi))
                eo = rel_err(got, want)
                k = STREAM_KERNEL[mode]
                check(ep < 1e-5 and eo < 1e-5,
                      f"{k} {mode} s={s} n={n} b={b}: vs plain {ep:.2e}, "
                      f"vs torch.fft {eo:.2e} < 1e-5")
                stream_err[k] = max(stream_err[k], float(max(
                    (yr - pr).abs().max(), (yi - pi).abs().max())))
                worst_p, worst_o = max(worst_p, ep), max(worst_o, eo)
    for m in K3_M:
        n = 128 * m
        route = stream_fft._k3_route(m)
        for b in (3, (1 << 22) // n):
            for mode, sc in (("fwd_nat", 0.5), ("inv_nat", 0.25)):
                shape = (b, 128, m) if mode == "inv_nat" else (b, m, 128)
                xr, xi = pair(shape, torch.float32, seed=m + b)
                before = profiling.launches["K3"]
                yr, yi = stream_fft._launch(xr, xi, n, mode, scale=sc)
                check(profiling.launches["K3"] == before + 1,
                      "K3 counts one launch a call")
                pr, pi = stream_fft.stream_plain(xr, xi, n, mode, scale=sc)
                torch.cuda.synchronize()
                got = torch.complex(yr, yi)
                want = stream_reference(torch.complex(xr, xi), n, mode) * sc
                ep = rel_err(got, torch.complex(pr, pi))
                eo = rel_err(got, want)
                check(ep < 1e-5 and eo < 1e-5,
                      f"K3 {mode} n={n} b={b} scale={sc} route={route}: vs "
                      f"plain {ep:.2e}, vs torch.fft {eo:.2e} < 1e-5")
                stream_err["K3"] = max(stream_err["K3"], float(max(
                    (yr - pr).abs().max(), (yi - pi).abs().max())))
                worst_p, worst_o = max(worst_p, ep), max(worst_o, eo)
    # K2 on each route: the forward from contiguous planes and from the
    # strided planes of paired rows (xp[:, 0] and xp[:, 1] of (b, 2, n),
    # as sfilter_stream hands them), the inverse
    for m in K2_M:
        n = 128 * m
        for b in (3, (1 << 22) // n):
            rows = real((b, 2, n), torch.float32, seed=m + b)
            pairs = tuple(rows[:, j].reshape(b, m, 128) for j in (0, 1))
            flat = pair((b, m, 128), torch.float32, seed=m + b + 1)
            for mode, (xr, xi), what in (("fwd", flat, "planes"),
                                         ("fwd", pairs, "paired rows"),
                                         ("inv", flat, "planes")):
                route = stream_fft._k2_route(m, mode == "inv")
                before = profiling.launches["K2"]
                yr, yi = stream_fft._launch(xr, xi, n, mode)
                check(profiling.launches["K2"] == before + 1,
                      "K2 counts one launch a call")
                pr, pi = stream_fft.stream_plain(xr, xi, n, mode)
                torch.cuda.synchronize()
                got = torch.complex(yr, yi)
                want = stream_reference(torch.complex(xr, xi), n, mode)
                ep = rel_err(got, torch.complex(pr, pi))
                eo = rel_err(got, want)
                check(ep < 1e-5 and eo < 1e-5,
                      f"K2 {mode} n={n} b={b} from {what} route={route}: vs "
                      f"plain {ep:.2e}, vs torch.fft {eo:.2e} < 1e-5")
                stream_err["K2"] = max(stream_err["K2"], float(max(
                    (yr - pr).abs().max(), (yi - pi).abs().max())))
                worst_p, worst_o = max(worst_p, ep), max(worst_o, eo)
            del rows, pairs, flat
    # K4 with a scale, into the strided planes of paired rows (out[:, 0]
    # and out[:, 1] of (b, 2, n), as sfilter_stream hands them)
    for m in K4_M:
        n = 128 * m
        route = ("cluster C=%d" % stream_fft._filter_cluster_size(m)
                 if m in stream_fft._CLUSTER_M else "stage loop")
        for b in (3, (1 << 22) // n):
            for s in (1, 2):
                xr, xi = pair((b, m, 128), torch.float32, seed=m + b + s)
                fr, fi = pair((s, m, 128), torch.float32, seed=m + s)
                out = torch.full((b, 2, n), float("nan"), device=DEV)
                before = profiling.launches["K4"]
                stream_fft._launch(xr, xi, n, "filter", fr, fi, scale=0.5,
                                   out=(out[:, 0], out[:, 1]))
                check(profiling.launches["K4"] == before + 1,
                      "K4 counts one launch a call")
                pr, pi = stream_fft.stream_plain(xr, xi, n, "filter", fr, fi,
                                                 scale=0.5)
                torch.cuda.synchronize()
                got = torch.complex(out[:, 0], out[:, 1]).reshape(b, m, 128)
                want = stream_reference(torch.complex(xr, xi), n, "filter",
                                        torch.complex(fr, fi)) * 0.5
                ep = rel_err(got, torch.complex(pr, pi))
                eo = rel_err(got, want)
                check(ep < 1e-5 and eo < 1e-5,
                      f"K4 filter s={s} n={n} b={b} scale=0.5 into paired "
                      f"rows ({route}): vs plain {ep:.2e}, vs torch.fft "
                      f"{eo:.2e} < 1e-5")
                stream_err["K4"] = max(stream_err["K4"], float(max(
                    (got.real - pr).abs().max(), (got.imag - pi).abs().max())))
                worst_p, worst_o = max(worst_p, ep), max(worst_o, eo)
    print(f"  worst vs plain {worst_p:.3e}, vs torch.fft {worst_o:.3e}; "
          f"worst |error| vs plain K2 {stream_err['K2']:.3e}, K4 "
          f"{stream_err['K4']:.3e}")

    # ---- phase 3b: K7 and K8 against their plain versions and torch.fft
    # or scipy (float64 on the host; its unnormalised DCT types 2-4 are
    # twice the cores' sums)
    print("phase 3b: K7/K8 vs plain version, torch.fft and scipy")
    rs_err = {"K7": 0.0, "K8": 0.0}
    worst = {"plain": 0.0, "oracle": 0.0}

    def hold(k, what, got, plain, want, scale=1.0):
        """Kernel output against its plain version and an oracle; the
        absolute error is taken on got / scale (irfft's output is n*x)."""
        ep, eo = rel_err(got, plain), rel_err(got, want)
        check(ep < 1e-5 and eo < 1e-5,
              f"{k} {what}: vs plain {ep:.2e}, vs oracle {eo:.2e} < 1e-5")
        rs_err[k] = max(rs_err[k], float((got - plain).abs().max()) / scale)
        worst["plain"] = max(worst["plain"], ep)
        worst["oracle"] = max(worst["oracle"], eo)

    def host(a):
        return torch.as_tensor(a, device=DEV)

    for mm in RSTREAM_M:
        n = 128 * mm
        route = (f"cluster C={stream_fft._cluster_size(mm)}"
                 if mm in stream_fft._CLUSTER_M else "stage loop")
        for b in (4, max(2, (1 << 22) // n // 2 * 2)):
            x = real((b, n), torch.float32, seed=n + b)
            xh = x.double().cpu().numpy()
            # a scale, and ortho's weight of bin 0, ride in the kernel
            sc = 0.5
            yr, yi = rstream.launch("rfft", n, x, scale=sc)
            hold("K7", f"rfft n={n} B={b} scale={sc} ({route})",
                 torch.complex(yr, yi),
                 torch.complex(*rstream_plain("rfft", n, x, scale=sc)),
                 torch.fft.rfft(x.double()) * sc)
            check(not bool(yi[:, 0].any()) and not bool(yi[:, -1].any()),
                  "K7 rfft: imag(DC) and imag(Nyquist) exactly 0")
            hold("K7", f"irfft n={n} B={b} scale={1 / n:g} ({route})",
                 rstream.launch("irfft", n, yr, yi, scale=1.0 / n),
                 rstream_plain("irfft", n, yr, yi, scale=1.0 / n),
                 x.double() * sc)
            for t, w0 in ((2, float(np.sqrt(0.5))), (3, float(np.sqrt(2.0)))):
                mode = f"dct{t}"
                sc = float(np.sqrt(2.0 / n))
                hold("K7", f"{mode} n={n} B={b} ortho ({route})",
                     rstream.launch(mode, n, x, scale=sc, w0=w0),
                     rstream_plain(mode, n, x, scale=sc, w0=w0),
                     host(scipy.fft.dct(xh, t, norm="ortho")))
            n4, b4 = 2 * n, max(1, b // 2)
            x4 = real((b4, n4), torch.float32, seed=n4 + b4)
            x4h = x4.double().cpu().numpy()
            for dst, sp in ((False, scipy.fft.dct), (True, scipy.fft.dst)):
                for sc in (1.0, 0.25):
                    hold("K8", f"{'dst4' if dst else 'dct4'} n={n4} B={b4} "
                         f"scale={sc} ({route})",
                         rstream.launch("dct4", n4, x4, scale=sc, dst=dst),
                         rstream_plain("dct4", n4, x4, scale=sc, dst=dst),
                         host(sp(x4h, 4) / 2 * sc))
    print(f"  worst vs plain {worst['plain']:.3e}, vs torch.fft/scipy "
          f"{worst['oracle']:.3e}; K8 worst |error| vs plain "
          f"{rs_err['K8']:.3e}")

    # ---- phase 3c: K6 and K9 against their plain versions, torch.fft
    # over dim -2 (complex128) and scipy over axis -2 (float64 on the
    # host; its unnormalised DCT types 2-3 are twice the cores' sums)
    print("phase 3c: K6/K9 vs plain version, torch.fft and scipy")
    col_err = {"K6": 0.0, "K9": 0.0}
    worst = {"plain": 0.0, "oracle": 0.0}

    def hold_col(k, what, got, plain, want):
        ep, eo = rel_err(got, plain), rel_err(got, want)
        check(ep < 1e-5 and eo < 1e-5,
              f"{k} {what}: vs plain {ep:.2e}, vs oracle {eo:.2e} < 1e-5")
        col_err[k] = max(col_err[k], float((got - plain).abs().max()))
        worst["plain"] = max(worst["plain"], ep)
        worst["oracle"] = max(worst["oracle"], eo)

    for n0 in COL_N0:
        for n1 in COL_N1:
            xr, xi = pair((3, n0, n1), torch.float32, seed=n0 + n1)
            ref = torch.fft.fft(torch.complex(xr.double(), xi.double()),
                                dim=-2)
            iref = torch.fft.ifft(torch.complex(xr.double(), xi.double()),
                                  dim=-2) * n0
            for inv, scale, want in ((False, 1.0, ref), (True, 1.0, iref),
                                     (False, 0.25, ref * 0.25)):
                yr, yi = colfft.scolfft(xr, xi, inv, scale)
                pr, pi = colfft.colfft_plain(xr, xi, inv, scale)
                torch.cuda.synchronize()
                hold_col("K6", f"n0={n0} n1={n1} b=3 inv={inv} scale={scale}",
                         torch.complex(yr, yi), torch.complex(pr, pi), want)
            for b in (2, 6):
                x = real((b, n0, n1), torch.float32, seed=n0 + n1 + b)
                xh = x.double().cpu().numpy()
                for t, plain in ((2, colfft.coldct2_plain),
                                 (3, colfft.coldct3_plain)):
                    y = colfft.scoldct(x, t)
                    torch.cuda.synchronize()
                    hold_col("K9", f"dct{t} n0={n0} n1={n1} b={b}", y,
                             plain(x, n0),
                             host(scipy.fft.dct(xh, t, axis=-2, workers=8)
                                  / 2))
    # the fused row weight and scale (the ortho norms' path)
    x = real((2, 1024, 513), torch.float32, seed=31)
    w = torch.rand(1024, device=DEV) + 0.5
    for t in (2, 3):
        hold_col("K9", f"dct{t} n0=1024 n1=513 with row weight and scale",
                 colfft.scoldct(x, t, w, 0.125),
                 colfft.coldct_plain(x, t, w, 0.125),
                 colfft.coldct_plain(x.double(), t, w.double(), 0.125))
    print(f"  worst vs plain {worst['plain']:.3e}, vs torch.fft/scipy "
          f"{worst['oracle']:.3e}")

    # ---- phase 3d: the product under K10 and K11 alone, then K10 and K11
    # against their plain versions and torch.fft (complex128), ragged and
    # full batches, both signs, K11 in its four forms
    print("phase 3d: K10/K11 vs plain version and torch.fft")
    dense_err = {"K10": 0.0, "K11": 0.0}
    worst = {"plain": 0.0, "oracle": 0.0}

    def hold_dense(k, what, got, plain, want):
        yr, yi = got
        pr, pi = plain
        torch.cuda.synchronize()
        ep = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
        eo = rel_err(torch.complex(yr, yi), want)
        check(ep < 1e-5 and eo < 1e-5,
              f"{k} {what}: vs plain {ep:.2e}, vs torch.fft {eo:.2e} < 1e-5")
        dense_err[k] = max(dense_err[k], float(max((yr - pr).abs().max(),
                                                   (yi - pi).abs().max())))
        worst["plain"] = max(worst["plain"], ep)
        worst["oracle"] = max(worst["oracle"], eo)

    # the product alone, in each stride case of K11's two passes
    worst_c = 0.0
    for M, N, K in PRODUCT_SHAPES:
        for batch in (1, 5):
            for case in PRODUCT_CASES:
                e = product_alone(_build.load(), M, N, K, batch, case)
                check(e < 2e-6, f"product M={M} N={N} K={K} b={batch}, "
                      f"{case}: vs complex128 matmul {e:.2e} < 2e-6")
                worst_c = max(worst_c, e)
    print(f"  product alone: worst vs complex128 matmul {worst_c:.3e}")
    for n in K10_SIZES:
        for b in (3, (1 << 22) // n) + K10_RAGGED.get(n, ()):
            xr, xi = pair((b, n), torch.float32, seed=n + b)
            x64 = torch.complex(xr.double(), xi.double())
            for inv in (False, True):
                hold_dense("K10", f"n={n} b={b} inv={inv}",
                           fourstep_fft.sfft_fourstep(xr, xi, n, inv),
                           fourstep_fft.sfft_fourstep_plain(xr, xi, n, inv),
                           torch.fft.ifft(x64) * n if inv
                           else torch.fft.fft(x64))
    for mm in K11_M:
        n = 128 * mm
        for b in (3, (1 << 22) // n):
            xr, xi = pair((b, n), torch.float32, seed=n + b)
            for inv, nat in K11_FORMS:
                fn = (stream_fft.sfft_mm2 if nat
                      else stream_fft.sfft_mm2_permuted)
                hold_dense("K11", f"m={mm} b={b} inv={inv} natural={nat}",
                           fn(xr, xi, n, inv),
                           stream_fft.sfft_mm2_plain(xr, xi, n, inv, nat),
                           mm2_reference(torch.complex(xr, xi), n, inv, nat))
    print(f"  worst vs plain {worst['plain']:.3e}, vs torch.fft "
          f"{worst['oracle']:.3e}")
    del x64

    # ---- the main path: each path runs with the counts zeroed just
    # before it and read just after; `total` sums them
    total = dict.fromkeys(KERNELS, 0)
    kern_err = 0.0

    # ---- phase 4: bench headline fft_split at (4096, 1024), ortho
    print("phase 4: fft_split n=1024 batch=4096 f32 norm=ortho")
    xr, xi = pair((4096, 1024), torch.float32, seed=3)
    (yr, yi), got = drive(lambda: ct.fft_split(xr, xi, norm="ortho"), total)
    check(got["K1"] > 0, f"K1 launched by fft_split ({got})")
    with plain_engine():
        pr, pi = ct.fft_split(xr, xi, norm="ortho")
    kern_err = max(kern_err, float(max((yr - pr).abs().max(),
                                       (yi - pi).abs().max())))
    e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
    e_o = rel_err(torch.complex(yr, yi),
                  torch.fft.fft(torch.complex(xr, xi), norm="ortho"))
    check(tuple(yr.shape) == (4096, 1024) and bool(torch.isfinite(yr).all()),
          "fft_split output shape and finite")
    check(e_p < 1e-5, f"fft_split vs plain {e_p:.2e} < 1e-5")
    check(e_o < 1e-5, f"fft_split vs torch.fft {e_o:.2e} < 1e-5")

    # ---- phase 5: flagship step at n=960, batch 64 and batch 4096
    for batch in (64, 4096):
        print(f"phase 5: flagship step n=960 batch={batch} f32")
        step, args = entry(DEV, batch=batch)
        out, got = drive(lambda: step(*args), total)
        check(got["K1"] > 0, f"K1 launched by the step ({got})")
        with plain_engine():
            want = step(*args)
        e_p = rel_err(out, want)
        check(tuple(out.shape) == (batch, 960)
              and bool(torch.isfinite(out).all()), "step output shape, finite")
        check(e_p < 1e-5, f"step vs plain {e_p:.2e} < 1e-5")
        # the step's halves against torch.fft: the packed spectrum, and
        # the inverse on it (the multiply leaves DC and Nyquist complex,
        # which torch.fft.irfft would drop and the reference does not)
        v = args[0]
        sr, si = ct.rfft_split(v)
        e_o = rel_err(torch.complex(sr, si),
                      torch.fft.rfft(v.double(), norm="forward"))
        check(e_o < 1e-4, f"rfft_split vs torch.fft {e_o:.2e} < 1e-4")
        e_r = rel_err(ct.irfft_split(sr, si, 960), v)
        check(e_r < 1e-4, f"irfft_split(rfft_split(v)) vs v {e_r:.2e} < 1e-4")

    # ---- phase 6: the pricer in float64
    strikes = np.arange(80.0, 120.0, 0.5)
    bs = bs_closed_form(100.0, strikes, 0.2, 0.25, 0.03)

    def price(n, dtype=torch.float64):
        return conv_option_price(100.0, strikes, 0.25, 0.03,
                                 lambda u: bs_cf(u, 0.25, 0.2, 0.03),
                                 n=n, grid_sigma=0.2, device=DEV,
                                 dtype=dtype)

    for n in (4096, 1 << 14):
        print(f"phase 6: conv_option_price 80 strikes n={n} f64")
        got_p, got = drive(lambda: price(n), total)
        check(got["K1"] > 0, f"K1 launched by the pricer ({got})")
        with plain_engine():
            want = price(n)
        e_bs = float(np.abs(got_p - bs).max())
        e_p = float(np.abs(got_p - want).max() / np.abs(want).max())
        check(got_p.shape == (80,) and bool(np.isfinite(got_p).all()),
              "prices shape and finite")
        check(e_bs < 5e-3, f"vs Black-Scholes {e_bs:.2e} < 5e-3")
        check(e_p < 1e-12, f"vs plain {e_p:.2e} < 1e-12")
    print("phase 6: conv_bsvg_option VG n=2^16 f64")

    def vg_price():
        return conv_bsvg_option(1 << 16, VG["S"], VG["K"], VG["sigma"],
                                VG["theta"], VG["kappa"], VG["t"], VG["r"],
                                is_bs=False, device=DEV)
    vg, got = drive(vg_price, total)
    check(got["K1"] > 0, f"K1 launched by the VG pricer ({got})")
    with plain_engine():
        vg_plain = vg_price()
    check(abs(vg - vg_plain) < 1e-12 * abs(vg_plain),
          f"VG {vg!r} vs plain {vg_plain!r}")
    check(abs(vg - VG_CONV) < 1e-7,
          f"VG vs the reference conv price {abs(vg - VG_CONV):.2e} < 1e-7")

    # ---- phase 7: Bluestein and four-step routes (57344 = 7 * 2^13 has
    # no stream length: the four-step with K1 at 896 on its rows)
    for n, b in ((1009, 1024), (57344, 64)):
        print(f"phase 7: fft_split n={n} batch={b} f32")
        xr, xi = pair((b, n), torch.float32, seed=n)
        (yr, yi), got = drive(lambda: ct.fft_split(xr, xi, norm="backward"),
                              total)
        check(got["K1"] > 0 and got["K2"] + got["K3"] == 0,
              f"K1 launched, no stream kernel ({got})")
        with plain_engine():
            pr, pi = ct.fft_split(xr, xi, norm="backward")
        e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
        e_o = rel_err(torch.complex(yr, yi),
                      torch.fft.fft(torch.complex(xr.double(), xi.double())))
        check(e_p < 1e-5, f"vs plain {e_p:.2e} < 1e-5")
        check(e_o < 1e-4, f"vs torch.fft {e_o:.2e} < 1e-4")

    # ---- phase 8: fft_split (64, 65536) through K3, and back
    print("phase 8: fft_split n=65536 batch=64 f32 norm=ortho")
    xr, xi = pair((64, 65536), torch.float32, seed=8)
    (yr, yi), got = drive(lambda: ct.fft_split(xr, xi, norm="ortho"), total)
    check(got["K3"] > 0, f"K3 launched by fft_split ({got})")
    with plain_engine():
        pr, pi = ct.fft_split(xr, xi, norm="ortho")
    e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
    e_o = rel_err(torch.complex(yr, yi), torch.fft.fft(
        torch.complex(xr.double(), xi.double()), norm="ortho"))
    check(tuple(yr.shape) == (64, 65536) and bool(torch.isfinite(yr).all()),
          "output shape and finite")
    check(e_p < 1e-5, f"vs plain {e_p:.2e} < 1e-5")
    check(e_o < 1e-5, f"vs torch.fft {e_o:.2e} < 1e-5")
    (zr, zi), got = drive(lambda: ct.ifft_split(yr, yi, norm="ortho"), total)
    check(got["K3"] > 0, f"K3 launched by ifft_split ({got})")
    e_r = rel_err(torch.complex(zr, zi), torch.complex(xr, xi))
    check(e_r < 1e-5, f"ifft_split(fft_split(x)) vs x {e_r:.2e} < 1e-5")

    # ---- phase 9: fft_split and ifft_split past the cap: K5 splits s = 2
    # and 4 ways, two kernels a call, under every norm, against the plain
    # route and torch.fft in complex128 (fftpack is torch's "forward")
    k5_err, worst_k5 = 0.0, [0.0, 0.0]
    for n, b in ((1 << 20, 8), (1 << 21, 4)):
        s = stream_fft._filter_split_factor(n)
        xr, xi = pair((b, n), torch.float32, seed=9 + s)
        x64 = torch.complex(xr.double(), xi.double())
        for norm in ("fftpack", "ortho", "backward", "forward"):
            tnorm = "forward" if norm == "fftpack" else norm
            for name, fn, ref in (("fft_split", ct.fft_split, torch.fft.fft),
                                  ("ifft_split", ct.ifft_split,
                                   torch.fft.ifft)):
                print(f"phase 9: {name} n={n} batch={b} f32 norm={norm} "
                      f"(split s={s})")
                (yr, yi), got = drive(lambda: fn(xr, xi, norm=norm), total)
                check(got["K5"] > 0 and got["K2"] + got["K3"] == 0,
                      f"K5 launched, no K2 or K3 ({got})")
                with plain_engine():
                    pr, pi = fn(xr, xi, norm=norm)
                e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
                e_o = rel_err(torch.complex(yr, yi), ref(x64, norm=tnorm))
                check(tuple(yr.shape) == (b, n)
                      and bool(torch.isfinite(yr).all())
                      and bool(torch.isfinite(yi).all()),
                      "output shape and finite")
                check(e_p < 1e-5 and e_o < 1e-5, f"vs plain {e_p:.2e}, vs "
                      f"torch.fft complex128 {e_o:.2e} < 1e-5")
                worst_k5 = [max(worst_k5[0], e_p), max(worst_k5[1], e_o)]
                if norm == "backward":
                    k5_err = max(k5_err, float(max((yr - pr).abs().max(),
                                                   (yi - pi).abs().max())))
    # K5's stage-loop column pass (every m but 4096; here m = 3072) at
    # s = 2 and 4: each mode with a scale (and a natural filter where the
    # filter route uses one) against its plain version and torch.fft in
    # complex128, then fft_split/ifft_split at those lengths
    for n, b in ((786432, 3), (1572864, 2)):
        s = stream_fft._filter_split_factor(n)
        print(f"phase 9: K5 modes n={n} batch={b} f32 (split s={s}, "
              f"m={n // s // 128}: the stage-loop column pass)")
        xr, xi = pair((b, n), torch.float32, seed=90 + s)
        f9 = pair((n,), torch.float32, seed=91 + s)
        x64 = torch.complex(xr.double(), xi.double())
        for mode, f, scale in (("split", f9, 0.5), ("split", None, 1.0),
                               ("split_inv", None, 0.25),
                               ("split_conj", f9, 2.0)):
            yr, yi = stream_fft._launch(xr, xi, n, mode, *(f or (None, None)),
                                        scale=scale)
            pr, pi = stream_fft.stream_plain(xr, xi, n, mode,
                                             *(f or (None, None)), scale=scale)
            want = (torch.fft.ifft(x64) * n if mode == "split_inv"
                    else torch.fft.fft(x64)) * scale
            if f is not None:
                want = want * torch.complex(f[0].double(), f[1].double())
            if mode == "split_conj":
                want = want.conj()
            e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
            e_o = rel_err(torch.complex(yr, yi), want)
            check(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all())
                  and e_p < 1e-5 and e_o < 1e-5,
                  f"{mode} scale={scale} filter={f is not None}: vs plain "
                  f"{e_p:.2e}, vs torch.fft complex128 {e_o:.2e} < 1e-5")
            worst_k5 = [max(worst_k5[0], e_p), max(worst_k5[1], e_o)]
        for name, fn, ref in (("fft_split", ct.fft_split, torch.fft.fft),
                              ("ifft_split", ct.ifft_split, torch.fft.ifft)):
            print(f"phase 9: {name} n={n} batch={b} f32 norm=ortho "
                  f"(split s={s})")
            (yr, yi), got = drive(lambda: fn(xr, xi, norm="ortho"), total)
            check(got["K5"] > 0 and got["K2"] + got["K3"] == 0,
                  f"K5 launched, no K2 or K3 ({got})")
            e_o = rel_err(torch.complex(yr, yi), ref(x64, norm="ortho"))
            check(tuple(yr.shape) == (b, n) and e_o < 1e-5,
                  f"shape, vs torch.fft complex128 {e_o:.2e} < 1e-5")
            worst_k5[1] = max(worst_k5[1], e_o)
    print(f"  K5 route: worst vs plain {worst_k5[0]:.3e}, vs torch.fft "
          f"{worst_k5[1]:.3e} (before: {fmt_pair(BEFORE_WORST['K5'])})")
    del x64, yr, yi, pr, pi

    # ---- phase 10: the streaming filter at (64, 65536)
    print("phase 10: rfilter_split n=65536 batch=64 f32")
    g = torch.Generator(device=DEV).manual_seed(10)
    x = torch.randn((64, 65536), generator=g, device=DEV)
    fr, fi = pair((32769,), torch.float32, seed=11)
    fi[0] = 0.0
    fi[-1] = 0.0
    out, got = drive(lambda: ct.rfilter_split(x, fr, fi), total)
    check(got["K2"] == 1 and got["K4"] == 1,
          f"one K2 and one K4 launch in rfilter_split, both on the cluster, "
          f"K2 reading the paired rows, K4 writing them with the norm's "
          f"scale in its store ({got})")
    with plain_engine():
        want = ct.rfilter_split(x, fr, fi)
    e_p = rel_err(out, want)
    yr, yi = ct.rfft_split(x)
    comp = ct.irfft_split(yr * fr - yi * fi, yr * fi + yi * fr, 65536)
    e_c = rel_err(out, comp)
    check(tuple(out.shape) == (64, 65536) and bool(torch.isfinite(out).all()),
          "output shape and finite")
    check(e_p < 1e-5, f"vs plain {e_p:.2e} < 1e-5")
    check(e_c < 1e-4, f"vs rfft_split -> multiply -> irfft_split {e_c:.2e} "
          f"< 1e-4")
    # along axis 0 of a (65536, 64) x: the paired rows have element stride
    # 64, so sfilter_stream copies them once into rows K2 reads
    xt = x.T.contiguous()
    out, got = drive(lambda: ct.rfilter_split(xt, fr, fi, axis=0), total)
    check(got["K2"] == 1 and got["K4"] == 1,
          f"axis 0: one K2 and one K4 launch ({got})")
    with plain_engine():
        want = ct.rfilter_split(xt, fr, fi, axis=0)
    e_t = rel_err(out, want)
    check(tuple(out.shape) == (65536, 64) and e_t < 1e-5,
          f"axis 0 (65536, 64): shape, vs plain {e_t:.2e} < 1e-5")
    del xt

    # ---- phase 10b: the streaming filter past the cap, (16, 2^20): two K5
    # calls through the paired rows, the filter in the first call's store
    print("phase 10b: rfilter_split n=2^20 batch=16 f32")
    xf = real((16, 1 << 20), torch.float32, seed=12)
    ff = pair(((1 << 19) + 1,), torch.float32, seed=13)
    ff[1][0] = 0.0
    ff[1][-1] = 0.0
    out, got = drive(lambda: ct.rfilter_split(xf, *ff), total)
    check(got["K5"] == 2 and got["K2"] + got["K4"] == 0,
          f"two K5 calls, no K2 or K4 ({got})")
    with plain_engine():
        want = ct.rfilter_split(xf, *ff)
    e_p = rel_err(out, want)
    f64 = torch.complex(*(f.double() for f in ff))
    e_o = rel_err(out, torch.fft.irfft(torch.fft.rfft(xf.double()) * f64,
                                       n=1 << 20))
    check(tuple(out.shape) == (16, 1 << 20)
          and bool(torch.isfinite(out).all()), "output shape and finite")
    check(e_p < 1e-5 and e_o < 1e-5, f"vs plain {e_p:.2e}, vs torch.fft "
          f"rfft -> multiply -> irfft in float64 {e_o:.2e} < 1e-5")
    del xf, out, want

    # ---- phase 11: the pricer in float32 at the 2^20 grid (K5, s = 2)
    print("phase 11: conv_option_price 80 strikes n=2^20 f32")
    p32, got = drive(lambda: price(1 << 20, torch.float32), total)
    check(got["K5"] > 0 and got["K2"] + got["K4"] == 0,
          f"K5 launched by the pricer, no K2 or K4 ({got})")
    e_bs = float(np.abs(p32 - bs).max())
    check(p32.shape == (80,) and bool(np.isfinite(p32).all()),
          "prices shape and finite")
    check(e_bs < 5e-3, f"vs Black-Scholes {e_bs:.2e} < 5e-3")
    p64 = price(1 << 20)
    print(f"  f32 vs the f64 pricer at n=2^20: max |diff| "
          f"{float(np.abs(p32 - p64).max()):.3e}; f64 vs Black-Scholes "
          f"{float(np.abs(p64 - bs).max()):.3e}")

    # ---- phase 12: rfft_split -> irfft_split at (64, 65536) through K7
    print("phase 12: rfft_split -> irfft_split n=65536 batch=64 f32")
    x = real((64, 65536), torch.float32, seed=20)
    xh = x.double().cpu().numpy()
    (yr, yi), got = drive(lambda: ct.rfft_split(x), total)
    check(got["K7"] > 0 and got["K3"] == 0,
          f"K7 launched by rfft_split, no K3 ({got})")
    with plain_engine():
        pr, pi = ct.rfft_split(x)
    e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
    e_o = rel_err(torch.complex(yr, yi),
                  torch.fft.rfft(x.double(), norm="forward"))
    check(tuple(yr.shape) == (64, 32769) and bool(torch.isfinite(yr).all())
          and bool(torch.isfinite(yi).all()), "output shape and finite")
    check(not bool(yi[:, 0].any()) and not bool(yi[:, -1].any()),
          "imag(DC) and imag(Nyquist) exactly 0")
    check(e_p < 1e-5, f"vs plain {e_p:.2e} < 1e-5")
    check(e_o < 1e-5, f"vs torch.fft {e_o:.2e} < 1e-5")
    z, got = drive(lambda: ct.irfft_split(yr, yi, 65536), total)
    check(got["K7"] > 0, f"K7 launched by irfft_split ({got})")
    e_r = rel_err(z, x)
    check(e_r < 1e-5, f"irfft_split(rfft_split(x)) vs x {e_r:.2e} < 1e-5")

    def trig(name, fn, t, k, x, xh, bar=1e-5):
        """fn(x, t, norm="ortho") through kernel k against the plain
        engine and scipy (orthonormal, so no factor); returns it."""
        y, got = drive(lambda: fn(x, t, norm="ortho"), total)
        check(got[k] > 0, f"{k} launched by {name} type {t} ({got})")
        with plain_engine():
            want = fn(x, t, norm="ortho")
        sp = getattr(scipy.fft, name)(xh, t, axis=-1, norm="ortho")
        e_p, e_o = rel_err(y, want), rel_err(y, host(sp))
        check(tuple(y.shape) == tuple(x.shape)
              and bool(torch.isfinite(y).all()), "output shape and finite")
        check(e_p < bar and e_o < bar,
              f"{name} type {t}: vs plain {e_p:.2e}, vs scipy {e_o:.2e} "
              f"< {bar:g}")
        return y, got

    # ---- phase 13: dct/idct types 2 and 3 at (64, 65536) through K7
    for t in (2, 3):
        print(f"phase 13: dct/idct type {t} n=65536 batch=64 f32 ortho")
        y, got = trig("dct", ct.dct, t, "K7", x, xh)
        check(got["K3"] == 0, f"no K3 ({got})")
        z, _ = trig("idct", ct.idct, t, "K7", y, y.double().cpu().numpy())
        e_r = rel_err(z, x)
        check(e_r < 1e-5, f"idct(dct(x)) vs x {e_r:.2e} < 1e-5")

    # ---- phase 14: dct and dst type 4 at (64, 65536) through K8, one
    # launch a call under every norm (the scale, and DST-IV's flip and
    # sign, in the kernel)
    for name, fn in (("dct", ct.dct), ("dst", ct.dst)):
        print(f"phase 14: {name} type 4 n=65536 batch=64 f32 ortho")
        _, got = trig(name, fn, 4, "K8", x, xh)
        check(got["K3"] == 0, f"no K3 ({got})")
        sp = getattr(scipy.fft, name)(xh, 4) / 2
        for norm, sc in (("ortho", float(np.sqrt(2.0 / 65536))),
                         ("forward", 2.0 / 65536), ("backward", 1.0)):
            y, got = drive(lambda: fn(x, 4, norm=norm), total)
            check(got["K8"] == 1 and sum(got.values()) == 1,
                  f"{name} type 4 norm={norm}: one K8 launch and no other "
                  f"({got})")
            e_o = rel_err(y, host(sp * sc))
            check(bool(torch.isfinite(y).all()) and e_o < 1e-5,
                  f"{name} type 4 norm={norm}: vs scipy {e_o:.2e} < 1e-5")

    # ---- phase 15: dst types 2 and 3 at (64, 65536) (K7 under the flips)
    for t in (2, 3):
        print(f"phase 15: dst type {t} n=65536 batch=64 f32 ortho")
        trig("dst", ct.dst, t, "K7", x, xh)

    # ---- phase 16: dct type 2 at (4096, 1024), K1 at 512
    print("phase 16: dct type 2 n=1024 batch=4096 f32 ortho")
    xb = real((4096, 1024), torch.float32, seed=21)
    _, got = trig("dct", ct.dct, 2, "K1", xb, xb.double().cpu().numpy())
    check(got["K7"] == 0, f"no K7 ({got})")

    # ---- phase 17: dctn type 2 over (-2, -1) at (4, 1024, 1024)
    print("phase 17: dctn type 2 axes=(-2, -1) shape (4, 1024, 1024) f32")
    xn = real((4, 1024, 1024), torch.float32, seed=22)
    y, got = drive(lambda: ct.dctn(xn, 2, axes=(-2, -1), norm="ortho"),
                   total)
    check(got["K1"] > 0 and got["K9"] > 0,
          f"K1 (axis -1) and K9 (axis -2) launched by dctn ({got})")
    with plain_engine():
        want = ct.dctn(xn, 2, axes=(-2, -1), norm="ortho")
    e_p = rel_err(y, want)
    e_o = rel_err(y, host(scipy.fft.dctn(xn.double().cpu().numpy(), 2,
                                         axes=(-2, -1), norm="ortho")))
    check(tuple(y.shape) == (4, 1024, 1024) and bool(torch.isfinite(y).all()),
          "output shape and finite")
    check(e_p < 1e-5 and e_o < 1e-5,
          f"vs plain {e_p:.2e}, vs scipy {e_o:.2e} < 1e-5")

    # ---- phase 18: a float64 dct/idct type 2 round trip at (80, 16384)
    print("phase 18: dct/idct type 2 n=16384 batch=80 f64 ortho")
    x64 = real((80, 16384), torch.float64, seed=23)
    y, _ = trig("dct", ct.dct, 2, "K1", x64, x64.cpu().numpy(), bar=1e-12)
    z, _ = trig("idct", ct.idct, 2, "K1", y, y.cpu().numpy(), bar=1e-12)
    e_r = rel_err(z, x64)
    check(e_r < 1e-12, f"idct(dct(x)) vs x {e_r:.2e} < 1e-12")

    # ---- phase 20: fft2_split -> ifft2_split through K6 (axis -2) and
    # K1 (axis -1) at the candidate bench cell and at 64 images
    for b in (4, 64):
        print(f"phase 20: fft2_split -> ifft2_split shape ({b}, 1024, 1024) "
              f"f32 ortho")
        xr, xi = pair((b, 1024, 1024), torch.float32, seed=40 + b)
        (yr, yi), got = drive(lambda: ct.fft2_split(xr, xi, norm="ortho"),
                              total)
        check(got["K6"] > 0 and got["K1"] > 0,
              f"K6 and K1 launched by fft2_split ({got})")
        with plain_engine():
            pr, pi = ct.fft2_split(xr, xi, norm="ortho")
        e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
        del pr, pi
        e_o = rel_err(torch.complex(yr, yi), torch.fft.fft2(
            torch.complex(xr.double(), xi.double()), norm="ortho"))
        check(tuple(yr.shape) == (b, 1024, 1024)
              and bool(torch.isfinite(yr).all())
              and bool(torch.isfinite(yi).all()), "output shape and finite")
        check(e_p < 1e-5, f"vs plain {e_p:.2e} < 1e-5")
        check(e_o < 1e-5, f"vs torch.fft.fft2 {e_o:.2e} < 1e-5")
        (zr, zi), got = drive(lambda: ct.ifft2_split(yr, yi, norm="ortho"),
                              total)
        check(got["K6"] > 0 and got["K1"] > 0,
              f"K6 and K1 launched by ifft2_split ({got})")
        e_r = rel_err(torch.complex(zr, zi), torch.complex(xr, xi))
        check(e_r < 1e-5, f"ifft2_split(fft2_split(x)) vs x {e_r:.2e} < 1e-5")
        del yr, yi, zr, zi

    # ---- phase 21: complex fft2 reaches the same kernels
    print("phase 21: fft2 shape (4, 1024, 1024) complex64 backward")
    xc = torch.complex(*pair((4, 1024, 1024), torch.float32, seed=45))
    y, got = drive(lambda: ct.fft2(xc, norm="backward"), total)
    check(got["K6"] > 0 and got["K1"] > 0,
          f"K6 and K1 launched by fft2 ({got})")
    e_o = rel_err(y, torch.fft.fft2(xc.to(torch.complex128)))
    check(y.dtype == torch.complex64 and tuple(y.shape) == (4, 1024, 1024)
          and bool(torch.isfinite(y.real).all()),
          "output dtype, shape, finite")
    check(e_o < 1e-5, f"vs torch.fft.fft2 {e_o:.2e} < 1e-5")
    print("phase 21: fft2 shape (4, 512, 512) complex128 backward")
    xz = torch.complex(*pair((4, 512, 512), torch.float64, seed=46))
    y, got = drive(lambda: ct.fft2(xz, norm="backward"), total)
    check(got["K6"] == 0 and got["K1"] > 0,
          f"float64 keeps the moved axis: K1, no K6 ({got})")
    e_o = rel_err(y, torch.fft.fft2(xz))
    check(e_o < 1e-12, f"vs torch.fft.fft2 {e_o:.2e} < 1e-12")
    del xc, xz, y

    # ---- phase 22: rfft2_split -> irfft2_split, K6 on the 513 packed
    # columns
    print("phase 22: rfft2_split -> irfft2_split shape (64, 1024, 1024) f32")
    x2 = real((64, 1024, 1024), torch.float32, seed=47)
    (yr, yi), got = drive(lambda: ct.rfft2_split(x2, norm="ortho"), total)
    check(got["K6"] > 0 and got["K1"] > 0,
          f"K6 and K1 launched by rfft2_split ({got})")
    with plain_engine():
        pr, pi = ct.rfft2_split(x2, norm="ortho")
    e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
    del pr, pi
    e_o = rel_err(torch.complex(yr, yi),
                  torch.fft.rfft2(x2.double(), norm="ortho"))
    check(tuple(yr.shape) == (64, 1024, 513)
          and bool(torch.isfinite(yr).all())
          and bool(torch.isfinite(yi).all()), "output shape and finite")
    check(e_p < 1e-5, f"vs plain {e_p:.2e} < 1e-5")
    check(e_o < 1e-5, f"vs torch.fft.rfft2 {e_o:.2e} < 1e-5")
    z, got = drive(lambda: ct.irfft2_split(yr, yi, (1024, 1024),
                                           norm="ortho"), total)
    check(got["K6"] > 0 and got["K1"] > 0,
          f"K6 and K1 launched by irfft2_split ({got})")
    e_r = rel_err(z, x2)
    check(e_r < 1e-5, f"irfft2_split(rfft2_split(x)) vs x {e_r:.2e} < 1e-5")
    del yr, yi, z

    # ---- phase 23: dctn -> idctn type 2 at 64 images through K9
    print("phase 23: dctn -> idctn type 2 axes=(-2, -1) shape "
          "(64, 1024, 1024) f32 ortho")
    y, got = drive(lambda: ct.dctn(x2, 2, axes=(-2, -1), norm="ortho"),
                   total)
    check(got["K9"] > 0 and got["K1"] > 0,
          f"K9 and K1 launched by dctn ({got})")
    with plain_engine():
        want = ct.dctn(x2, 2, axes=(-2, -1), norm="ortho")
    e_p = rel_err(y, want)
    del want
    e_o = rel_err(y, host(scipy.fft.dctn(x2.double().cpu().numpy(), 2,
                                         axes=(-2, -1), norm="ortho",
                                         workers=8)))
    check(tuple(y.shape) == (64, 1024, 1024)
          and bool(torch.isfinite(y).all()), "output shape and finite")
    check(e_p < 1e-5 and e_o < 1e-5,
          f"vs plain {e_p:.2e}, vs scipy {e_o:.2e} < 1e-5")
    z, got = drive(lambda: ct.idctn(y, 2, axes=(-2, -1), norm="ortho"),
                   total)
    check(got["K9"] > 0 and got["K1"] > 0,
          f"K9 and K1 launched by idctn ({got})")
    e_r = rel_err(z, x2)
    check(e_r < 1e-5, f"idctn(dctn(x)) vs x {e_r:.2e} < 1e-5")
    del y, z

    # ---- phase 24: dstn keeps the moved axis (the column route is the
    # DCT's)
    print("phase 24: dstn type 2 axes=(-2, -1) shape (4, 1024, 1024) f32")
    y, got = drive(lambda: ct.dstn(xn, 2, axes=(-2, -1), norm="ortho"),
                   total)
    check(got["K9"] == 0 and got["K6"] == 0 and got["K1"] > 0,
          f"no K9 or K6 under dstn ({got})")
    e_o = rel_err(y, host(scipy.fft.dstn(xn.double().cpu().numpy(), 2,
                                         axes=(-2, -1), norm="ortho")))
    check(e_o < 1e-5, f"vs scipy {e_o:.2e} < 1e-5")
    del y

    # ---- phase 26: fft_split -> ifft_split with impl="pallas" through
    # K10, at 2^22 elements of each of three lengths
    for b, n in ((1024, 4096), (64, 65536), (16, 262144)):
        print(f"phase 26: fft_split -> ifft_split impl=pallas n={n} "
              f"batch={b} f32 norm=ortho")
        xr, xi = pair((b, n), torch.float32, seed=80 + b)
        (yr, yi), got = drive(lambda: ct.fft_split(xr, xi, norm="ortho",
                                                   impl="pallas"), total)
        check(got["K10"] > 0 and got["K3"] == 0 and got["K1"] == 0,
              f"K10 launched by fft_split, no K3 or K1 ({got})")
        with plain_engine():
            pr, pi = ct.fft_split(xr, xi, norm="ortho", impl="pallas")
        e_p = rel_err(torch.complex(yr, yi), torch.complex(pr, pi))
        e_o = rel_err(torch.complex(yr, yi), torch.fft.fft(
            torch.complex(xr.double(), xi.double()), norm="ortho"))
        check(tuple(yr.shape) == (b, n) and bool(torch.isfinite(yr).all())
              and bool(torch.isfinite(yi).all()), "output shape and finite")
        check(e_p < 1e-5, f"vs plain {e_p:.2e} < 1e-5")
        check(e_o < 1e-5, f"vs torch.fft {e_o:.2e} < 1e-5")
        (zr, zi), got = drive(lambda: ct.ifft_split(yr, yi, norm="ortho",
                                                    impl="pallas"), total)
        check(got["K10"] > 0 and got["K3"] == 0,
              f"K10 launched by ifft_split, no K3 ({got})")
        e_r = rel_err(torch.complex(zr, zi), torch.complex(xr, xi))
        check(e_r < 1e-5, f"ifft_split(fft_split(x)) vs x {e_r:.2e} < 1e-5")
    z1 = torch.zeros((2, 101), device=DEV)
    try:
        ct.fft_split(z1, z1, impl="pallas")
    except ValueError as exc:
        check("n=101" in str(exc), f"impl=pallas at n=101 raises ({exc})")
    else:
        check(False, "impl=pallas at n=101 raises")
    del pr, pi, yr, yi, zr, zi

    # ---- phase 27: the two-matmul FFT and back through K11, natural
    # and permuted spectra
    for b, n in ((2048, 2048), (128, 32768)):
        print(f"phase 27: sfft_mm2 -> inverse n={n} batch={b} f32")
        xr, xi = pair((b, n), torch.float32, seed=90 + b)
        xc = torch.complex(xr, xi)
        for nat, fn in ((True, stream_fft.sfft_mm2),
                        (False, stream_fft.sfft_mm2_permuted)):
            (yr, yi), got = drive(lambda: fn(xr, xi, n, False), total)
            check(got["K11"] > 0, f"K11 launched, natural={nat} ({got})")
            e_o = rel_err(torch.complex(yr, yi),
                          mm2_reference(xc, n, False, nat))
            check(tuple(yr.shape) == (b, n)
                  and bool(torch.isfinite(yr).all()),
                  "output shape and finite")
            check(e_o < 1e-5, f"natural={nat} vs torch.fft {e_o:.2e} < 1e-5")
            (zr, zi), got = drive(lambda: fn(yr, yi, n, True), total)
            check(got["K11"] > 0, f"K11 launched by the inverse ({got})")
            e_r = rel_err(torch.complex(zr, zi) / n, xc)
            check(e_r < 1e-5, f"inverse(forward(x)) / n vs x {e_r:.2e} "
                  f"< 1e-5")
    del xc, yr, yi, zr, zi

    # ---- phase 28: gdft -> igdft at (4096, 1024) complex64 with
    # fractional shifts, against the float64 run of the same call
    print("phase 28: gdft -> igdft n=1024 batch=4096 complex64 "
          "a=0.5 b=0.25 ortho")
    xg = torch.complex(*pair((4096, 1024), torch.float32, seed=95))
    y, got = drive(lambda: ct.gdft(xg, 0.5, 0.25, norm="ortho"), total)
    check(got["K1"] > 0, f"K1 launched by gdft ({got})")
    want = ct.gdft(xg.to(torch.complex128), 0.5, 0.25, norm="ortho")
    e_o = rel_err(y, want)
    check(y.dtype == torch.complex64 and tuple(y.shape) == (4096, 1024)
          and bool(torch.isfinite(y.real).all()),
          "output dtype, shape, finite")
    check(e_o < 1e-5, f"vs the float64 run {e_o:.2e} < 1e-5")
    # the definition on a few rows: sum_j x[j] e^{-2i pi (j+a)(k+b)/n}
    jj = torch.arange(1024, device=DEV, dtype=torch.float64)
    W = torch.exp(-2j * np.pi * torch.outer(jj + 0.25, jj + 0.5) / 1024)
    e_d = rel_err(want[:8], xg[:8].to(torch.complex128) @ W.T / 32.0)
    check(e_d < 1e-12, f"float64 run vs the definition {e_d:.2e} < 1e-12")
    z, got = drive(lambda: ct.igdft(y, 0.5, 0.25, norm="ortho"), total)
    check(got["K1"] > 0, f"K1 launched by igdft ({got})")
    e_r = rel_err(z, xg)
    check(e_r < 1e-5, f"igdft(gdft(x)) vs x {e_r:.2e} < 1e-5")
    del xg, y, z, want, W

    # ---- phase 29: the odd DCT/DST types at (4096, 1024): shifted DFTs
    # of length 2047 = 23*89 and 2049 = 3*683, so Bluestein around K1
    xo = real((4096, 1024), torch.float32, seed=96)
    for name, fwd, inv in (("dct", ct.dct, ct.idct), ("dst", ct.dst, ct.idst)):
        for t in (5, 6, 7, 8):
            print(f"phase 29: {name}/i{name} type {t} n=1024 batch=4096 f32 "
                  f"ortho")
            y, got = drive(lambda: fwd(xo, t, norm="ortho"), total)
            check(got["K1"] > 0 and got["K7"] + got["K8"] + got["K9"] == 0,
                  f"K1 launched through Bluestein, no K7/K8/K9 ({got})")
            e_o = rel_err(y, fwd(xo.double(), t, norm="ortho"))
            check(tuple(y.shape) == (4096, 1024)
                  and bool(torch.isfinite(y).all()), "output shape and finite")
            check(e_o < 1e-4, f"vs the float64 run {e_o:.2e} < 1e-4")
            z, got = drive(lambda: inv(y, t, norm="ortho"), total)
            check(got["K1"] > 0, f"K1 launched by the inverse ({got})")
            e_r = rel_err(z, xo)
            check(e_r < 1e-4, f"i{name}({name}(x)) vs x {e_r:.2e} < 1e-4")
    del y, z

    # ---- phase 30: circular_convolve of two real (4096, 1024) tensors
    print("phase 30: circular_convolve n=1024 batch=4096 f32")
    xb2 = real((4096, 1024), torch.float32, seed=97)
    c, got = drive(lambda: ct.circular_convolve(xo, xb2), total)
    check(got["K1"] > 0, f"K1 launched by circular_convolve ({got})")
    want = torch.fft.irfft(torch.fft.rfft(xo.double())
                           * torch.fft.rfft(xb2.double()), n=1024)
    e_o = rel_err(c, want)
    check(c.dtype == torch.float32 and tuple(c.shape) == (4096, 1024)
          and bool(torch.isfinite(c).all()), "output dtype, shape, finite")
    check(e_o < 1e-5, f"vs torch.fft {e_o:.2e} < 1e-5")
    f8 = ct.fftfreq(8)
    check(f8.is_cuda and f8.dtype == torch.float64 and np.array_equal(
        f8.cpu().numpy(), np.fft.fftfreq(8)), "fftfreq lands on the card")
    check(torch.equal(ct.ifftshift(ct.fftshift(c, axes=-1), axes=-1), c),
          "ifftshift(fftshift(x)) is x")
    del c, want, xb2, xo

    # ---- phases 31-33: the f64 *_hp surface, the compat plans and the
    # Monte-Carlo, QMC and short-rate models
    phase_f64_surface(total, card)
    phase_compat(total, card)
    phase_models(total, card)

    # ---- phase 34: the parallel layer on a one-rank NCCL group
    phase_parallel(total, card)

    # ---- phase 36: gradients, each kernel's backward and the full-width
    # paths forward and backward
    grad_records = phase_grad(total, card)

    # ---- phase 37: gradients through the parallel layer
    phase_parallel_grad(total, card)

    # ---- phase 38: the pricing and sharded demos and the validation
    # table
    phase_demos(total, card)

    for k in KERNELS:
        check(total[k] > 0, f"main path launched {k} {total[k]} times")

    # ---- phase 19: times (CUDA-event medians)
    print("phase 19: times")
    xr, xi = pair((4096, 1024), torch.float32, seed=7)
    k1_ms = median_ms(lambda: fused_fft.sfft_fused(xr, xi, 1024, False))
    plain_ms = median_ms(lambda: fused_fft.sfft_plain(xr, xi, 1024, False))
    path_ms = median_ms(lambda: ct.fft_split(xr, xi, norm="ortho"))
    with plain_engine():
        path_plain_ms = median_ms(lambda: ct.fft_split(xr, xi, norm="ortho"))
    xc = torch.complex(xr, xi)
    cufft_ms = median_ms(lambda: torch.fft.fft(xc))
    g = torch.Generator(device=DEV).manual_seed(8)
    pay = torch.rand((80, 16384), generator=g, device=DEV, dtype=torch.float64)
    fr64, fi64 = pair((8193,), torch.float64, seed=9)
    fi64[0] = 0.0
    fi64[-1] = 0.0
    pr_ms = median_ms(lambda: ct.rfilter_split(pay, fr64, fi64))
    with plain_engine():
        pr_plain_ms = median_ms(lambda: ct.rfilter_split(pay, fr64, fi64))
    # the stream kernels at (64, 65536) f32
    n, m = 65536, 512
    sr_, si_ = pair((64, m, 128), torch.float32, seed=12)
    fpr, fpi = pair((1, m, 128), torch.float32, seed=13)
    st_ms, st_plain_ms = {}, {}
    for k, mode in (("K2", "fwd"), ("K3", "fwd_nat"), ("K4", "filter")):
        f = (fpr, fpi) if mode == "filter" else (None, None)
        st_ms[k] = median_ms(lambda: stream_fft._launch(sr_, si_, n, mode, *f))
        st_plain_ms[k] = median_ms(
            lambda: stream_fft.stream_plain(sr_, si_, n, mode, *f))
    xr, xi = pair((64, n), torch.float32, seed=14)
    fs_ms = median_ms(lambda: ct.fft_split(xr, xi, norm="ortho"))
    with no_stream():
        fs_four_ms = median_ms(lambda: ct.fft_split(xr, xi, norm="ortho"))
    xc = torch.complex(xr, xi)
    fs_cufft_ms = median_ms(lambda: torch.fft.fft(xc, norm="ortho"))
    k3_cufft_ms = median_ms(lambda: torch.fft.fft(xc))
    # the K5 route at its two shapes: the kernel (mode split), its plain
    # version, fft_split over it, and the unfused route (plain-torch passes
    # around K2) beside them
    k5_ms, k5_plain_ms, k5_path_ms, k5_before_ms = {}, {}, {}, {}
    for sh, seed in (((8, 1 << 20), 15), ((4, 1 << 21), 16)):
        xs, ys = pair(sh, torch.float32, seed=seed)
        k5_ms[sh] = median_ms(
            lambda: stream_fft._launch(xs, ys, sh[1], "split"), reps=10)
        k5_plain_ms[sh] = median_ms(
            lambda: stream_fft.stream_plain(xs, ys, sh[1], "split"), reps=5,
            warm=1)
        k5_path_ms[sh] = median_ms(lambda: ct.fft_split(xs, ys), reps=10)
        k5_path_ms[sh, "inverse"] = median_ms(lambda: ct.ifft_split(xs, ys),
                                              reps=10)
        k5_before_ms[sh] = median_ms(lambda: k5_before(xs, ys, sh[1]),
                                     reps=10)
        del xs, ys
    split_ms, split4_ms = k5_path_ms[8, 1 << 20], k5_path_ms[4, 1 << 21]
    rf_ms = median_ms(lambda: ct.rfilter_split(x, fr, fi))
    use = core._use_rstream          # the streaming filter's gate off
    core._use_rstream = lambda n, B, dtype, split=False: (
        not split and use(n, B, dtype))
    try:
        rf_half_ms = median_ms(lambda: ct.rfilter_split(x, fr, fi))
    finally:
        core._use_rstream = use
    pay32 = torch.rand((80, 1 << 20), generator=g, device=DEV)
    fr32, fi32 = pair(((1 << 19) + 1,), torch.float32, seed=17)
    fi32[0] = 0.0
    fi32[-1] = 0.0
    rf_pricer_ms = median_ms(lambda: ct.rfilter_split(pay32, fr32, fi32))
    rf_pricer_before_ms = median_ms(
        lambda: k5_filter_before(pay32, fr32, fi32, 1 << 20))
    pricer_ms = median_ms(lambda: price(1 << 20, torch.float32), reps=5,
                          warm=1)
    # K7 and K8 at (64, 65536) f32, and the routes they replace
    n = 65536
    yr, yi = rstream.launch("rfft", n, x)
    rs_args = {"rfft": (x,), "irfft": (yr, yi), "dct2": (x,), "dct3": (x,)}
    rs_ms, rs_plain_ms = {}, {}
    for mode, args in rs_args.items():
        rs_ms[mode] = median_ms(lambda: rstream.launch(mode, n, *args))
        rs_plain_ms[mode] = median_ms(lambda: rstream_plain(mode, n, *args))
    rs_ms["dct4"] = median_ms(lambda: rstream.launch("dct4", n, x))
    rs_plain_ms["dct4"] = median_ms(lambda: rstream_plain("dct4", n, x))
    route_ms = {}
    for name, fn in (("rfft_split", lambda: ct.rfft_split(x)),
                     ("dct type 2", lambda: ct.dct(x, 2)),
                     ("dct type 4", lambda: ct.dct(x, 4))):
        route_ms[name] = median_ms(fn)
        with no_rstream():
            route_ms[name + " half"] = median_ms(fn)
    rfft_cufft_ms = median_ms(lambda: torch.fft.rfft(x, norm="forward"))
    yc = torch.complex(yr, yi)
    irfft_cufft_ms = median_ms(lambda: torch.fft.irfft(yc, n=n))
    del yc
    dct_bench_ms = median_ms(lambda: ct.dct(xb, 2))
    # K6 and K9, and the 2-D routes with and without them
    col_shapes = ((4, 1024, 1024), (64, 1024, 1024), (4, 4096, 1024))
    col_ms, col_plain_ms, col_lib_ms, col_in = {}, {}, {}, {}
    for shape in col_shapes:
        cr, ci = col_in[shape] = pair(shape, torch.float32,
                                      seed=50 + shape[0])
        col_ms[shape] = median_ms(lambda: colfft.scolfft(cr, ci))
        col_plain_ms[shape] = median_ms(
            lambda: colfft.colfft_plain(cr, ci), reps=5, warm=1)
        cc = torch.complex(cr, ci)
        col_lib_ms[shape] = median_ms(lambda: torch.fft.fft(cc, dim=-2))
        del cr, ci, cc
    # K6 at each (lanes, cluster) of the register route (colfft._REG_LANES,
    # colfft._REG_CLUSTER)
    lane_ms = {}
    for shape, configs in COL_LANE_SWEEP:
        cr, ci = pair(shape, torch.float32, seed=55)
        for L, C in configs:
            with col_lanes(shape[1], L, C):
                lane_ms[shape, L, C] = median_ms(
                    lambda: colfft.scolfft(cr, ci))
        del cr, ci
    k9_ms = {t: median_ms(lambda: colfft.scoldct(x2, t)) for t in (2, 3)}
    k9_plain_ms = {
        2: median_ms(lambda: colfft.coldct2_plain(x2, 1024), reps=5, warm=1),
        3: median_ms(lambda: colfft.coldct3_plain(x2, 1024), reps=5, warm=1)}
    # K10 and K11 at 2^22 elements of each length, beside K1 and K3
    # wherever they take the length, and cuFFT
    def rivals(ar, ai, n):
        out = {}
        if fused_fft.fused_eligible(n, torch.float32):
            out["K1 sfft_fused"] = median_ms(
                lambda: fused_fft.sfft_fused(ar, ai, n, False))
        if stream_fft.stream_eligible(n, torch.float32):
            out["K3 sfft_stream"] = median_ms(
                lambda: stream_fft.sfft_stream(ar, ai, n, False))
        return out

    k10_ms, k10_plain_ms, k10_lib_ms, rival_ms = {}, {}, {}, {}
    for n in K10_SIZES:
        b = (1 << 22) // n
        ar, ai = pair((b, n), torch.float32, seed=100)
        k10_ms[n] = median_ms(
            lambda: fourstep_fft.sfft_fourstep(ar, ai, n, False))
        k10_plain_ms[n] = median_ms(
            lambda: fourstep_fft.sfft_fourstep_plain(ar, ai, n, False),
            reps=5, warm=1)
        rival_ms[b, n] = rivals(ar, ai, n)
        ac = torch.complex(ar, ai)
        k10_lib_ms[n] = median_ms(lambda: torch.fft.fft(ac))
        del ar, ai, ac
    k11_shapes = ((2048, 2048), (1024, 4096), (512, 8192), (256, 16384),
                  (128, 32768))
    k11_ms, k11_perm_ms, k11_plain_ms, k11_lib_ms = {}, {}, {}, {}
    for b, n in k11_shapes:
        ar, ai = pair((b, n), torch.float32, seed=101)
        k11_ms[b, n] = median_ms(
            lambda: stream_fft.sfft_mm2(ar, ai, n, False))
        k11_perm_ms[b, n] = median_ms(
            lambda: stream_fft.sfft_mm2_permuted(ar, ai, n, False))
        k11_plain_ms[b, n] = median_ms(
            lambda: stream_fft.sfft_mm2_plain(ar, ai, n, False), reps=5,
            warm=1)
        if (b, n) not in rival_ms:
            rival_ms[b, n] = rivals(ar, ai, n)
        ac = torch.complex(ar, ai)
        k11_lib_ms[b, n] = median_ms(lambda: torch.fft.fft(ac))
        del ar, ai, ac
    # the PyTorch call beside the K5 route's two shapes
    k5_lib_ms = {}
    for b, n in ((8, 1 << 20), (4, 1 << 21)):
        ac = torch.complex(*pair((b, n), torch.float32, seed=102))
        k5_lib_ms[b, n] = median_ms(lambda: torch.fft.fft(ac), reps=10)
        del ac
    two_d = {}

    def route(name, fn, library=None):
        """fn through the column kernels, with them out of the dispatch
        (the moved-axis route), and the PyTorch call beside it."""
        two_d[f"{name} f32 ortho, column route (K6/K9)"] = median_ms(
            fn, reps=15)
        with no_colfft():
            two_d[f"{name} f32 ortho, moved-axis route (no K6/K9)"] = (
                median_ms(fn, reps=15))
        if library is not None:
            two_d[f"{name} ortho, cuFFT through torch.fft"] = median_ms(
                library, reps=15)

    # 4 and 64 images of 1024 x 1024, and smaller images for the crossover
    # with the moved-axis route
    for shape in ((4, 1024, 1024), (64, 1024, 1024), (4, 256, 256),
                  (64, 256, 256), (4, 64, 64)):
        fr2, fi2 = pair(shape, torch.float32, seed=60 + shape[0])
        fc2 = torch.complex(fr2, fi2)
        route(f"fft2_split {shape}",
              lambda: ct.fft2_split(fr2, fi2, norm="ortho"),
              lambda: torch.fft.fft2(fc2, norm="ortho"))
        del fr2, fi2, fc2
    route("rfft2_split (64, 1024, 1024)",
          lambda: ct.rfft2_split(x2, norm="ortho"),
          lambda: torch.fft.rfft2(x2, norm="ortho"))
    route("dctn type 2 (64, 1024, 1024)",
          lambda: ct.dctn(x2, 2, axes=(-2, -1), norm="ortho"))
    route("dctn type 2 (4, 1024, 1024)",
          lambda: ct.dctn(xn, 2, axes=(-2, -1), norm="ortho"))
    rows = [
        ("K1 sfft_fused (4096, 1024) f32", k1_ms),
        ("plain sfft_plain (4096, 1024) f32", plain_ms),
        ("fft_split K1 path (4096, 1024) f32 ortho", path_ms),
        ("fft_split plain path (4096, 1024) f32 ortho", path_plain_ms),
        ("cuFFT torch.fft.fft (4096, 1024) complex64", cufft_ms),
        ("rfilter_split K1 path (80, 16384) f64", pr_ms),
        ("rfilter_split plain path (80, 16384) f64", pr_plain_ms),
        ("K2 fwd (64, 65536) f32", st_ms["K2"]),
        ("plain K2 fwd (64, 65536) f32", st_plain_ms["K2"]),
        ("K3 fwd_nat (64, 65536) f32", st_ms["K3"]),
        ("plain K3 fwd_nat (64, 65536) f32", st_plain_ms["K3"]),
        ("K4 filter (64, 65536) f32", st_ms["K4"]),
        ("plain K4 filter (64, 65536) f32", st_plain_ms["K4"]),
        ("fft_split stream path K3 (64, 65536) f32 ortho", fs_ms),
        ("fft_split four-step path (64, 65536) f32 ortho", fs_four_ms),
        ("cuFFT torch.fft.fft (64, 65536) complex64 ortho", fs_cufft_ms),
        *[(f"K5 split {sh} f32 (the kernel, mode split)", k5_ms[sh])
          for sh in k5_ms],
        *[(f"plain K5 split {sh} f32", k5_plain_ms[sh]) for sh in k5_ms],
        ("fft_split K5 split s=2 (8, 2^20) f32", split_ms),
        ("fft_split K5 split s=4 (4, 2^21) f32", split4_ms),
        *[(f"ifft_split K5 split {sh} f32", k5_path_ms[sh, "inverse"])
          for sh in k5_ms],
        *[(f"unfused K5 route {sh} f32 (torch passes around K2)",
           k5_before_ms[sh]) for sh in k5_ms],
        ("rfilter_split stream path K2+K4 (64, 65536) f32", rf_ms),
        ("rfilter_split half-length path (64, 65536) f32", rf_half_ms),
        ("rfilter_split stream path s=2 (80, 2^20) f32 (two K5 calls)",
         rf_pricer_ms),
        ("rfilter_split (80, 2^20) f32 by the unfused route (K2 and K4, torch "
         "passes)", rf_pricer_before_ms),
        ("conv_option_price 80 strikes n=2^20 f32 (whole call)", pricer_ms),
        *[(f"K7 {md} (64, 65536) f32", rs_ms[md]) for md in rs_args],
        *[(f"plain K7 {md} (64, 65536) f32", rs_plain_ms[md])
          for md in rs_args],
        ("K8 dct4 (64, 65536) f32", rs_ms["dct4"]),
        ("plain K8 dct4 (64, 65536) f32", rs_plain_ms["dct4"]),
        ("rfft_split K7 route (64, 65536) f32", route_ms["rfft_split"]),
        ("rfft_split half-length route K3 (64, 65536) f32",
         route_ms["rfft_split half"]),
        ("cuFFT torch.fft.rfft (64, 65536) f32", rfft_cufft_ms),
        ("dct type 2 K7 route (64, 65536) f32", route_ms["dct type 2"]),
        ("dct type 2 half-length route K3 (64, 65536) f32",
         route_ms["dct type 2 half"]),
        ("dct type 4 K8 route (64, 65536) f32", route_ms["dct type 4"]),
        ("dct type 4 K3 route (64, 65536) f32", route_ms["dct type 4 half"]),
        ("dct type 2 K1 route (4096, 1024) f32", dct_bench_ms),
        ("cuFFT torch.fft.fft (64, 65536) complex64", k3_cufft_ms),
        ("cuFFT torch.fft.irfft (64, 65536) complex64", irfft_cufft_ms),
        *[(f"K6 scolfft {sh} f32", col_ms[sh]) for sh in col_shapes],
        *[(f"plain K6 colfft_plain {sh} f32", col_plain_ms[sh])
          for sh in col_shapes],
        *[(f"cuFFT torch.fft.fft dim=-2 {sh} complex64", col_lib_ms[sh])
          for sh in col_shapes],
        *[(f"K6 scolfft {sh} f32 at {L} lanes a block, {C} a cluster (the "
           f"rule takes {colfft._route(sh[1], sh[2])[1]}, "
           f"{colfft._REG_CLUSTER[sh[1]]})", ms)
          for (sh, L, C), ms in lane_ms.items()],
        *[(f"K9 dct{t} (64, 1024, 1024) f32", k9_ms[t]) for t in (2, 3)],
        *[(f"plain K9 dct{t} (64, 1024, 1024) f32", k9_plain_ms[t])
          for t in (2, 3)],
        *[(f"K10 sfft_fourstep ({(1 << 22) // n}, {n}) f32", k10_ms[n])
          for n in K10_SIZES],
        *[(f"plain K10 sfft_fourstep_plain ({(1 << 22) // n}, {n}) f32",
           k10_plain_ms[n]) for n in K10_SIZES],
        *[(f"{name} {sh} f32", ms) for sh, got in sorted(rival_ms.items())
          for name, ms in got.items()],
        *[(f"cuFFT torch.fft.fft ({(1 << 22) // n}, {n}) complex64",
           k10_lib_ms[n]) for n in K10_SIZES],
        *[(f"K11 sfft_mm2 {sh} f32", k11_ms[sh]) for sh in k11_shapes],
        *[(f"K11 sfft_mm2_permuted {sh} f32", k11_perm_ms[sh])
          for sh in k11_shapes],
        *[(f"plain K11 sfft_mm2_plain {sh} f32", k11_plain_ms[sh])
          for sh in k11_shapes],
        *[(f"cuFFT torch.fft.fft {sh} complex64", k11_lib_ms[sh])
          for sh in k11_shapes],
        *[(f"cuFFT torch.fft.fft {sh} complex64 (the K5 route's shape)",
           k5_lib_ms[sh]) for sh in k5_lib_ms],
    ]
    rows.extend(two_d.items())
    for name, ms in rows:
        print(f"  time {name}: {ms:.4f} ms  [{card}]")
    # host time a call of the redesigned kernels and their routes
    xr, xi = pair((4096, 1024), torch.float32, seed=7)
    xs, ys = pair((8, 1 << 20), torch.float32, seed=15)
    x3r, x3i = pair((64, 65536), torch.float32, seed=14)
    yr, yi = rstream.launch("rfft", 65536, x)
    for name, fn in (
            ("K1 sfft_fused (4096, 1024)",
             lambda: fused_fft.sfft_fused(xr, xi, 1024, False)),
            *[(f"K6 scolfft {sh}", lambda sh=sh: colfft.scolfft(*col_in[sh]))
              for sh in col_shapes],
            *[(f"K9 scoldct dct{t} (64, 1024, 1024)",
               lambda t=t: colfft.scoldct(x2, t)) for t in (2, 3)],
            ("fft_split ortho (4096, 1024)",
             lambda: ct.fft_split(xr, xi, norm="ortho")),
            ("K5 stream_fft._launch split (8, 2^20)",
             lambda: stream_fft._launch(xs, ys, 1 << 20, "split")),
            ("fft_split (8, 2^20)", lambda: ct.fft_split(xs, ys)),
            ("K3 sfft_stream (64, 65536)",
             lambda: stream_fft.sfft_stream(x3r, x3i, 65536, False)),
            ("fft_split ortho (64, 65536)",
             lambda: ct.fft_split(x3r, x3i, norm="ortho")),
            ("K7 rstream.launch rfft (64, 65536)",
             lambda: rstream.launch("rfft", 65536, x)),
            ("K7 rstream.launch irfft (64, 65536)",
             lambda: rstream.launch("irfft", 65536, yr, yi)),
            ("rfft_split (64, 65536)", lambda: ct.rfft_split(x)),
            ("irfft_split (64, 65536)",
             lambda: ct.irfft_split(yr, yi, 65536))):
        print(f"  host time a call, {name}: {host_us(fn):.1f} us  [{card}]")
    del xs, ys, x3r, x3i
    # the dense forms by event time (host time included; phase 25b has
    # the device times): K11's two products, and K10's pass A within the
    # whole of K10
    for sh in k11_shapes:
        fl = mm2_dense_flops(*sh)
        print(f"  K11 dense form {sh}: {fl / 1e9:.3f} GFLOP, "
              f"{fl / X3_FLOP_S * 1e3:.4f} ms at the 3xTF32 yardstick, "
              f"{fl / F32_FLOP_S * 1e3:.4f} ms at the float32 peak; kernel "
              f"at {dense_rate(fl, k11_ms[sh] * 1e3)}; the function's "
              f"{fft_flops(*sh) / 1e9:.3f} GFLOP  [{card}]")
    for n in K10_SIZES:
        fl = pass_a_flops((1 << 22) // n, n)
        print(f"  K10 pass A ({(1 << 22) // n}, {n}): {fl / 1e9:.3f} GFLOP, "
              f"{fl / X3_FLOP_S * 1e3:.4f} ms at the 3xTF32 yardstick, "
              f"{fl / F32_FLOP_S * 1e3:.4f} ms at the float32 peak; both "
              f"passes at {dense_rate(fl, k10_ms[n] * 1e3)}  [{card}]")

    # ---- phase 25: where the 2-D routes' time goes (torch.profiler)
    print("phase 25: profile of the 2-D routes at (64, 1024, 1024) f32")
    fr2, fi2 = pair((64, 1024, 1024), torch.float32, seed=70)
    for name, fn in (
            ("fft2_split", lambda: ct.fft2_split(fr2, fi2, norm="ortho")),
            ("rfft2_split", lambda: ct.rfft2_split(x2, norm="ortho")),
            ("dctn type 2", lambda: ct.dctn(x2, 2, axes=(-2, -1),
                                            norm="ortho"))):
        profile_route(f"{name} column route", fn, card)
        with no_colfft():
            profile_route(f"{name} moved-axis route", fn, card)
    del fr2, fi2
    # K6 and K9 alone, by device time: one kernel row a call, the
    # register kernel at n0 = 1024 and 4096
    for sh in col_shapes:
        got = profile_route(f"K6 scolfft {sh}",
                            lambda: colfft.scolfft(*col_in[sh]), card)
        check(got["launches"] == 1
              and all("cf_reg_kernel" in k for k in got["rows"]),
              f"K6 {sh} is one register-kernel row a call "
              f"({got['launches']:g}: {sorted(got['rows'])})")
    for t in (2, 3):
        got = profile_route(f"K9 scoldct dct{t} (64, 1024, 1024)",
                            lambda: colfft.scoldct(x2, t), card)
        check(got["launches"] == 1
              and all("cf_reg_kernel" in k for k in got["rows"]),
              f"K9 dct{t} is one register-kernel row a call "
              f"({got['launches']:g}: {sorted(got['rows'])})")
    del col_in
    # the lane sweep of phase 19 by device time
    for shape, configs in COL_LANE_SWEEP:
        cr, ci = pair(shape, torch.float32, seed=55)
        rule = colfft._route(*shape[1:])[1], colfft._REG_CLUSTER[shape[1]]
        for L, C in configs:
            with col_lanes(shape[1], L, C):
                at = (f"{shape} at {L} lanes a block, {C} a cluster (the rule "
                      f"takes {rule[0]}, {rule[1]})")
                profile_route(f"K6 scolfft {at}",
                              lambda: colfft.scolfft(cr, ci), card)
                if shape[1] == 1024 and C == 1:
                    for t in (2, 3):
                        profile_route(f"K9 scoldct dct{t} {at}",
                                      lambda: colfft.scoldct(cr, t), card)
        del cr, ci

    # ---- phase 25b: device time of K10's and K11's passes, and of K1
    # and K3 at the same shapes; the dense products' rates by device time
    print("phase 25b: profile of K10, K11, K1 and K3 at 2^22 elements "
          "(device time of each pass)")
    for b, n in sorted(rival_ms):
        ar, ai = pair((b, n), torch.float32, seed=103)
        for name, fn, takes in (
                ("K10 sfft_fourstep", fourstep_fft.sfft_fourstep,
                 fourstep_fft.fourstep_eligible),
                ("K11 sfft_mm2", stream_fft.sfft_mm2, stream_fft.mm2_eligible),
                ("K1 sfft_fused", fused_fft.sfft_fused,
                 fused_fft.fused_eligible),
                ("K3 sfft_stream", stream_fft.sfft_stream,
                 stream_fft.stream_eligible)):
            if not takes(n, torch.float32):
                continue
            got = profile_route(f"{name} ({b}, {n})",
                                lambda: fn(ar, ai, n, False), card)
            if name.startswith("K10"):
                us = sum(t for k, t in got["rows"].items() if "dft64" in k)
                print(f"    K10 pass A alone, {us:.1f} us: "
                      f"{dense_rate(pass_a_flops(b, n), us)}  [{card}]")
            elif name.startswith("K11"):
                passes = ("one pass" if stream_fft._mm2_one_pass(n // 128)
                          else "two passes through scratch")
                check(len(got["rows"]) == 1, f"K11 at n={n} is one kernel "
                      f"name ({passes}: {sorted(got['rows'])})")
                print(f"    K11 dense form, {got['kernel_us']:.1f} us in "
                      f"{passes}: "
                      f"{dense_rate(mm2_dense_flops(b, n), got['kernel_us'])}"
                      f"  [{card}]")
        del ar, ai

    # ---- phase 25c: K1 and the K5 route by device time, with their
    # kernel rows a call, and the measurements behind K1's rows a block
    # (fused_fft._reg_tile_rows)
    print("phase 25c: profile of K1 and the K5 route")
    xr, xi = pair((4096, 1024), torch.float32, seed=104)
    got = profile_route("fft_split norm=ortho (4096, 1024)",
                        lambda: ct.fft_split(xr, xi, norm="ortho"), card)
    check(got["launches"] == 1
          and all(k.startswith("void k1_reg_kernel") for k in got["rows"]),
          f"fft_split ortho is one K1 row a call, the scale in its store "
          f"({got['launches']:g}: {sorted(got['rows'])})")
    for sh in ((8, 1 << 20), (4, 1 << 21)):
        xs, ys = pair(sh, torch.float32, seed=105)
        for name, fn in (("fft_split", ct.fft_split),
                         ("ifft_split", ct.ifft_split)):
            for norm in ("ortho", "backward"):
                got = profile_route(f"{name} norm={norm} {sh} (K5)",
                                    lambda: fn(xs, ys, norm=norm), card)
                check(got["launches"] == 2
                      and all("sf_split" in k for k in got["rows"]),
                      f"{name} {sh} is two K5 rows a call "
                      f"({got['launches']:g}: {sorted(got['rows'])})")
        profile_route(f"unfused K5 route {sh} (torch passes around K2)",
                      lambda: k5_before(xs, ys, sh[1]), card)
        del xs, ys
    got = profile_route("rfilter_split (80, 2^20) f32 (two K5 calls)",
                        lambda: ct.rfilter_split(pay32, fr32, fi32), card)
    check(sum(v for k, v in got["rows"].items() if "sf_split" in k)
          >= 0.9 * got["kernel_us"], "the K5 passes take 90% of the filter's "
          "kernel time (the rest is the O(n) filter extension)")
    profile_route("rfilter_split (80, 2^20) f32 by the unfused route",
                  lambda: k5_filter_before(pay32, fr32, fi32, 1 << 20), card)
    for dt in (torch.float32, torch.float64):
        for n in (480, 512, 960, 1024, 2048, 4096, 8192):
            if n not in plan.REG_LENGTHS[dt]:
                continue
            b = (1 << 22) // n
            xr, xi = pair((b, n), dt, seed=106)
            tpr = fused_fft._reg_threads_per_row(n)
            rule = fused_fft._reg_tile_rows(n, dt)
            for tb in (1, 2, 4):
                if tb * tpr > fused_fft._REG_MAX_THREADS[dt]:
                    continue
                with k1_rows(tb):
                    profile_route(f"K1 {dt} ({b}, {n}) at {tb} rows a block "
                                  f"(the rule takes {rule})",
                                  lambda: fused_fft.sfft_fused(xr, xi, n,
                                                               False), card)
    del xr, xi

    # K3 and K7 by device time, with their kernel rows a call: one row on
    # the cluster route (the scale in its store), two on the register
    # route; then the cluster size swept at m = 512
    print("phase 25c: profile of K3 and K7")
    for n in (16384, 32768, 65536, 131072, 262144):
        b = (1 << 22) // n
        route = stream_fft._k3_route(n // 128)
        xr, xi = pair((b, n), torch.float32, seed=107)
        for inv in (False, True):
            got = profile_route(
                f"K3 sfft_stream ({b}, {n}) inverse={inv} scale=0.5 "
                f"route={route}",
                lambda: stream_fft.sfft_stream(xr, xi, n, inv, 0.5), card)
            rows = 1 if route[0] == "cluster" else 2
            check(got["launches"] == rows,
                  f"K3 at n={n} is {rows} kernel row(s) a call "
                  f"({got['launches']:g}: {sorted(got['rows'])})")
        del xr, xi
    xr, xi = pair((64, 65536), torch.float32, seed=108)
    for name, fn in (("fft_split", ct.fft_split),
                     ("ifft_split", ct.ifft_split)):
        for norm in ("ortho", "backward"):
            got = profile_route(f"{name} norm={norm} (64, 65536) (K3)",
                                lambda: fn(xr, xi, norm=norm), card)
            check(got["launches"] == 1
                  and all("cl_nat_kernel" in k for k in got["rows"]),
                  f"{name} norm={norm} is one K3 row a call "
                  f"({got['launches']:g}: {sorted(got['rows'])})")
    yr, yi = rstream.launch("rfft", 65536, x)
    for mode, args in (("rfft", (x,)), ("irfft", (yr, yi)), ("dct2", (x,)),
                       ("dct3", (x,))):
        got = profile_route(f"K7 {mode} (64, 65536)",
                            lambda: rstream.launch(mode, 65536, *args), card)
        check(got["launches"] == 1
              and all("cl_rs_kernel" in k for k in got["rows"]),
              f"K7 {mode} is one cluster row a call ({got['launches']:g}: "
              f"{sorted(got['rows'])})")
    for name, fn in (("rfft_split", lambda norm: ct.rfft_split(x, norm=norm)),
                     ("irfft_split",
                      lambda norm: ct.irfft_split(yr, yi, 65536, norm=norm)),
                     ("dct type 2", lambda norm: ct.dct(x, 2, norm=norm)),
                     ("idct type 2", lambda norm: ct.idct(x, 2, norm=norm))):
        for norm in ("ortho", "forward", "backward"):
            got = profile_route(f"{name} norm={norm} (64, 65536) (K7)",
                                lambda: fn(norm), card)
            check(got["launches"] == 1
                  and all("cl_rs_kernel" in k for k in got["rows"]),
                  f"{name} norm={norm} is one K7 row a call "
                  f"({got['launches']:g}: {sorted(got['rows'])})")
    # K2, K4 and K8 by device time at (64, 65536) f32: one cluster row a
    # call each (K2's forward columns first, its inverse and K4 rows
    # first); K2's forward at m = 2048 and 4096 K5's two register
    # kernels; dct/dst type 4 one K8 row under every norm, and
    # rfilter_split one K2 row and one K4 row, 9 rows in all
    sr_, si_ = pair((64, 512, 128), torch.float32, seed=109)
    fpr_, fpi_ = pair((1, 512, 128), torch.float32, seed=110)
    dev_us = {}
    for k, label, fn, names in (
            ("K2", "K2 fwd (64, 512, 128) (cluster)",
             lambda: stream_fft._launch(sr_, si_, 65536, "fwd"),
             ("cl_perm_kernel<512>",)),
            ("K2 inv", "K2 inv (64, 512, 128) (rows-first cluster)",
             lambda: stream_fft._launch(sr_, si_, 65536, "inv"),
             ("cl_rf_kernel<512, false>",)),
            ("K4", "K4 filter (64, 512, 128) s=1 (rows-first cluster)",
             lambda: stream_fft._launch(sr_, si_, 65536, "filter", fpr_,
                                        fpi_), ("cl_rf_kernel<512, true>",)),
            ("K8", "K8 dct4 (64, 65536) (cluster)",
             lambda: rstream.launch("dct4", 65536, x),
             ("cl_rs_kernel<256, 4>",))):
        got = profile_route(label, fn, card)
        check(got["launches"] == len(names)
              and all(any(nm in r for nm in names) for r in got["rows"]),
              f"{k} is {len(names)} kernel row(s) a call "
              f"({got['launches']:g}: {sorted(got['rows'])})")
        dev_us[k] = got["kernel_us"]
    for m in (2048, 4096):
        n, b = 128 * m, (1 << 22) // (128 * m)
        ar, ai = pair((b, m, 128), torch.float32, seed=113)
        for mode, kern in (("fwd", "K2"), ("fwd_nat", "K3")):
            got = profile_route(f"{kern} {mode} ({b}, {m}, 128) (register "
                                f"route)", lambda: stream_fft._launch(
                                    ar, ai, n, mode), card)
            names = (f"sf_split_col_reg_kernel<1, {m}>",
                     f"sf_split_row_kernel<1, {str(kern == 'K2').lower()}>")
            check(got["launches"] == 2
                  and all(any(nm in r for nm in names) for r in got["rows"]),
                  f"{kern} {mode} at m={m} is K5's two register kernels a "
                  f"call ({got['launches']:g}: {sorted(got['rows'])})")
        del ar, ai
    for name, fn in (("dct", ct.dct), ("dst", ct.dst)):
        for norm in ("ortho", "forward", "backward"):
            got = profile_route(f"{name} type 4 norm={norm} (64, 65536) (K8)",
                                lambda: fn(x, 4, norm=norm), card)
            check(got["launches"] == 1
                  and all("cl_rs_kernel<256, 4>" in k for k in got["rows"]),
                  f"{name} type 4 norm={norm} is one K8 row a call "
                  f"({got['launches']:g}: {sorted(got['rows'])})")
    got = profile_route("rfilter_split (64, 65536) (K2 and K4)",
                        lambda: ct.rfilter_split(x, fr, fi), card)
    k24 = {nm: sum(c for r, c in got["count"].items() if nm in r)
           for nm in ("cl_perm_kernel<512>", "cl_rf_kernel<512, true>",
                      "sf_col_kernel", "sf_row_kernel")}
    check(k24 == {"cl_perm_kernel<512>": 1, "cl_rf_kernel<512, true>": 1,
                  "sf_col_kernel": 0, "sf_row_kernel": 0}
          and got["launches"] == 9,
          f"rfilter_split is one K2 row and one K4 row a call, 9 kernel "
          f"rows in all ({got['launches']:g}: {k24})")
    print(f"  device us a call at (64, 65536): K2 fwd {dev_us['K2']:.1f}, "
          f"K2 inv {dev_us['K2 inv']:.1f}, K4 {dev_us['K4']:.1f}, K8 "
          f"{dev_us['K8']:.1f}  [{card}]")
    # K2's cluster size both ways (the forward at K3's rule,
    # stream_fft._cluster_size, the inverse at K4's,
    # _filter_cluster_size), 2^22 elements
    prule = stream_fft._cluster_size
    frule = stream_fft._filter_cluster_size
    for m in K2_SWEEP_M:
        n, b = 128 * m, (1 << 22) // (128 * m)
        ar, ai = pair((b, m, 128), torch.float32, seed=114)
        for mode, rule in (("fwd", prule), ("inv", frule)):
            for C in K4_C_SWEEP:
                if 8 * m // C > 1024:
                    continue
                stream_fft._cluster_size = lambda mm, C=C: C
                stream_fft._filter_cluster_size = lambda mm, C=C: C
                try:
                    profile_route(f"K2 {mode} ({b}, {m}, 128) at C={C} (the "
                                  f"rule takes {rule(m)})",
                                  lambda: stream_fft._launch(ar, ai, n, mode),
                                  card)
                finally:
                    stream_fft._cluster_size = prule
                    stream_fft._filter_cluster_size = frule
        del ar, ai
    del sr_, si_
    rule = stream_fft._cluster_size
    for C in C_SWEEP:
        stream_fft._cluster_size = lambda m, C=C: C
        plan._LAUNCH_PLANS.clear()
        try:
            profile_route(f"K3 sfft_stream (64, 65536) at C={C} (the rule "
                          f"takes {rule(512)})",
                          lambda: stream_fft.sfft_stream(xr, xi, 65536,
                                                         False), card)
            for mode, args in (("rfft", (x,)), ("dct3", (x,))):
                profile_route(f"K7 {mode} (64, 65536) at C={C}",
                              lambda: rstream.launch(mode, 65536, *args),
                              card)
            profile_route(f"K8 dct4 (64, 65536) at C={C} (the rule takes "
                          f"{rule(256)})",
                          lambda: rstream.launch("dct4", 65536, x), card)
        finally:
            stream_fft._cluster_size = rule
            plan._LAUNCH_PLANS.clear()
    del xr, xi
    # K4's cluster size at each m it takes, 2^22 elements
    # (stream_fft._filter_cluster_size)
    frule = stream_fft._filter_cluster_size
    for m in stream_fft._CLUSTER_M:
        n, b = 128 * m, (1 << 22) // (128 * m)
        ar, ai = pair((b, m, 128), torch.float32, seed=111)
        gr, gi = pair((1, m, 128), torch.float32, seed=112)
        for C in K4_C_SWEEP:
            if 8 * m // C > 1024:
                continue
            stream_fft._filter_cluster_size = lambda mm, C=C: C
            try:
                profile_route(f"K4 filter ({b}, {m}, 128) at C={C} (the rule "
                              f"takes {frule(m)})",
                              lambda: stream_fft._launch(ar, ai, n, "filter",
                                                         gr, gi), card)
            finally:
                stream_fft._filter_cluster_size = frule
        del ar, ai

    # ---- phase 35: the four small utils (after phase 25: a profiler
    # session before it makes its traces lose kernel rows)
    phase_utils(card)

    # ---- phase 39: K1's interleaved complex mode under fft/ifft (after
    # phase 25 too: it profiles)
    phase_cplx_k1(total, card)

    # ---- phase 40: the step's filter map (after phase 25: it profiles)
    phase_cmul(total, card)

    # each kernel's bound at the shape its times were taken at: every
    # input read once and every output written once (the data planes; the
    # twiddle and phase tables are under 1% of them) and 5 n log2 n
    # flops a complex transform
    big = 64 * 65536
    stream_bound = bound_ms(16 * big, fft_flops(64, 65536))
    col_big = (64, 1024, 1024)
    src = "cfftpack_tpu_torch/csrc/stream_fft.cu"

    def entry_of(name, source, replaces, k, err, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": total[k],
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library}

    k5_at = (8, 1 << 20)
    kernels = [entry_of(
        "stream_fft split (K5), times of the forward", src,
        "cfftpack_tpu/ops/pallas_stream.py:583", "K5", k5_err, k5_ms[k5_at],
        k5_plain_ms[k5_at], bound_ms(16 * k5_at[0] * k5_at[1],
                                     fft_flops(*k5_at)), k5_lib_ms[k5_at])]
    kernels += [entry_of(
        "stockham_fft (K1)", "cfftpack_tpu_torch/csrc/stockham_fft.cu",
        "cfftpack_tpu/ops/pallas_fft.py:90", "K1", kern_err, k1_ms, plain_ms,
        bound_ms(16 * 4096 * 1024, fft_flops(4096, 1024)), cufft_ms)]
    for k, name, line in (("K2", "stream_fft fwd/inv (K2): fwd one pass on "
                           "a thread-block cluster (csrc/cluster_pass.cuh) "
                           "at m = 128 .. 1024 and K5's two register "
                           "kernels at 2048, 4096, inv one pass rows first "
                           "at m = 128 .. 1024, times of fwd", 352),
                          ("K3", "stream_nat (K3): one pass on a thread-block "
                           "cluster (csrc/cluster_pass.cuh) at m = 128 .. "
                           "1024, times of fwd_nat", 386),
                          ("K4", "stream_fft filter (K4): one pass on a "
                           "thread-block cluster in the rows-first order at "
                           "m = 128 .. 1024, times at s = 1", 444)):
        # K4 also reads its (1, m, 128) filter slice once
        bound = (bound_ms(16 * big + 8 * 65536, fft_flops(64, 65536))
                 if k == "K4" else stream_bound)
        kernels.append(entry_of(
            name, src, f"cfftpack_tpu/ops/pallas_stream.py:{line}", k,
            stream_err[k], st_ms[k], st_plain_ms[k], bound,
            k3_cufft_ms if k == "K3" else None))
    src = "cfftpack_tpu_torch/csrc/rstream_fft.cu"
    # K7 pairs rows: 32 complex transforms of 65536; K8 runs 64 of 32768
    for k, name, replaces, mode, bound, library in (
            ("K7", "rstream_fft rfft/irfft/dct2/dct3 (K7): one pass on a "
             "thread-block cluster at m = 128 .. 1024, times of rfft",
             "cfftpack_tpu/ops/pallas_rstream.py:157", "rfft",
             bound_ms(4 * big + 8 * 64 * 32769, fft_flops(32, 65536)),
             rfft_cufft_ms),
            ("K8", "rstream_fft dct4/dst4 (K8): one pass on a thread-block "
             "cluster at m = 128 .. 1024, times of dct4",
             "cfftpack_tpu/ops/dct.py:285",
             "dct4", bound_ms(8 * big, fft_flops(64, 32768)), None)):
        kernels.append(entry_of(name, src, replaces, k, rs_err[k],
                                rs_ms[mode], rs_plain_ms[mode], bound,
                                library))
    src = "cfftpack_tpu_torch/csrc/col_fft.cu"
    cols = 64 * 1024                    # columns of (64, 1024, 1024)
    kernels.append(entry_of(
        "col_fft fwd/inv (K6)", src, "cfftpack_tpu/ops/pallas_colfft.py:122",
        "K6", col_err["K6"], col_ms[col_big], col_plain_ms[col_big],
        bound_ms(16 * cols * 1024, fft_flops(cols, 1024)),
        col_lib_ms[col_big]))
    kernels.append(entry_of(
        "col_fft dct2/dct3 (K9), times of dct2", src,
        "cfftpack_tpu/ops/dct.py:569", "K9", col_err["K9"], k9_ms[2],
        k9_plain_ms[2], bound_ms(8 * cols * 1024, fft_flops(cols // 2, 1024)),
        None))
    kernels.append(entry_of(
        "fourstep_fft (K10)", "cfftpack_tpu_torch/csrc/fourstep_fft.cu",
        "cfftpack_tpu/ops/pallas_fourstep.py:225", "K10", dense_err["K10"],
        k10_ms[65536], k10_plain_ms[65536], stream_bound, k10_lib_ms[65536]))
    k11_at = (128, 32768)
    kernels.append(entry_of(
        "mm2_fft natural/permuted (K11), times of natural forward",
        "cfftpack_tpu_torch/csrc/mm2_fft.cu",
        "cfftpack_tpu/ops/pallas_stream.py:762", "K11", dense_err["K11"],
        k11_ms[k11_at], k11_plain_ms[k11_at],
        bound_ms(16 * k11_at[0] * k11_at[1], fft_flops(*k11_at)),
        k11_lib_ms[k11_at]))
    kernels.sort(key=lambda e: int(e["name"].split("(K")[1].split(")")[0]))
    for e in kernels:
        print(f"  bound {e['name']}: {e['bound_ms']:.4f} ms by "
              f"{e['bound_by']}, kernel {e['ms']:.4f} ms "
              f"({e['bound_ms'] / e['ms']:.2f} of the bound's rate)  [{card}]")
    print(json.dumps({"grad": grad_records}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
