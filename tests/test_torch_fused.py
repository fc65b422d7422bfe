"""K1's plain version against the Pallas kernel it replaces.

``cfftpack_tpu.ops.pallas_fft.sfft_pallas`` runs in interpret mode on
the CPU, as tests/test_pallas.py runs it; the port's ``sfft_fused``
takes the plain PyTorch version on CPU tensors.  The CUDA kernel
itself is checked on the card (``-m cuda`` here, and chip_smoke.py).
"""
import math
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cfftpack_tpu import plan as jplan
from cfftpack_tpu.ops.core import _stockham
from cfftpack_tpu.ops.pallas_fft import sfft_pallas

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.config import fwd_scale
from cfftpack_tpu_torch.ops import _build, cfft, core, fused_fft
from cfftpack_tpu_torch.utils import profiling

from torch_parity import bar, complex_input, rel_err, to_np

torch.set_num_threads(1)

SIZES = [4, 8, 60, 64, 243, 899, 960, 1024]


def _reference(xr, xi, n: int, inverse: bool):
    """The Pallas kernel in interpret mode.  At lengths with a dense
    radix (7..31, e.g. 899 = 29*31) its trace fails under the installed
    JAX (the kernel closes over the DFT matrices, and pallas_call
    refuses captured constants), so there the XLA Stockham engine that
    shares the kernel's ``_butterfly`` and tables stands in."""
    if max(jplan.factor(n)) > 5:
        return _stockham(jnp.asarray(xr), jnp.asarray(xi), n, inverse)
    return sfft_pallas(jnp.asarray(xr), jnp.asarray(xi), n, inverse)


@pytest.mark.parametrize("batch", [5, 7])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_pallas_kernel(n, inverse, batch):
    x = complex_input((batch, n), np.complex64, seed=n + batch)
    xr, xi = x.real.copy(), x.imag.copy()
    wr, wi = _reference(xr, xi, n, inverse)
    yr, yi = fused_fft.sfft_fused(torch.as_tensor(xr), torch.as_tensor(xi),
                                  n, inverse)
    assert yr.shape == (batch, n) and yr.dtype == torch.float32
    err = rel_err(to_np(yr) + 1j * to_np(yi),
                  np.asarray(wr) + 1j * np.asarray(wi))
    assert err < bar(np.float32), err      # f32 bar: 1e-4 of max |X|


def test_eligibility():
    assert fused_fft.fused_eligible(1024, torch.float32)
    assert fused_fft.fused_eligible(960, torch.float64)
    assert fused_fft.fused_eligible(899, torch.float32)     # dense radix
    assert fused_fft.fused_eligible(8192, torch.float32)
    assert not fused_fft.fused_eligible(8192, torch.float64)  # four-step
    assert not fused_fft.fused_eligible(16384, torch.float32)
    assert not fused_fft.fused_eligible(101, torch.float32)   # Bluestein
    assert not fused_fft.fused_eligible(1, torch.float32)
    assert not fused_fft.fused_eligible(64, torch.float16)


def test_tile_rows_fit_the_budget():
    for n in (2, 960, 1024, 4096, 8192):
        for dt in (torch.float32, torch.float64):
            if fused_fft.fused_eligible(n, dt):
                t = fused_fft._tile_rows(n, dt)
                size = dt.itemsize
                assert t >= 1 and 4 * t * n * size <= fused_fft._SMEM_BUDGET


def test_cpu_tensors_never_launch():
    before = profiling.launches["K1"]
    x = complex_input((3, 960), np.complex128, seed=1)
    fused_fft.sfft_fused(torch.as_tensor(x.real.copy()),
                         torch.as_tensor(x.imag.copy()), 960, False)
    assert profiling.launches["K1"] == before == 0


def test_non_cpu_tensor_takes_the_kernel_or_raises():
    """Off the CPU there is no plain fallback: a tensor that is not on
    a CUDA device is refused by the kernel's wrapper."""
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_fft.sfft_fused(x, x, 64, False)
    assert profiling.launches["K1"] == 0


# ------------------------------------------------- the register passes

def _dft_in_registers(v, q, sgn):
    """One butterfly's R-point DFT as csrc/regfft.cuh:rf_dft runs it: the
    sub-radices q outer to inner, digit i transformed in place, each
    output k times the constant W_{q_i*S_i}^{k*lo}; returns the registers
    (register t holds output out(t))."""
    v = v.copy()
    R = v.shape[-1]
    for i, qi in enumerate(q):
        S = math.prod(q[i + 1:])
        for hi in range(R // (qi * S)):
            for lo in range(S):
                idx = [hi * qi * S + d * S + lo for d in range(qi)]
                D = np.exp(sgn * 2j * np.pi
                           * np.outer(range(qi), range(qi)) / qi)
                w = np.exp(sgn * 2j * np.pi * np.arange(qi) * lo / (qi * S))
                v[..., idx] = (v[..., idx] @ D.T) * w
    return v


def _register_out(q, t):
    """rf_pass's output index of register t: the digits reversed."""
    u, h = 0, 1
    for i, qi in enumerate(q):
        u += (t // math.prod(q[i + 1:])) % qi * h
        h *= qi
    return u


def _pass_twiddle(entries, q, u):
    """rf_pass_twiddle: output u's twiddle as the product of the table
    entries of its nonzero digits (digit i at place q_1*...*q_{i-1},
    entries of digit i from sum_{k<i} (q_k - 1))."""
    w, first = 1.0, 0
    for i, qi in enumerate(q):
        d = u // math.prod(q[:i]) % qi
        if d:
            w = w * entries[first + d - 1]
        first += qi - 1
    return w


def _apply_register_passes(x, n, inverse):
    """The register kernel's schedule applied with numpy: each pass's
    gathers, in-register DFT, digit-entry twiddles and scatters, for
    every butterfly (l, j)."""
    sgn = 1.0 if inverse else -1.0
    tw = plan.reg_twiddles(n)
    tw = tw[:, 0] + 1j * tw[:, 1]
    a = x.astype(np.complex128)
    L, off = 1, 0
    for q in plan.reg_passes(n):
        R = math.prod(q)
        nw = sum(qi - 1 for qi in q)
        mn = n // (L * R)
        b = np.empty_like(a)
        for l in range(L):
            for j in range(mn):
                v = _dft_in_registers(a[..., [(l * R + t) * mn + j
                                               for t in range(R)]], q, sgn)
                entries = tw[off + j * nw:off + (j + 1) * nw]
                for t in range(R):
                    u = _register_out(q, t)
                    w = _pass_twiddle(entries, q, u) if mn > 1 else 1.0
                    b[..., (u * L + l) * mn + j] = v[..., t] * (
                        np.conj(w) if inverse else w)
        if mn > 1:
            off += mn * nw
        L *= R
        a = b
    assert off == (len(tw) if off else 0)
    return a


@pytest.mark.parametrize("n", plan.REG_LENGTHS[torch.float32])
def test_register_schedule_matches_numpy_fft(n):
    """The register kernel's passes, index maps and pass twiddles, applied
    with numpy, against numpy.fft at every scheduled length."""
    passes = plan.reg_passes(n)
    assert tuple(p for q in passes for p in q) == plan.factor(n)
    assert all(math.prod(q) <= 16 and set(q) <= {2, 3, 4, 5} for q in passes)
    x = complex_input((2, n), np.complex128, seed=n)
    assert rel_err(_apply_register_passes(x, n, False), np.fft.fft(x)) < 1e-12
    assert rel_err(_apply_register_passes(x, n, True),
                   np.fft.ifft(x) * n) < 1e-12
    # the padded shared-memory index e + e // 16 of each row stays within
    # the kernel's row of n + n // 16 and is one-to-one
    e = np.arange(n)
    assert len(set(e + e // 16)) == n and (e + e // 16).max() < n + n // 16


def test_launch_plan_is_built_once_per_key(monkeypatch):
    """The cached launch plan holds plan.factor(n)'s schedule, grouped into
    the register passes at their lengths; it is built once per (n, dtype,
    inverse, device) and again when the tables are replaced."""
    lib = types.SimpleNamespace(cfft_stockham_f32="f32",
                                cfft_stockham_f64="f64")
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(plan, "_LAUNCH_PLANS", {})
    dev = torch.device("cpu")
    for n, dt in ((1024, torch.float32), (960, torch.float64),
                  (899, torch.float32), (4096, torch.float64)):
        lp = fused_fft.launch_plan(n, dt, False, dev)
        assert fused_fft.launch_plan(n, dt, False, dev) is lp
        assert fused_fft.launch_plan(n, dt, True, dev) is not lp
        assert lp.fn == ("f32" if dt == torch.float32 else "f64")
        facs = plan.factor(n)
        nstages, cfac = lp.tables[5], lp.tables[6]
        assert nstages == len(facs) and tuple(cfac[:nstages]) == facs
        if n in plan.REG_LENGTHS[dt]:
            assert lp.passes == plan.reg_passes(n)
            assert tuple(p for q in lp.passes for p in q) == facs
            assert lp.tables[9] == len(lp.passes)
            assert lp.threads == lp.tile_rows * -(-n // 16)
        else:
            assert lp.passes == () and lp.tables[4] is None
    assert len(plan._LAUNCH_PLANS) == 8
    plan.device_tables(1024, torch.float32, dev,
                       source=plan.host_tables(1024))
    assert fused_fft.launch_plan(1024, torch.float32, False, dev) is not lp
    plan.clear_device_tables()


@pytest.mark.parametrize("n", [960, 1024, 899])
def test_scale_is_the_unscaled_result_times_the_scale(n):
    x = complex_input((3, n), np.complex64, seed=n + 9)
    xr, xi = torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy())
    for inverse in (False, True):
        ur, ui = fused_fft.sfft_fused(xr, xi, n, inverse)
        yr, yi = fused_fft.sfft_fused(xr, xi, n, inverse, 0.25)
        assert torch.equal(yr, ur * 0.25) and torch.equal(yi, ui * 0.25)


def test_split_pass_leaves_the_scale_to_the_engine(monkeypatch):
    """The split pass (``core.scaled_pass``) hands the norm scale to the
    engine and multiplies nothing after it: the engine's output comes back
    as it is."""
    seen = []

    def engine(xr, xi, n, inverse, scale=1.0):
        seen.append((n, inverse, scale))
        return torch.full_like(xr, 7.0), torch.full_like(xi, -7.0)

    monkeypatch.setattr(core, "sfft", engine)
    x = torch.zeros((3, 1024))
    for norm in ("ortho", "fftpack", "forward"):
        yr, yi = pt.fft_split(x, x, norm=norm)
        assert bool((yr == 7.0).all()) and bool((yi == -7.0).all())
        assert seen[-1] == (1024, False, fwd_scale(norm, 1024))
    # impl="pallas" hands it to K1 the same way (n = 960 is not K10's)
    calls = []
    monkeypatch.setattr(fused_fft, "sfft_fused",
                        lambda xr, xi, n, inv, scale=1.0: (
                            calls.append(scale) or (xr + 5.0, xi + 5.0)))
    x = torch.zeros((3, 960))
    yr, _ = cfft.fft_split(x, x, norm="ortho", impl="pallas")
    assert calls == [fwd_scale("ortho", 960)] and bool((yr == 5.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n in SIZES + [4096]:
        x = complex_input((37, n), np.complex128, seed=n)
        xr = torch.as_tensor(x.real, dtype=dtype, device="cuda")
        xi = torch.as_tensor(x.imag, dtype=dtype, device="cuda")
        for inverse in (False, True):
            before = profiling.launches["K1"]
            yr, yi = fused_fft.sfft_fused(xr, xi, n, inverse)
            assert profiling.launches["K1"] == before + 1
            pr, pi = fused_fft.sfft_plain(xr, xi, n, inverse)
            torch.cuda.synchronize()
            err = rel_err(to_np(yr) + 1j * to_np(yi),
                          to_np(pr) + 1j * to_np(pi))
            assert err < tol, (n, inverse, err)
