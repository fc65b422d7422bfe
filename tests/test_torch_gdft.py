"""The port's generalized DFT against the JAX package and the C
library's golden vectors.

The same seeded numpy inputs go through ``cfftpack_tpu`` (CPU, x64) and
``cfftpack_tpu_torch`` (CPU tensors).  Bars: 1e-12 of max |X| in
float64, 1e-4 in float32 (torch_parity.BARS); the golden vectors at
tests/test_extras.py's tolerance.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import cfftpack_tpu as jt

import cfftpack_tpu_torch as pt

from torch_parity import bar, complex_input, rel_err, to_np

# the modules, not the functions of the same names that ops exports
jgdft = importlib.import_module("cfftpack_tpu.ops.gdft")
pgdft = importlib.import_module("cfftpack_tpu_torch.ops.gdft")

torch.set_num_threads(1)

GOLD = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden.npz")
NORMS = ["fftpack", "ortho", "backward", "forward"]
SHIFTS = [0.0, 0.25, 0.5]
SHAPE = (6, 60)       # axis -1: n = 60; axis 0: n = 6


def _t(a):
    return torch.as_tensor(a)


@pytest.fixture
def eager():
    """Run the reference op by op: its jit compiles one program per
    (a, b, axis, norm, direction), the eager ops one per shape."""
    with jax.disable_jit():
        yield


# ------------------------------------------------- tables

@pytest.mark.parametrize("n", [4, 15, 60, 101, 1024])
def test_ramps_match_reference(n):
    for a, b in ((0.0, 0.0), (0.5, 0.25), (0.25, 0.7)):
        for mine, ref in zip(pgdft._ramps(n, a, b), jgdft._ramps(n, a, b)):
            assert mine.dtype == np.complex128 and np.array_equal(mine, ref)
        pre, post = pgdft._ramps(n, a, b)
        for dt in (torch.float32, torch.float64):
            dev = pgdft._device_ramps(n, a, b, dt, torch.device("cpu"))
            nd = np.float32 if dt == torch.float32 else np.float64
            for got, want in zip(dev, (pre.real, pre.imag, post.real,
                                       post.imag)):
                assert got.dtype == dt
                assert np.array_equal(got.numpy(), want.astype(nd))
    assert (pgdft._device_ramps(8, 0.5, 0.25, torch.float32,
                                torch.device("cpu"))
            is pgdft._device_ramps(8, 0.5, 0.25, torch.float32,
                                   torch.device("cpu")))


# ------------------------------------------------- parity with the reference

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("norm", NORMS)
def test_gdft_igdft(eager, norm, axis, dtype):
    x = complex_input(SHAPE, dtype, seed=1)
    for a in SHIFTS:
        for b in SHIFTS:
            for mine, ref in ((pt.gdft, jt.gdft), (pt.igdft, jt.igdft)):
                got = mine(_t(x), a, b, axis=axis, norm=norm)
                want = np.asarray(ref(x, a, b, axis=axis, norm=norm))
                assert got.dtype == getattr(torch, np.dtype(dtype).name)
                assert rel_err(got, want) < bar(dtype), (a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("norm", NORMS)
def test_gdft_split(eager, norm, axis, dtype):
    x = complex_input(SHAPE, np.complex128, seed=2)
    xr, xi = x.real.astype(dtype), x.imag.astype(dtype)
    for a in SHIFTS:
        for b in SHIFTS:
            for mine, ref in ((pt.gdft_split, jt.gdft_split),
                              (pt.igdft_split, jt.igdft_split)):
                yr, yi = mine(_t(xr), _t(xi), a, b, axis=axis, norm=norm)
                wr, wi = ref(xr, xi, a, b, axis=axis, norm=norm)
                assert yr.dtype == getattr(torch, np.dtype(dtype).name)
                assert rel_err(to_np(yr) + 1j * to_np(yi),
                               np.asarray(wr) + 1j * np.asarray(wi)
                               ) < bar(dtype), (a, b)


@pytest.mark.parametrize("n,m,a,b,nout", [(5, 9, 0.5, 0.0, 5),
                                          (7, 15, 1.0, 0.5, 7),
                                          (6, 16, 0.25, 0.1, 9)])
def test_shifted_dft_padded_matches_reference(n, m, a, b, nout):
    for dt in (np.complex128, np.complex64, np.float64):
        x = complex_input((3, n), np.complex128, seed=n + m)
        x = (x if np.dtype(dt).kind == "c" else x.real).astype(dt)
        got = pgdft.shifted_dft_padded(_t(x), n, m, a, b, nout)
        want = np.asarray(jgdft.shifted_dft_padded(x, n, m, a, b, nout))
        assert tuple(got.shape) == (3, nout)
        assert rel_err(got, want) < bar(dt)


# ------------------------------------------------- golden vectors, oracles

@pytest.mark.parametrize("n", [4, 8, 16, 60, 960])
@pytest.mark.parametrize("ab", [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5),
                                (0.5, 0.5), (0.25, 0.1)])
def test_gdft_golden_forward(n, ab):
    """The C library's gdft_forward(a_ref, b_ref) is gdft(x, a=b_ref,
    b=a_ref) under the fftpack norm."""
    a_ref, b_ref = ab
    key = f"{n}_{a_ref}_{b_ref}"
    got = pt.gdft(_t(GOLD[f"gdft_in_{key}"]), a=b_ref, b=a_ref)
    np.testing.assert_allclose(got.numpy(), GOLD[f"gdft_fwd_{key}"],
                               atol=1e-12 * max(1, n ** 0.5))


@pytest.mark.parametrize("n", [4, 8, 60, 101])
@pytest.mark.parametrize("ab", [(0.0, 0.0), (0.5, 0.5), (0.25, 0.7)])
@pytest.mark.parametrize("norm", NORMS)
def test_round_trip_and_definition(n, ab, norm):
    a, b = ab
    x = complex_input((2, n), np.complex128, seed=n)
    y = pt.gdft(_t(x), a, b, norm=norm)
    back = pt.igdft(y, a, b, norm=norm)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-12 * max(1, n))
    if norm == "backward":      # the unscaled forward is the definition
        j = np.arange(n)
        W = np.exp(-2j * np.pi * np.outer(j + b, j + a) / n)   # [k, j]
        np.testing.assert_allclose(y.numpy(), x @ W.T, atol=1e-12 * n)


def test_reduces_to_fft_and_promotes():
    x = complex_input((3, 32), np.complex128, seed=3)
    assert rel_err(pt.gdft(_t(x)), pt.fft(_t(x))) < 1e-14
    assert pt.gdft(_t(x.real.copy())).dtype == torch.complex128
    assert pt.gdft(_t(x.real.astype(np.float32))).dtype == torch.complex64
    assert pt.gdft(torch.arange(8)).dtype == torch.complex64
    yr, yi = pt.gdft_split(torch.arange(8), torch.zeros(8, dtype=torch.int64))
    assert yr.dtype == torch.float32
    wr, _ = jt.gdft_split(np.arange(8), np.zeros(8, np.int64))
    assert np.asarray(wr).dtype == np.float32


def test_errors_match_reference():
    x = complex_input(SHAPE, np.complex128, seed=4)
    xr = x.real.copy()
    for api, arg, rarg in ((jt, x, xr), (pt, _t(x), _t(xr))):
        with pytest.raises(ValueError, match="norm"):
            api.gdft(arg, 0.5, 0.5, norm="bogus")
        with pytest.raises(ValueError, match="norm"):
            api.igdft_split(rarg, rarg, norm="bogus")
        with pytest.raises(ValueError, match="shapes differ"):
            api.gdft_split(rarg, rarg[:3])
    z = torch.zeros((2, 8), dtype=torch.complex64)
    with pytest.raises(TypeError, match="real input"):
        pt.gdft_split(z, z)
    with pytest.raises(ValueError, match="axis"):
        pt.gdft(_t(x), axis=2)


def test_exports():
    for name in ("gdft", "igdft", "gdft_split", "igdft_split", "fftshift",
                 "ifftshift", "fftfreq", "rfftfreq", "circular_convolve"):
        assert callable(getattr(pt, name)) and hasattr(jt, name)
    assert pt.__version__ == "0.6.0"
