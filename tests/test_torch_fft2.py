"""The port's 2-D and N-D transforms against the JAX package's and the C
library's golden vectors.

The same seeded numpy inputs go through ``cfftpack_tpu`` (CPU, x64) and
``cfftpack_tpu_torch`` (CPU tensors: the kernels' plain versions, K6's
on the axis -2 pass of float32 planes whose length it takes).  Bars:
1e-4 of max |X| in float32 and 1e-12 in float64 (torch_parity.BARS);
the golden vectors at tests/test_golden_rfft2.py's 1e-12 * max(l, m).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import cfftpack_tpu as jt
import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch.ops import colfft

from torch_parity import bar, complex_input, real_input, rel_err, to_np

torch.set_num_threads(1)

NORMS = ["fftpack", "ortho", "backward", "forward"]
# (shape, axes): the trailing pair at a shape whose axis -2 pass takes the
# column branch in float32 (n0 = 64) and at one that does not (n0 = 6),
# and a pair of axes that is not the trailing one
CASES = [((2, 64, 128), (-2, -1)), ((6, 60), (-2, -1)),
         ((12, 3, 10), (0, 2))]
IDS = ["column", "moved", "axes02"]
GOLD = np.load(Path(__file__).parent / "golden" / "golden_rfft2.npz")
GOLD_SIZES = [(4, 4), (5, 4), (4, 5), (5, 5), (6, 10), (8, 6),
              (31, 30), (30, 31), (60, 48)]


def _t(a):
    return torch.as_tensor(a)


def _c(pair):
    return to_np(pair[0]) + 1j * to_np(pair[1])


def _jc(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


@pytest.fixture
def column_calls(monkeypatch):
    """The calls of K6's plain version, by direction."""
    calls = []
    real = colfft.colfft_plain

    def spy(xr, xi, inverse=False, scale=1.0):
        calls.append(inverse)
        return real(xr, xi, inverse, scale)

    monkeypatch.setattr(colfft, "colfft_plain", spy)
    return calls


def _takes_column(shape, axes, dtype) -> bool:
    return (axes == (-2, -1)
            and np.dtype(dtype) in (np.float32, np.complex64)
            and colfft.colfft_eligible(shape[-2], shape[-1], torch.float32))


# ------------------------------------------------- complex forms

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("norm", NORMS)
def test_fft2_ifft2(norm, case, dtype, column_calls):
    shape, axes = case
    x = complex_input(shape, dtype, seed=1)
    for mine, ref, inv in ((pt.fft2, jt.fft2, False),
                           (pt.ifft2, jt.ifft2, True)):
        del column_calls[:]
        got = mine(_t(x), axes=axes, norm=norm)
        want = np.asarray(ref(x, axes=axes, norm=norm))
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        assert rel_err(got, want) < bar(dtype)
        assert column_calls == ([inv] if _takes_column(shape, axes, dtype)
                                else [])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("axes", [None, (0,), (2, 0, 1)],
                         ids=["all", "axis0", "perm"])
@pytest.mark.parametrize("norm", NORMS)
def test_fftn_ifftn(norm, axes, dtype):
    x = complex_input((4, 16, 6), dtype, seed=2)
    for mine, ref in ((pt.fftn, jt.fftn), (pt.ifftn, jt.ifftn)):
        got = mine(_t(x), axes=axes, norm=norm)
        want = np.asarray(ref(x, axes=axes, norm=norm))
        assert rel_err(got, want) < bar(dtype)
    back = pt.ifftn(pt.fftn(_t(x), axes=axes, norm=norm), axes=axes,
                    norm=norm)
    assert rel_err(back, x) < 10 * bar(dtype)


def test_fft2_promotes_real_input():
    x = real_input((6, 60), np.float64, seed=3)
    got = pt.fft2(_t(x))
    assert got.dtype == torch.complex128
    assert rel_err(got, np.asarray(jt.fft2(x))) < 1e-12


# ------------------------------------------------- split forms

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("norm", NORMS)
def test_fft2_split_ifft2_split(norm, case, dtype, column_calls):
    shape, axes = case
    x = complex_input(shape, np.complex128, seed=4)
    xr, xi = x.real.astype(dtype), x.imag.astype(dtype)
    for mine, ref, inv in ((pt.fft2_split, jt.fft2_split, False),
                           (pt.ifft2_split, jt.ifft2_split, True)):
        del column_calls[:]
        got = mine(_t(xr), _t(xi), axes=axes, norm=norm)
        want = ref(xr, xi, axes=axes, norm=norm)
        assert got[0].dtype == getattr(torch, np.dtype(dtype).name)
        assert rel_err(_c(got), _jc(want)) < bar(dtype)
        assert column_calls == ([inv] if _takes_column(shape, axes, dtype)
                                else [])


# ------------------------------------------------- real forms

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("norm", NORMS)
def test_rfft2_irfft2(norm, case, dtype):
    shape, axes = case
    x = real_input(shape, dtype, seed=5)
    s = (shape[axes[0]], shape[axes[1]])
    got = pt.rfft2(_t(x), axes=axes, norm=norm)
    want = np.asarray(jt.rfft2(x, axes=axes, norm=norm))
    assert rel_err(got, want) < bar(dtype)
    back = pt.irfft2(got, s, axes=axes, norm=norm)
    wback = np.asarray(jt.irfft2(want, s, axes=axes, norm=norm))
    assert back.dtype == getattr(torch, np.dtype(dtype).name)
    assert rel_err(back, wback) < bar(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("norm", NORMS)
def test_rfft2_split_irfft2_split(norm, case, dtype, column_calls):
    shape, axes = case
    x = real_input(shape, dtype, seed=6)
    s = (shape[axes[0]], shape[axes[1]])
    yr, yi = pt.rfft2_split(_t(x), axes=axes, norm=norm)
    wr, wi = jt.rfft2_split(x, axes=axes, norm=norm)
    assert rel_err(_c((yr, yi)), _jc((wr, wi))) < bar(dtype)
    back = pt.irfft2_split(yr, yi, s, axes=axes, norm=norm)
    wback = jt.irfft2_split(wr, wi, s, axes=axes, norm=norm)
    assert rel_err(back, np.asarray(wback)) < bar(dtype)
    # the column pass runs over the n1//2 + 1 packed columns as they are
    assert column_calls == ([False, True]
                            if _takes_column(shape, axes, dtype) else [])


@pytest.mark.parametrize("n1", [40, 41])
def test_rfft2_odd_and_even_widths_round_trip(n1):
    x = real_input((2, 48, n1), np.float32, seed=n1)
    yr, yi = pt.rfft2_split(_t(x), norm="backward")
    assert yr.shape == (2, 48, n1 // 2 + 1)
    want = np.fft.rfft2(x.astype(np.float64))
    assert rel_err(_c((yr, yi)), want) < 1e-5
    back = pt.irfft2_split(yr, yi, (48, n1), norm="backward")
    assert rel_err(back, x) < 1e-5


@pytest.mark.parametrize("which", ["n0", "n1"])
def test_irfft2_split_length_errors_match_reference(which):
    y = np.zeros((2, 8, 5), np.float32)
    s = (7, 8) if which == "n0" else (8, 11)
    msg = "expected n0=7" if which == "n0" else "expected n1//2\\+1 = 6"
    with pytest.raises(ValueError, match=msg):
        jt.irfft2_split(y, y, s)
    with pytest.raises(ValueError, match=msg):
        pt.irfft2_split(_t(y), _t(y), s)
    if which == "n0":
        with pytest.raises(ValueError, match=msg):
            pt.irfft2(_t(y + 0j), s)


def test_errors_match_reference():
    x = complex_input((6, 60), np.complex128, seed=10)
    for api in (jt, pt):
        arg = x if api is jt else _t(x)
        rarg = x.real.copy() if api is jt else _t(x.real.copy())
        with pytest.raises(ValueError, match="norm"):
            api.fft2(arg, norm="bogus")
        with pytest.raises(ValueError, match="norm"):
            api.rfft2_split(rarg, norm="bogus")
        with pytest.raises(ValueError, match="shapes differ"):
            api.fft2_split(rarg, rarg[:3])
        with pytest.raises(TypeError):
            api.rfft2(arg)                            # complex input
        with pytest.raises(TypeError):
            api.rfft2_split(arg)


def test_exports():
    names = ("fft2", "ifft2", "fftn", "ifftn", "fft2_split", "ifft2_split",
             "rfft2", "irfft2", "rfft2_split", "irfft2_split")
    for name in names:
        assert callable(getattr(pt, name)) and callable(getattr(jt, name))


# ------------------------------------------------- golden vectors

def _decode_packed(P, l, m):
    """rfft2f_ packed (l, m) real array -> full (l, m) complex spectrum
    (tests/test_golden_rfft2.py): row 0 and (even l) row l-1 are
    rfft-packed along m; rows 2k-1, 2k are re/im of complex row k; the
    remaining rows follow by conjugate symmetry."""
    F = np.zeros((l, m), dtype=np.complex128)

    def unpack_row(r):
        row = np.zeros(m, dtype=np.complex128)
        row[0] = r[0]
        for k in range(1, (m - 1) // 2 + 1):
            row[k] = r[2 * k - 1] + 1j * r[2 * k]
            row[m - k] = np.conj(row[k])
        if m % 2 == 0:
            row[m // 2] = r[m - 1]
        return row

    F[0] = unpack_row(P[0])
    for k in range(1, (l + 1) // 2):
        F[k] = P[2 * k - 1] + 1j * P[2 * k]
    if l % 2 == 0:
        F[l // 2] = unpack_row(P[l - 1])
    for k in range(1, (l + 1) // 2):
        F[l - k, 0] = np.conj(F[k, 0])
        F[l - k, 1:] = np.conj(F[k, 1:][::-1])
    return F


@pytest.mark.parametrize("lm", GOLD_SIZES)
def test_rfft2_forward_golden(lm):
    l, m = lm
    x = GOLD[f"rfft2_in_{l}x{m}"]
    F = _decode_packed(GOLD[f"rfft2_fwd_{l}x{m}"], l, m)
    # r2c runs over the last axis: feed x.T so the real axis is l, the
    # library's stride-1 real dimension
    mine = to_np(pt.rfft2(_t(x.T.copy())))          # (m, l//2 + 1)
    np.testing.assert_allclose(mine, F[: l // 2 + 1, :].T,
                               atol=1e-12 * max(l, m))


@pytest.mark.parametrize("lm", GOLD_SIZES)
def test_irfft2_roundtrip_golden(lm):
    l, m = lm
    x = GOLD[f"rfft2_in_{l}x{m}"]
    F = _decode_packed(GOLD[f"rfft2_fwd_{l}x{m}"], l, m)
    spec = F[: l // 2 + 1, :].T.copy()
    back = to_np(pt.irfft2(_t(spec), (m, l)))
    np.testing.assert_allclose(back, x.T, atol=1e-12 * max(l, m))
