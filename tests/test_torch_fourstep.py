"""K10's plain version and ``fft_split(impl="pallas")`` against the
Pallas four-step kernel they replace.

``cfftpack_tpu.ops.pallas_fourstep`` runs in interpret mode on the CPU,
as tests/test_pallas.py runs it; the port's wrapper takes its plain
PyTorch version on CPU tensors.  The bar is 1e-5 of max |X| (the
kernels' bar on the card); the tables are held to exact float32
equality.  The CUDA kernel itself is checked on the card (``-m cuda``
here, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import cfftpack_tpu as jt
import cfftpack_tpu.ops.pallas_fourstep as pf

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.ops import fourstep_fft as fs
from cfftpack_tpu_torch.ops import stream_fft as sf
from cfftpack_tpu_torch.utils import profiling

from torch_parity import complex_input, to_np

torch.set_num_threads(1)

TOL = 1e-5
NORMS = ["fftpack", "ortho", "backward", "forward"]


def _err(got, want) -> float:
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(shape, seed):
    x = complex_input(shape, np.complex64, seed=seed)
    return x.real.copy(), x.imag.copy()


def _cplx(pair):
    return to_np(pair[0]) + 1j * to_np(pair[1])


# ------------------------------------------------- eligibility, tables

def test_eligibility_matches_reference():
    for k in list(range(1, 4200)) + [8192, 16384]:
        n = 64 * k
        assert (fs.fourstep_eligible(n, torch.float32)
                == pf.fourstep_pallas_eligible(n, np.float32)), n
    taken = [n for n in range(64, 1 << 19, 64)
             if fs.fourstep_eligible(n, torch.float32)]
    assert taken == [1024, 4096, 16384, 65536, 262144]
    for n in (100, 4095, 4097):
        assert not fs.fourstep_eligible(n, torch.float32)
    assert not fs.fourstep_eligible(4096, torch.float64)
    assert not pf.fourstep_pallas_eligible(4096, np.float64)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1024, 4096, 16384, 65536, 262144])
def test_tables_match_reference(n, inverse):
    """The DFT matrix and outer twiddle against the first transform of
    the reference's lane-paired tables; the stage twiddles (the plan's,
    forward sign, conjugated in the stages) against the first lane of
    its stage tables, which stop where its DFT-16 tail begins."""
    t1r, t1i, bdr, bdi, fr, fi = pf._tables(n, inverse)
    Dr, Di, ur, ui = fs._tables(n, inverse)
    for a in (Dr, Di, ur, ui):
        assert a.dtype == np.float32
    assert np.array_equal(ur.T, t1r[:, :64])
    assert np.array_equal(ui.T, t1i[:, :64])
    assert np.array_equal(Dr.T, bdr[:64, :64])
    assert np.array_equal(Di.T, bdi[:64, :64])
    n2 = n // 64
    assert plan.factor(n2) == (4,) * len(plan.factor(n2))
    off, m = 0, n2
    sign = -1.0 if inverse else 1.0
    for tw in plan.stage_twiddles(n2):
        if m <= 16:
            break
        flat = tw.reshape(-1)
        assert np.array_equal(flat.real.astype(np.float32),
                              fr[off: off + m, 0])
        assert np.array_equal((sign * flat.imag).astype(np.float32),
                              fi[off: off + m, 0])
        off += m
        m //= 4
    assert m == 16 and off == (fr.shape[0] if n2 > 16 else 0)


def test_pass_b_rows_fit_shared_memory():
    for n2 in (16, 64, 256, 1024, 4096):
        rows = sf._col_lanes(n2)         # the rule pass B takes
        assert rows & (rows - 1) == 0 and 64 % rows == 0 and rows >= 2
        assert 16 * rows * (n2 + 32 // rows) <= 232448
    assert [sf._col_lanes(n2) for n2 in (16, 64, 256, 1024, 4096)] == [
        32, 32, 16, 4, 2]


# ------------------------------------------------- the transform

@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_pallas(inverse):
    n, b = 4096, 3
    xr, xi = _pair((b, n), seed=3 + inverse)
    got = fs.sfft_fourstep(torch.as_tensor(xr), torch.as_tensor(xi), n,
                           inverse)
    want = pf.sfft_fourstep_pallas(xr, xi, n, inverse)
    assert got[0].dtype == torch.float32
    assert _err(_cplx(got), _cplx(want)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1024, 16384, 65536])
def test_plain_matches_numpy(n, inverse):
    xr, xi = _pair((2, n), seed=n + inverse)
    got = fs.sfft_fourstep(torch.as_tensor(xr), torch.as_tensor(xi), n,
                           inverse)
    x = xr.astype(np.float64) + 1j * xi
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert _err(_cplx(got), want) < TOL


def test_contract_any_leading_shape_and_batch():
    n = 4096
    xr, xi = _pair((2, 3, n), seed=5)
    yr, yi = fs.sfft_fourstep(torch.as_tensor(xr), torch.as_tensor(xi), n,
                              False)
    assert tuple(yr.shape) == (2, 3, n)
    assert _err(_cplx((yr, yi)),
                np.fft.fft(xr.astype(np.float64) + 1j * xi)) < TOL
    e = torch.zeros((0, n))
    yr, yi = fs.sfft_fourstep(e, e, n, True)
    assert tuple(yr.shape) == (0, n) and tuple(yi.shape) == (0, n)
    v = torch.as_tensor(xr[0, 0])                       # no batch axis
    yr, yi = fs.sfft_fourstep(v, torch.zeros_like(v), n, False)
    assert tuple(yr.shape) == (n,)


# ------------------------------------------------- fft_split(impl="pallas")

@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("norm", NORMS)
def test_fft_split_pallas_matches_reference(monkeypatch, norm, axis):
    calls = []
    real = fs.sfft_fourstep

    def spy(xr, xi, n, inverse):
        calls.append((n, inverse))
        return real(xr, xi, n, inverse)

    monkeypatch.setattr(fs, "sfft_fourstep", spy)
    n = 4096
    xr, xi = _pair((2, n) if axis == -1 else (n, 2), seed=7 + axis)
    for mine, ref, inverse in ((pt.fft_split, jt.fft_split, False),
                               (pt.ifft_split, jt.ifft_split, True)):
        got = mine(torch.as_tensor(xr), torch.as_tensor(xi), axis=axis,
                   norm=norm, impl="pallas")
        want = ref(xr, xi, axis=axis, norm=norm, impl="pallas")
        assert tuple(got[0].shape) == xr.shape
        assert _err(_cplx(got), _cplx(want)) < TOL, (norm, axis, inverse)
    assert calls == [(n, False), (n, True)]


def test_default_engine_does_not_pick_the_kernel(monkeypatch):
    def boom(*a):
        raise AssertionError("K10 is opt-in")

    monkeypatch.setattr(fs, "sfft_fourstep", boom)
    z = torch.zeros((1, 4096))
    pt.fft_split(z, z)
    pt.fft(torch.zeros((1, 4096), dtype=torch.complex64))


# ------------------------------------------------- the wrapper's contract

def test_launch_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4096))
    with pytest.raises(ValueError, match="CUDA"):
        fs._launch(x, x, 4096, False)                          # CPU tensor
    meta = torch.empty((2, 4096), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fs.sfft_fourstep(meta, meta, 4096, False)              # no fallback
    assert profiling.launches["K10"] == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for n, b in ((1024, 7), (4096, 3), (16384, 5), (65536, 2), (262144, 1)):
        xr, xi = _pair((b, n), seed=n + b)
        xr = torch.as_tensor(xr, device="cuda")
        xi = torch.as_tensor(xi, device="cuda")
        for inverse in (False, True):
            got = fs.sfft_fourstep(xr, xi, n, inverse)
            want = fs.sfft_fourstep_plain(xr, xi, n, inverse)
            torch.cuda.synchronize()
            assert _err(_cplx(got), _cplx(want)) < TOL, (n, inverse)
    with pytest.raises(TypeError, match="float32"):
        fs._launch(xr.double(), xi.double(), 262144, False)
    with pytest.raises(ValueError, match="n=8192"):
        fs._launch(xr.reshape(-1, 8192), xi.reshape(-1, 8192), 8192, False)
