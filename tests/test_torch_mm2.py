"""K11's plain version against the Pallas two-matmul kernel it replaces.

``cfftpack_tpu.ops.pallas_stream`` runs ``sfft_mm2_pallas`` and
``sfft_mm2_pallas_permuted`` in interpret mode on the CPU, as
tests/test_pallas.py runs them; the port's wrappers take their plain
PyTorch version on CPU tensors.  The bar is 1e-5 of max |X| (the
kernels' bar on the card); the tables are held to exact float32
equality.  The CUDA kernel itself is checked on the card (``-m cuda``
here, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import cfftpack_tpu.ops.pallas_stream as ps

from cfftpack_tpu_torch.ops import stream_fft as sf
from cfftpack_tpu_torch.utils import profiling

from torch_parity import complex_input, to_np

torch.set_num_threads(1)

TOL = 1e-5
# (inverse, natural): natural and permuted spectra, forward and inverse
FORMS = [(False, True), (False, False), (True, True), (True, False)]


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


def _fn(natural):
    return ((sf.sfft_mm2, ps.sfft_mm2_pallas) if natural
            else (sf.sfft_mm2_permuted, ps.sfft_mm2_pallas_permuted))


def _oracle(x, n, inverse, natural):
    """numpy.fft (complex128) of what a form computes, in its layout."""
    b, m = x.shape[0], n // 128
    x = x.astype(np.complex128)
    if not inverse:
        X = np.fft.fft(x)
        return (X if natural
                else X.reshape(b, 128, m).transpose(0, 2, 1).reshape(b, n))
    if not natural:
        x = x.reshape(b, m, 128).transpose(0, 2, 1).reshape(b, n)
    return np.fft.ifft(x) * n


# ------------------------------------------------- eligibility, tables

def test_eligibility_matches_reference():
    for n in list(range(1, 300)) + list(range(128, 40000, 128)) + [65536]:
        for dt_t, dt_n in ((torch.float32, np.float32),
                           (torch.float64, np.float64)):
            assert sf.mm2_eligible(n, dt_t) == ps.mm2_eligible(n, dt_n), n
    assert not sf.mm2_eligible(128, torch.float32)            # m = 1
    assert sf.mm2_eligible(256, torch.float32)
    assert sf.mm2_eligible(32768, torch.float32)              # m = 256
    assert not sf.mm2_eligible(32896, torch.float32)          # m = 257
    assert sf._MM2_MAX_M == ps._MM2_MAX_M == 256


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [2, 3, 16, 100, 256])
def test_tables_match_reference(m, inverse):
    n = 128 * m
    mr, mi, _, dr, di, _, t1r, t1i = ps._mm2_tables(n, inverse)
    mine = sf._mm2_device_tables(n, inverse, torch.device("cpu"))
    for a, b in zip(mine, (mr, mi, dr, di, t1r, t1i)):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert np.array_equal(a.numpy(), b)
    # both DFT matrices are symmetric: the kernel reads them transposed
    assert np.array_equal(mr, mr.T) and np.array_equal(mi, mi.T)
    assert np.array_equal(dr, dr.T) and np.array_equal(di, di.T)


# ------------------------------------------------- the four forms

@pytest.mark.parametrize("inverse,natural", FORMS)
@pytest.mark.parametrize("n", [2048, 384])                   # m = 16, 3
def test_plain_matches_pallas(n, inverse, natural):
    xr, xi = _pair((3, n), seed=n + 2 * inverse + natural)
    mine, ref = _fn(natural)
    got = mine(torch.as_tensor(xr), torch.as_tensor(xi), n, inverse)
    want = ref(jnp.asarray(xr), jnp.asarray(xi), n, inverse)
    assert got[0].dtype == torch.float32
    assert _err(_cplx(got), _cplx(want)) < TOL
    assert _err(_cplx(got), _oracle(xr + 1j * xi, n, inverse, natural)) < TOL


@pytest.mark.parametrize("inverse,natural", FORMS)
@pytest.mark.parametrize("m", [2, 100, 255, 256])
def test_plain_matches_numpy(m, inverse, natural):
    n = 128 * m
    xr, xi = _pair((2, n), seed=m + 2 * inverse + natural)
    got = _fn(natural)[0](torch.as_tensor(xr), torch.as_tensor(xi), n,
                          inverse)
    assert _err(_cplx(got), _oracle(xr + 1j * xi, n, inverse, natural)) < TOL


def test_permuted_layout_is_the_stream_kernel_s():
    """[k2, k1] as K2 has it, so either forward feeds either inverse."""
    n = 2048
    xr, xi = _pair((3, n), seed=9)
    tr, ti = torch.as_tensor(xr), torch.as_tensor(xi)
    a = sf.sfft_mm2_permuted(tr, ti, n, False)
    b = sf.sfft_stream_permuted(tr, ti, n, False)
    assert _err(_cplx(a), _cplx(b)) < TOL
    back = sf.sfft_stream_permuted(*a, n, True)
    assert _err(_cplx(back) / n, xr + 1j * xi) < TOL


def test_contract_any_leading_shape_and_batch():
    n = 384
    xr, xi = _pair((2, 3, n), seed=5)
    yr, yi = sf.sfft_mm2(torch.as_tensor(xr), torch.as_tensor(xi), n, False)
    assert tuple(yr.shape) == (2, 3, n)
    assert _err(_cplx((yr, yi)),
                np.fft.fft(xr.astype(np.float64) + 1j * xi)) < TOL
    e = torch.zeros((0, n))
    for fn in (sf.sfft_mm2, sf.sfft_mm2_permuted):
        yr, yi = fn(e, e, n, True)
        assert tuple(yr.shape) == (0, n) and tuple(yi.shape) == (0, n)


# ------------------------------------------------- the wrapper's contract

def test_launch_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 2048))
    before = dict(profiling.launches)
    with pytest.raises(ValueError, match="CUDA"):
        sf._mm2_launch(x, x, 2048, False, True)                # CPU tensor
    meta = torch.empty((2, 2048), device="meta")
    for fn in (sf.sfft_mm2, sf.sfft_mm2_permuted):
        with pytest.raises(ValueError, match="CUDA"):
            fn(meta, meta, 2048, False)                        # no fallback
    assert profiling.launches == before and "K11" in before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for m, b in ((2, 5), (3, 7), (16, 3), (33, 2), (100, 3), (255, 2),
                 (256, 3)):
        n = 128 * m
        xr, xi = _pair((b, n), seed=n + b)
        xr = torch.as_tensor(xr, device="cuda")
        xi = torch.as_tensor(xi, device="cuda")
        for inverse, natural in FORMS:
            got = sf._mm2_launch(xr, xi, n, inverse, natural)
            want = sf.sfft_mm2_plain(xr, xi, n, inverse, natural)
            torch.cuda.synchronize()
            assert _err(_cplx(got), _cplx(want)) < TOL, (m, inverse, natural)
    with pytest.raises(TypeError, match="float32"):
        sf._mm2_launch(xr.double(), xi.double(), n, False, True)
    with pytest.raises(ValueError, match="n=128"):
        sf._mm2_launch(xr.reshape(-1, 128), xi.reshape(-1, 128), 128, False,
                       True)
