"""K1's plain version against the Pallas kernel it replaces.

``cfftpack_tpu.ops.pallas_fft.sfft_pallas`` runs in interpret mode on
the CPU, as tests/test_pallas.py runs it; the port's ``sfft_fused``
takes the plain PyTorch version on CPU tensors.  The CUDA kernel
itself is checked on the card (``-m cuda`` here, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cfftpack_tpu import plan as jplan
from cfftpack_tpu.ops.core import _stockham
from cfftpack_tpu.ops.pallas_fft import sfft_pallas

from cfftpack_tpu_torch.ops import fused_fft

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
    before = fused_fft.launches
    x = complex_input((3, 960), np.complex128, seed=1)
    fused_fft.sfft_fused(torch.as_tensor(x.real.copy()),
                         torch.as_tensor(x.imag.copy()), 960, False)
    assert fused_fft.launches == before == 0


def test_non_cpu_tensor_takes_the_kernel_or_raises():
    """Off the CPU there is no plain fallback: a tensor that is not on
    a CUDA device is refused by the kernel's wrapper."""
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_fft.sfft_fused(x, x, 64, False)
    assert fused_fft.launches == 0


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
            before = fused_fft.launches
            yr, yi = fused_fft.sfft_fused(xr, xi, n, inverse)
            assert fused_fft.launches == before + 1
            pr, pi = fused_fft.sfft_plain(xr, xi, n, inverse)
            torch.cuda.synchronize()
            err = rel_err(to_np(yr) + 1j * to_np(yi),
                          to_np(pr) + 1j * to_np(pi))
            assert err < tol, (n, inverse, err)
