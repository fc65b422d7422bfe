"""The port's split engine (core.sfft / srfft / sirfft) against the JAX
package's, in float32 and float64, over every engine the dispatch
picks: K1 (its plain version here), Bluestein, row pairing for odd
real lengths, and the four-step forced by a small shared-memory
budget with the stream kernels off."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cfftpack_tpu.ops import core as jcore

from cfftpack_tpu_torch.ops import core, fused_fft, stream_fft

from torch_parity import bar, complex_input, real_input, rel_err, to_np

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]

# the reference engine, compiled once per shape (eager dispatch of its
# many small ops costs more than the compile)
j_sfft = jax.jit(jcore.sfft, static_argnums=(2, 3))
j_srfft = jax.jit(jcore.srfft, static_argnums=(1,))
j_sirfft = jax.jit(jcore.sirfft, static_argnums=(2,))


def _sfft_both(n, dtype, inverse, batch=3):
    x = complex_input((batch, n), np.complex128, seed=n + inverse)
    xr, xi = x.real.astype(dtype), x.imag.astype(dtype)
    wr, wi = j_sfft(jnp.asarray(xr), jnp.asarray(xi), n, inverse)
    yr, yi = core.sfft(torch.as_tensor(xr), torch.as_tensor(xi), n, inverse)
    assert yr.dtype == getattr(torch, np.dtype(dtype).name)
    return (to_np(yr) + 1j * to_np(yi), np.asarray(wr) + 1j * np.asarray(wi))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1, 101, 1009, 960, 899])
def test_sfft_matches_reference(n, inverse, dtype):
    got, want = _sfft_both(n, dtype, inverse)
    assert rel_err(got, want) < bar(dtype)


def _real_both(n, dtype, batch):
    x = real_input((batch, n), dtype, seed=n + batch)
    wr, wi = j_srfft(jnp.asarray(x), n)
    yr, yi = core.srfft(torch.as_tensor(x), n)
    w = np.asarray(wr) + 1j * np.asarray(wi)
    y = to_np(yr) + 1j * to_np(yi)
    # imag(DC) (and imag(Nyquist) for even n) are exact zeros
    assert np.all(y.imag[:, 0] == 0)
    if n % 2 == 0:
        assert np.all(y.imag[:, -1] == 0)
    back = core.sirfft(yr, yi, n)
    wback = j_sirfft(wr, wi, n)
    return y, w, to_np(back), np.asarray(wback)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [4, 3])          # even batch pairs rows
@pytest.mark.parametrize("n", [960, 15, 1009, 2])
def test_real_matches_reference(n, batch, dtype):
    y, w, back, wback = _real_both(n, dtype, batch)
    assert rel_err(y, w) < bar(dtype)
    assert rel_err(back, wback) < bar(dtype)


def test_pair_path_is_taken_for_odd_n_even_batch():
    assert core._use_pair(15, 4) and not core._use_pair(15, 3)
    assert not core._use_pair(16, 4)


@pytest.fixture
def small_budget(monkeypatch):
    """A 8 KiB budget: K1 takes n <= 512 (f32) / 256 (f64), and no
    stream length: longer lengths run the four-step with K1 (plain) on
    its rows."""
    monkeypatch.setattr(fused_fft, "_SMEM_BUDGET", 8192)
    monkeypatch.setattr(stream_fft, "_MAX_M", 0)
    assert not stream_fft.stream_eligible(2048, torch.float32)
    assert not fused_fft.fused_eligible(2048, torch.float32)
    assert fused_fft.fused_eligible(128, torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2048, 10010])       # n1 = 16 dense; 65 rows
def test_fourstep_matches_reference(small_budget, n, inverse, dtype):
    assert core._fourstep_split_n(n) is not None
    got, want = _sfft_both(n, dtype, inverse, batch=2)
    assert rel_err(got, want) < bar(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fourstep_real_matches_reference(small_budget, dtype):
    y, w, back, wback = _real_both(4096, dtype, batch=2)
    assert rel_err(y, w) < bar(dtype)
    assert rel_err(back, wback) < bar(dtype)


def test_no_split_raises(small_budget):
    # 1000 has no divisor n1 in [8, 256] with n / n1 >= 128
    with pytest.raises(ValueError, match="four-step"):
        core._fourstep_local(torch.zeros(1, 1000), torch.zeros(1, 1000),
                             1000, False)
