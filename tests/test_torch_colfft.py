"""K6 (the column FFT) and K9 (the column DCT-II/III): the plain
versions against the functions they replace.

``cfftpack_tpu.ops.pallas_colfft`` runs in interpret mode on the CPU, as
tests/test_pallas.py runs it, and the reference's column DCT cores run
over it; the port's wrappers take their plain PyTorch versions on CPU
tensors.  The bar is the reference's own in test_pallas.py: 5e-6 of
max |X|.  The CUDA kernel itself is checked on the card (``-m cuda``
here, and chip_smoke.py).
"""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import cfftpack_tpu.ops.pallas_colfft as jcol

from cfftpack_tpu_torch.ops import colfft, stream_fft

from torch_parity import real_input, to_np

jdct = importlib.import_module("cfftpack_tpu.ops.dct")

torch.set_num_threads(1)

TOL = 5e-6


def _err(got, want) -> float:
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(shape, seed):
    return (real_input(shape, np.float32, seed),
            real_input(shape, np.float32, seed + 1000))


# ------------------------------------------------- eligibility

@pytest.mark.parametrize("n0,n1,dtype,ok", [
    (1024, 1024, torch.float32, True),
    (48, 128, torch.float32, True),          # radix-3 stage
    (80, 128, torch.float32, True),          # radix-5 stage
    (4096, 2, torch.float32, True),          # the cap
    (1024, 100, torch.float32, True),        # no lane-tile rule on n1
    (1024, 513, torch.float32, True),        # the packed width of rfft2
    (24, 128, torch.float32, False),         # no stage plan
    (8192, 128, torch.float32, False),       # past the cap
    (112, 128, torch.float32, False),        # 16 * 7
    (1024, 1024, torch.float64, False),
])
def test_colfft_eligible(n0, n1, dtype, ok):
    assert colfft.colfft_eligible(n0, n1, dtype) is ok


def test_eligible_lengths_match_reference():
    """On the transform axis the gate is the reference's."""
    for n0 in range(1, 4200):
        assert (colfft.colfft_eligible(n0, 128, torch.float32)
                == jcol.colfft_eligible(n0, 128, np.float32)), n0


@pytest.mark.parametrize("n0,n1,lanes", [(16, 1024, 32), (128, 1024, 32),
                                         (256, 1024, 16), (512, 1024, 8),
                                         (1024, 1024, 4), (2048, 1024, 2),
                                         (4096, 1024, 2), (64, 5, 8),
                                         (64, 1, 1)])
def test_lanes_fit_shared_memory(n0, n1, lanes):
    assert colfft._col_lanes(n0, n1) == lanes
    assert 16 * n0 * lanes <= stream_fft._SMEM_BUDGET


# ------------------------------------------------- K6 against Pallas

@pytest.mark.parametrize("shape", [(3, 64, 256), (2, 48, 128)])
@pytest.mark.parametrize("inverse,scale", [(False, 1.0), (True, 1.0),
                                           (False, 0.25)])
def test_colfft_matches_pallas(shape, inverse, scale):
    x, y = _pair(shape, seed=shape[1])
    zr, zi = colfft.scolfft(torch.as_tensor(x), torch.as_tensor(y), inverse,
                            scale)
    wr, wi = jcol.scolfft_pallas(jnp.asarray(x), jnp.asarray(y), inverse,
                                 scale)
    got = to_np(zr) + 1j * to_np(zi)
    assert _err(got, np.asarray(wr) + 1j * np.asarray(wi)) < TOL
    z = x.astype(np.float64) + 1j * y
    want = (np.fft.ifft(z, axis=-2) * shape[1] if inverse
            else np.fft.fft(z, axis=-2)) * scale
    assert _err(got, want) < TOL


@pytest.mark.parametrize("shape", [(2, 64, 65),      # ragged n1
                                   (3, 80, 40),      # radix 5
                                   (1, 16, 1),
                                   (2, 3, 48, 24)])  # leading axes
def test_colfft_matches_numpy(shape):
    x, y = _pair(shape, seed=7)
    n0 = shape[-2]
    zr, zi = colfft.scolfft(torch.as_tensor(x), torch.as_tensor(y))
    assert zr.shape == shape and zi.shape == shape
    want = np.fft.fft(x.astype(np.float64) + 1j * y, axis=-2)
    assert _err(to_np(zr) + 1j * to_np(zi), want) < TOL
    br, bi = colfft.scolfft(zr, zi, inverse=True, scale=1.0 / n0)
    assert np.abs(to_np(br) - x).max() < 5e-5
    assert np.abs(to_np(bi) - y).max() < 5e-5


def test_colfft_takes_a_moved_view():
    x, y = _pair((2, 40, 64), seed=9)
    xt = torch.as_tensor(x).transpose(-1, -2)          # (2, 64, 40) view
    yt = torch.as_tensor(y).transpose(-1, -2)
    zr, zi = colfft.scolfft(xt, yt)
    want = np.fft.fft(np.swapaxes(x + 1j * y, -1, -2), axis=-2)
    assert _err(to_np(zr) + 1j * to_np(zi), want) < TOL


# ------------------------------------------------- K9 against the cores

@pytest.mark.parametrize("shape", [(2, 64, 128), (4, 80, 128)])
@pytest.mark.parametrize("t", [2, 3])
def test_coldct_plain_matches_reference_core(shape, t):
    x = real_input(shape, np.float32, seed=shape[1] + t)
    n = shape[1]
    mine = colfft.coldct2_plain if t == 2 else colfft.coldct3_plain
    ref = jdct._coldct2_core if t == 2 else jdct._coldct3_core
    got = to_np(mine(torch.as_tensor(x), n))
    assert _err(got, np.asarray(ref(jnp.asarray(x), n))) < TOL
    # and the last-axis core on the transposed images
    core = jdct._dct2_core if t == 2 else jdct._dct3_core
    want = np.swapaxes(np.asarray(core(
        jnp.asarray(np.swapaxes(x, -1, -2).astype(np.float64)), n)), -1, -2)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("t", [2, 3])
def test_scoldct_weight_and_scale(t):
    """scale * w * dct2(x), scale * dct3(w * x): the contract the kernel
    fuses."""
    x = torch.as_tensor(real_input((2, 3, 48, 33), np.float32, seed=t))
    w = torch.as_tensor(real_input((48,), np.float32, seed=5))
    got = colfft.scoldct(x, t, w, 0.125)
    if t == 2:
        want = 0.125 * w[:, None] * colfft.coldct2_plain(x, 48)
    else:
        want = 0.125 * colfft.coldct3_plain(x * w[:, None], 48)
    assert got.shape == x.shape
    assert _err(to_np(got), to_np(want)) < 1e-6
    assert torch.equal(colfft.scoldct(x, t),
                       (colfft.coldct2_plain if t == 2
                        else colfft.coldct3_plain)(x, 48))


# ------------------------------------------------- the wrappers' contract

def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros((2, 64, 8))
    with pytest.raises(TypeError, match="float32"):
        colfft.scolfft(x.double(), x.double())
    with pytest.raises(TypeError, match="float32"):
        colfft.scoldct(x.double(), 2)
    bad = torch.zeros((2, 24, 8))
    with pytest.raises(ValueError, match="n0=24"):
        colfft.scolfft(bad, bad)
    with pytest.raises(ValueError, match="n0=24"):
        colfft.scoldct(bad, 3)
    with pytest.raises(ValueError, match="even"):
        colfft.scoldct(torch.zeros((3, 64, 8)), 2)
    with pytest.raises(ValueError, match="type 2 or 3"):
        colfft.scoldct(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        colfft._launch("fwd", x, x)                             # CPU tensors
    with pytest.raises(ValueError, match="mode"):
        colfft._launch("bogus", x, x)
    meta = torch.empty((2, 64, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        colfft.scolfft(meta, meta)                              # no fallback
    with pytest.raises(ValueError, match="CUDA"):
        colfft.scoldct(meta, 2)
    assert colfft.launches == {"K6": 0, "K9": 0}


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for b, n0, n1 in ((3, 48, 128), (2, 80, 65), (2, 1024, 513),
                      (2, 4096, 40)):
        x, y = (torch.as_tensor(a, device="cuda")
                for a in _pair((b, n0, n1), seed=n0))
        for inverse in (False, True):
            zr, zi = colfft.scolfft(x, y, inverse, 0.25)
            pr, pi = colfft.colfft_plain(x.cpu(), y.cpu(), inverse, 0.25)
            assert _err(to_np(zr) + 1j * to_np(zi),
                        to_np(pr) + 1j * to_np(pi)) < 1e-5
        x2 = x[:2]
        w = torch.rand(n0, device="cuda") + 0.5
        for t in (2, 3):
            assert _err(to_np(colfft.scoldct(x2, t, w, 0.5)),
                        to_np(colfft.scoldct(x2.cpu(), t, w.cpu(), 0.5))
                        ) < 1e-5, (n0, t)
        torch.cuda.synchronize()
