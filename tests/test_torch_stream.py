"""The stream kernels' plain versions (K2, K3, K4 and the K5 split)
against the Pallas functions they replace.

``cfftpack_tpu.ops.pallas_stream`` runs in interpret mode on the CPU,
as tests/test_pallas.py runs it; the port's wrappers take their plain
PyTorch versions on CPU tensors.  The bar is the reference's own in
test_pallas.py: 5e-6 of max |X|.  The CUDA kernels themselves are
checked on the card (``-m cuda`` here, and chip_smoke.py).
"""
import contextlib
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import cfftpack_tpu as jt
import cfftpack_tpu.ops.pallas_stream as ps

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch.config import fwd_scale, inv_scale
from cfftpack_tpu_torch.ops import fused_fft
from cfftpack_tpu_torch.ops import stream_fft as sf
from cfftpack_tpu_torch.utils import profiling

from torch_parity import complex_input, real_input, to_np

torch.set_num_threads(1)

TOL = 5e-6


def _err(got, want) -> float:
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(shape, seed):
    x = complex_input(shape, np.complex64, seed=seed)
    return x.real.copy(), x.imag.copy()


def _both(fn_port, fn_ref, xr, xi, *args):
    """Run the port on torch tensors and the reference on jax arrays;
    return both results as complex numpy arrays."""
    yr, yi = fn_port(torch.as_tensor(xr), torch.as_tensor(xi), *args)
    wr, wi = fn_ref(jnp.asarray(xr), jnp.asarray(xi), *args)
    return (to_np(yr) + 1j * to_np(yi),
            np.asarray(wr) + 1j * np.asarray(wi))


def _filter(n: int, seed: int):
    """A packed filter with real DC and Nyquist bins (the rfft of a real
    filter) and its full conjugate-symmetric extension, float32."""
    h = n // 2
    F = complex_input((h + 1,), np.complex128, seed=seed)
    F[0] = F[0].real
    F[-1] = F[-1].real
    fr = F.real.astype(np.float32)
    fi = F.imag.astype(np.float32)
    ffr = np.concatenate([fr, fr[1:h][::-1]])
    ffi = np.concatenate([fi, -fi[1:h][::-1]])
    return fr, fi, ffr, ffi


@pytest.fixture
def small_cap(monkeypatch):
    """_MAX_M = 16 in both packages, so the split engages at test sizes."""
    monkeypatch.setattr(ps, "_MAX_M", 16)
    monkeypatch.setattr(sf, "_MAX_M", 16)


# ------------------------------------------------- eligibility, tables

def test_eligibility_matches_reference():
    lengths = list(range(128, (1 << 22) + 1, 128))
    lengths += [1, 2, 64, 100, 960, 1000, 2047, (1 << 22) + 128, 1 << 23]
    for n in lengths:
        assert (sf.stream_eligible(n, torch.float32)
                == ps.stream_pallas_eligible(n, np.float32)), n
        assert sf._filter_split_factor(n) == ps._filter_split_factor(n), n
    for m in range(0, 4200):
        assert sf._stage_ok(m) == (ps._stage_plan(m) is not None), m
    for n in (2048, 65536):
        assert not sf.stream_eligible(n, torch.float64)
        assert not sf.stream_filter_eligible(n, torch.float64)
        assert sf.stream_filter_eligible(n, torch.float32)
    assert sf._filter_split_factor(1 << 20) == 2
    assert sf._filter_split_factor(1 << 21) == 4


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2048, 6144, 10240, 65536])
def test_outer_twiddle_matches_reference(n, inverse):
    mine = sf._tables(n, inverse)
    ref = ps._tables(n, inverse)[2:4]
    for a, b in zip(mine, ref):
        assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("n,s", [(4096, 2), (8192, 4), (1 << 20, 2)])
def test_split_twiddle_matches_reference(n, s):
    for a, b in zip(sf._split_twiddle(n, s), ps._split_twiddle(n, s)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_column_lanes_fit_shared_memory():
    for m in (16, 32, 128, 512, 768, 1024, 2048, 4096):
        lanes = sf._col_lanes(m)
        assert lanes & (lanes - 1) == 0 and 128 % lanes == 0
        assert 16 * m * lanes <= sf._SMEM_BUDGET
    assert sf._col_lanes(4096) == 2 and sf._col_lanes(128) == 32
    assert sf._col_lanes(512) == 8


# ------------------------------------------------- K2, K3: the transforms

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("batch", [3, 5])
@pytest.mark.parametrize("n", [2048, 4096, 6144, 10240])   # m=16,32,48,80
def test_stream_matches_pallas(n, batch, inverse):
    xr, xi = _pair((batch, n), seed=n + batch + inverse)
    got, want = _both(sf.sfft_stream_permuted, ps.sfft_stream_pallas_permuted,
                      xr, xi, n, inverse)
    assert _err(got, want) < TOL                       # K2
    got, want = _both(sf.sfft_stream, ps.sfft_stream_pallas, xr, xi, n,
                      inverse)
    assert _err(got, want) < TOL                       # K3


def test_permuted_layout():
    """perm[.., k2, k1] == X[k2 + m*k1], as the reference pins it."""
    n, m = 2048, 16
    xr, xi = _pair((3, n), seed=1)
    pr, pi = sf.sfft_stream_permuted(torch.as_tensor(xr), torch.as_tensor(xi),
                                     n, False)
    X = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    perm = (to_np(pr) + 1j * to_np(pi)).reshape(3, m, 128)
    assert _err(perm, X.reshape(3, 128, m).transpose(0, 2, 1)) < TOL


# ------------------------------------------------- K4: the filter

def test_filter_matches_pallas():
    n = 2048
    x = real_input((4, n), np.float32, seed=21)
    _, _, ffr, ffi = _filter(n, seed=22)
    got = sf.sfilter_stream(torch.as_tensor(x), torch.as_tensor(ffr),
                            torch.as_tensor(ffi), n)
    want = ps.sfilter_stream_pallas(jnp.asarray(x), jnp.asarray(ffr),
                                    jnp.asarray(ffi), n)
    assert _err(to_np(got), np.asarray(want)) < TOL


def test_filter_odd_batch_rejected():
    f = torch.zeros(2048)
    with pytest.raises(ValueError, match="even"):
        sf.sfilter_stream(torch.zeros((3, 2048)), f, f, 2048)


# ------------------------------------------------- K5: the split

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,s", [(4096, 2), (8192, 4)])
def test_split_matches_pallas(small_cap, n, s, inverse):
    assert sf._filter_split_factor(n) == ps._filter_split_factor(n) == s
    xr, xi = _pair((3, n), seed=n + inverse)
    got, want = _both(sf.sfft_stream_split, ps.sfft_stream_split, xr, xi, n,
                      inverse)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("n", [4096, 8192])
def test_split_filter_matches_pallas(small_cap, n):
    x = real_input((4, n), np.float32, seed=n + 31)
    _, _, ffr, ffi = _filter(n, seed=n + 32)
    got = sf.sfilter_stream(torch.as_tensor(x), torch.as_tensor(ffr),
                            torch.as_tensor(ffi), n)
    want = ps.sfilter_stream_pallas(jnp.asarray(x), jnp.asarray(ffr),
                                    jnp.asarray(ffi), n)
    assert _err(to_np(got), np.asarray(want)) < TOL


@functools.lru_cache(maxsize=None)
def _split_reference(n: int, inverse: bool):
    """The Pallas split route in interpret mode on a seeded (3, n) pair,
    once per (n, direction): (input, unscaled output)."""
    xr, xi = _pair((3, n), seed=n + 7 * inverse)
    with _cap(16):
        wr, wi = ps.sfft_stream_split(jnp.asarray(xr), jnp.asarray(xi), n,
                                      inverse)
    return (xr, xi), np.asarray(wr) + 1j * np.asarray(wi)


@contextlib.contextmanager
def _cap(m: int):
    old = ps._MAX_M
    ps._MAX_M = m
    try:
        yield
    finally:
        ps._MAX_M = old


@pytest.mark.parametrize("norm", ["fftpack", "ortho", "backward", "forward"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,s", [(4096, 2), (8192, 4)])
def test_split_modes_match_pallas(small_cap, n, s, inverse, norm):
    """K5's plain version (mode split, or split_inv as the conjugated
    forward) with the norm's scale in it, against the Pallas route times
    the same scale."""
    (xr, xi), want = _split_reference(n, inverse)
    scale = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    yr, yi = sf.stream_plain(torch.as_tensor(xr), torch.as_tensor(xi), n,
                             "split_inv" if inverse else "split", scale=scale)
    assert _err(to_np(yr) + 1j * to_np(yi), want * scale) < TOL


@pytest.mark.parametrize("n", [4096, 8192])
def test_split_conj_mode_with_filter(small_cap, n):
    """Mode split_conj: conj(scale * fft(x) * F), F natural n bins, into
    given output planes with a row stride (the filter route's layout)."""
    xr, xi = _pair((2, n), seed=n + 3)
    F = complex_input((n,), np.complex64, seed=n + 4)
    out = torch.zeros((2, 2, n))
    sf.stream_plain(torch.as_tensor(xr), torch.as_tensor(xi), n, "split_conj",
                    torch.as_tensor(F.real.copy()),
                    torch.as_tensor(F.imag.copy()), scale=0.5,
                    out=(out[:, 0], out[:, 1]))
    want = np.conj(0.5 * np.fft.fft(xr.astype(np.float64) + 1j * xi) * F)
    assert _err(to_np(out[:, 0]) + 1j * to_np(out[:, 1]), want) < TOL


@pytest.mark.parametrize("n", [4096, 8192])
def test_split_scale_is_the_unscaled_result_times_the_scale(small_cap, n):
    xr, xi = (torch.as_tensor(v) for v in _pair((2, n), seed=n + 5))
    for inverse in (False, True):
        ur, ui = sf.sfft_stream_split(xr, xi, n, inverse)
        yr, yi = sf.sfft_stream_split(xr, xi, n, inverse, scale=0.125)
        assert torch.allclose(yr, ur * 0.125, rtol=1e-6, atol=1e-6)
        assert torch.allclose(yi, ui * 0.125, rtol=1e-6, atol=1e-6)


# ------------------------------------------------- the public routes

def _spy(monkeypatch, name, n_at=2):
    """Record the length (positional argument ``n_at``) of each call of
    ``stream_fft.<name>``."""
    calls = []
    real = getattr(sf, name)

    def spy(*args, **kwargs):
        calls.append(args[n_at])
        return real(*args, **kwargs)

    monkeypatch.setattr(sf, name, spy)
    return calls


def test_fft_split_takes_the_stream_route(monkeypatch):
    calls = _spy(monkeypatch, "sfft_stream")
    n = 32768
    xr, xi = _pair((2, n), seed=41)
    for mine, ref in ((pt.fft_split, jt.fft_split),
                      (pt.ifft_split, jt.ifft_split)):
        yr, yi = mine(torch.as_tensor(xr), torch.as_tensor(xi), norm="ortho")
        wr, wi = ref(xr, xi, norm="ortho")
        assert _err(to_np(yr) + 1j * to_np(yi),
                    np.asarray(wr) + 1j * np.asarray(wi)) < TOL
    assert calls == [n, n]


def test_fft_split_takes_the_split_route(monkeypatch):
    """With the cap at 16 rows and K1 held to n <= 512, n = 8192 has no
    unsplit stream length and splits 4 ways."""
    monkeypatch.setattr(sf, "_MAX_M", 16)
    monkeypatch.setattr(fused_fft, "_SMEM_BUDGET", 8192)
    calls = _spy(monkeypatch, "sfft_stream_split")
    n = 8192
    xr, xi = _pair((2, n), seed=43)
    for mine, ref in ((pt.fft_split, jt.fft_split),
                      (pt.ifft_split, jt.ifft_split)):
        yr, yi = mine(torch.as_tensor(xr), torch.as_tensor(xi))
        wr, wi = ref(xr, xi)
        assert _err(to_np(yr) + 1j * to_np(yi),
                    np.asarray(wr) + 1j * np.asarray(wi)) < TOL
    assert calls == [n, n]


@pytest.mark.parametrize("norm", ["ortho", "forward"])
def test_fft_split_scale_rides_in_the_split(monkeypatch, norm):
    """fft_split at a K5 length hands its norm scale to the split, whose
    result is the unscaled one times the scale."""
    monkeypatch.setattr(sf, "_MAX_M", 16)
    monkeypatch.setattr(fused_fft, "_SMEM_BUDGET", 8192)
    scales = []
    real = sf.sfft_stream_split

    def spy(xr, xi, n, inverse, scale=1.0):
        scales.append(scale)
        return real(xr, xi, n, inverse, scale)

    monkeypatch.setattr(sf, "sfft_stream_split", spy)
    n = 8192
    xr, xi = (torch.as_tensor(v) for v in _pair((2, n), seed=47))
    yr, yi = pt.fft_split(xr, xi, norm=norm)
    ur, ui = pt.fft_split(xr, xi, norm="backward")
    s = fwd_scale(norm, n)
    assert scales == [s, 1.0]
    assert torch.allclose(yr, ur * s, rtol=1e-6, atol=1e-7)
    assert torch.allclose(yi, ui * s, rtol=1e-6, atol=1e-7)


def test_rfilter_split_takes_the_stream_route(monkeypatch):
    calls = _spy(monkeypatch, "sfilter_stream", n_at=3)
    n = 65536
    x = real_input((2, n), np.float32, seed=51)
    fr, fi, _, _ = _filter(n, seed=52)
    got = pt.rfilter_split(torch.as_tensor(x), torch.as_tensor(fr),
                           torch.as_tensor(fi), norm="ortho")
    want = jt.rfilter_split(x, fr, fi, norm="ortho")
    assert _err(to_np(got), np.asarray(want)) < TOL
    assert calls == [n]


def test_rfilter_split_keeps_other_shapes_off_the_stream_route(monkeypatch):
    calls = _spy(monkeypatch, "sfilter_stream", n_at=3)
    f = torch.zeros(32769)
    pt.rfilter_split(torch.zeros((3, 65536)), f, f)          # odd batch
    pt.rfilter_split(torch.zeros((2, 65536), dtype=torch.float64),
                     f.double(), f.double())                 # float64
    pt.rfilter_split(torch.zeros((2, 65536)), torch.zeros((2, 32769)),
                     torch.zeros((2, 32769)))                # one per row
    g = torch.zeros(8193)
    pt.rfilter_split(torch.zeros((2, 16384)), g, g)          # K1 at 8192
    assert calls == []


# ------------------------------------------------- the wrapper's contract

def test_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    m = 16
    x = torch.zeros((2, m, 128))
    with pytest.raises(ValueError, match="CUDA"):
        sf._launch(x, x, 2048, "fwd")                         # CPU tensor
    with pytest.raises(TypeError, match="float32"):
        sf._launch(x.double(), x.double(), 2048, "fwd")       # float64
    with pytest.raises(ValueError, match="n=1920"):
        sf._launch(x, x, 1920, "fwd")                         # m = 15
    with pytest.raises(ValueError, match="mode"):
        sf._launch(x, x, 2048, "bogus")
    meta = torch.empty((2, m, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sf.sfft_stream_permuted(meta, meta, 2048, False)      # no fallback
    # K2's forward on the cluster (m = 512) and register (2048) routes
    # reads its planes as they lie: past the device check it refuses a
    # non-unit element stride and a row stride below n before any launch
    monkeypatch.setattr(sf, "_check_device", lambda *a: None)
    for m in (512, 2048):
        n = 128 * m
        buf = torch.zeros((2, 2 * n))
        wide = buf[:, ::2].reshape(2, m, 128)           # element stride 2
        tight = buf.as_strided((2, m, 128), (n - 128, 128, 1))
        for bad in (wide, tight):
            with pytest.raises(ValueError, match="row stride"):
                sf._launch(bad, bad, n, "fwd")
    assert {k: profiling.launches[k] for k in ("K2", "K3", "K4", "K5",
                                                "K11")} == {
        "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K11": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for n, b in ((2048, 3), (6144, 5), (65536, 4), (524288, 2)):
        m = n // 128
        for mode in ("fwd", "inv", "fwd_nat", "inv_nat", "filter"):
            shape = (b, 128, m) if mode == "inv_nat" else (b, m, 128)
            x = complex_input(shape, np.complex64, seed=n + b)
            xr = torch.as_tensor(x.real.copy(), device="cuda")
            xi = torch.as_tensor(x.imag.copy(), device="cuda")
            f = (None, None)
            if mode == "filter":
                fc = complex_input((2, m, 128), np.complex64, seed=n)
                f = (torch.as_tensor(fc.real.copy(), device="cuda"),
                     torch.as_tensor(fc.imag.copy(), device="cuda"))
            yr, yi = sf._launch(xr, xi, n, mode, *f)
            pr, pi = sf.stream_plain(xr, xi, n, mode, *f)
            torch.cuda.synchronize()
            assert _err(to_np(yr) + 1j * to_np(yi),
                        to_np(pr) + 1j * to_np(pi)) < 1e-5, (n, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(1 << 20, 2), (786432, 3), (1 << 21, 1),
                                 (1572864, 2)])
def test_split_kernels_match_plain_on_card(n, b):
    """K5 on both of its column passes, the register passes at m = 4096
    (2^20, 2^21) and the stage loop at m = 3072 (s = 2 and 4): every mode,
    with a filter and a scale, against its plain version and torch.fft in
    complex128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x = complex_input((b, n), np.complex64, seed=n + b)
    xr = torch.as_tensor(x.real.copy(), device="cuda")
    xi = torch.as_tensor(x.imag.copy(), device="cuda")
    F = complex_input((n,), np.complex64, seed=n)
    f = (torch.as_tensor(F.real.copy(), device="cuda"),
         torch.as_tensor(F.imag.copy(), device="cuda"))
    x64 = x.astype(np.complex128)
    for mode, filt, scale in (("split", f, 0.5), ("split", None, 1.0),
                              ("split_inv", None, 0.25),
                              ("split_conj", f, 2.0)):
        before = profiling.launches["K5"]
        yr, yi = sf._launch(xr, xi, n, mode, *(filt or (None, None)),
                            scale=scale)
        assert profiling.launches["K5"] == before + 1
        pr, pi = sf.stream_plain(xr, xi, n, mode, *(filt or (None, None)),
                                 scale=scale)
        torch.cuda.synchronize()
        want = (np.fft.ifft(x64) * n if mode == "split_inv"
                else np.fft.fft(x64)) * scale
        if filt is not None:
            want = want * F
        if mode == "split_conj":
            want = np.conj(want)
        got = to_np(yr) + 1j * to_np(yi)
        assert _err(got, to_np(pr) + 1j * to_np(pi)) < 1e-5, (n, mode)
        assert _err(got, want) < 1e-5, (n, mode)
