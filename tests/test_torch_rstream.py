"""K7 (the real-stream transforms) and K8 (the DCT-IV stream tail): the
plain versions against the functions they replace, and the routes that
reach them.

``cfftpack_tpu.ops.pallas_rstream`` runs in interpret mode on the CPU,
as tests/test_pallas.py runs it; the port's wrappers take their plain
PyTorch versions on CPU tensors.  The bar is the reference's own in
test_pallas.py: 5e-6 of max |X|.  The CUDA kernels themselves are
checked on the card (``-m cuda`` here, and chip_smoke.py).
"""
import importlib

import numpy as np
import pytest
import scipy.fft
import torch
import jax.numpy as jnp

import cfftpack_tpu.ops.core as jcore
import cfftpack_tpu.ops.pallas_rstream as jrs

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch.config import VALID_NORMS
from cfftpack_tpu_torch.ops import core, fused_fft, rstream as rs
from cfftpack_tpu_torch.utils import profiling

from torch_parity import real_input, to_np

jdct = importlib.import_module("cfftpack_tpu.ops.dct")
pdct = importlib.import_module("cfftpack_tpu_torch.ops.dct")

torch.set_num_threads(1)

TOL = 5e-6


def _err(got, want) -> float:
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def k1_small(monkeypatch):
    """K1 held to n <= 512, so the real-stream gates (a half length past
    K1) open at test sizes."""
    monkeypatch.setattr(fused_fft, "_SMEM_BUDGET", 8192)


def _spy(monkeypatch, mod, name, calls=None):
    """Record each call of ``mod.<name>`` by name in ``calls``."""
    calls = [] if calls is None else calls
    real = getattr(mod, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, name, spy)
    return calls


# ------------------------------------------------- eligibility, tables

def test_eligibility_matches_reference():
    lengths = list(range(128, (1 << 20) + 1, 640)) + [1, 64, 1000, 2048]
    for n in lengths:
        for b in (1, 2, 3, 4, 64):
            assert (rs.rstream_eligible(n, torch.float32, b)
                    == jrs.rstream_eligible(n, np.float32, b)), (n, b)
    assert not rs.rstream_eligible(2048, torch.float64, 4)


@pytest.mark.parametrize("n", [2048, 6144, 65536, 524288])
def test_phase_table_matches_reference(n):
    for a, b in zip(rs._dct_phase_perm(n), jrs._dct_phase_perm(n)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_gates():
    f32, f64 = torch.float32, torch.float64
    assert core._use_rstream(30720, 2, f32)            # the first length
    assert core._use_rstream(65536, 64, f32)
    assert not core._use_rstream(28672, 2, f32)        # K1 takes 14336
    assert not core._use_rstream(65536, 63, f32)       # odd batch
    assert not core._use_rstream(65536, 64, f64)
    assert not core._use_rstream(1 << 20, 8, f32)      # past the cap
    assert pdct._dct4_stream_ok(32768, f32)            # h = 16384
    assert not pdct._dct4_stream_ok(16384, f32)        # K1 takes 8192
    assert not pdct._dct4_stream_ok(32768, f64)
    assert not pdct._dct4_stream_ok(32770, f32)


# ------------------------------------------------- helpers

@pytest.mark.parametrize("m", [16, 48])
def test_mirror_and_merge_match_reference(m):
    r = np.random.default_rng(m)
    Zr = r.standard_normal((3, m, 128)).astype(np.float32)
    Zi = r.standard_normal((3, m, 128)).astype(np.float32)
    got = rs._mirror_perm(torch.as_tensor(Zr))
    assert np.array_equal(to_np(got), np.asarray(jrs._mirror_perm(
        jnp.asarray(Zr))))
    for a, b in zip(rs._merge_uv(torch.as_tensor(Zr), torch.as_tensor(Zi)),
                    jrs._merge_uv(jnp.asarray(Zr), jnp.asarray(Zi))):
        assert np.array_equal(to_np(a), np.asarray(b))
    assert np.array_equal(to_np(rs._nat_low(torch.as_tensor(Zr), m)),
                          np.asarray(jrs._nat_low(jnp.asarray(Zr), m)))


# ------------------------------------------------- K7 against Pallas

@pytest.mark.parametrize("n", [2048, 6144])       # m = 16, 48 (radix 3)
def test_rfft_irfft_match_pallas(n):
    x = real_input((4, n), np.float32, seed=n)
    yr, yi = rs.srfft_stream(torch.as_tensor(x), n)
    wr, wi = jrs.srfft_stream_pallas(jnp.asarray(x), n)
    got = to_np(yr) + 1j * to_np(yi)
    assert _err(got, np.asarray(wr) + 1j * np.asarray(wi)) < TOL
    assert _err(got, np.fft.rfft(x.astype(np.float64))) < TOL
    # the packed contract: imag(DC) and imag(Nyquist) are exact zeros
    assert not to_np(yi)[:, 0].any() and not to_np(yi)[:, -1].any()
    back = rs.sirfft_stream(yr, yi, n)
    want = jrs.sirfft_stream_pallas(wr, wi, n)
    assert _err(to_np(back), np.asarray(want)) < TOL
    assert np.abs(to_np(back) / n - x).max() < 5e-5


@pytest.mark.parametrize("n", [2048, 6144])
def test_dct2_dct3_match_pallas(n):
    x = real_input((4, n), np.float32, seed=n + 1)
    for mine, ref in ((rs.sdct2_stream, jrs.sdct2_stream_pallas),
                      (rs.sdct3_stream, jrs.sdct3_stream_pallas)):
        got = mine(torch.as_tensor(x), n)
        assert _err(to_np(got), np.asarray(ref(jnp.asarray(x), n))) < TOL


def test_wrappers_keep_leading_axes():
    n = 2048
    x = real_input((2, 2, n), np.float32, seed=3)
    yr, yi = rs.srfft_stream(torch.as_tensor(x), n)
    assert yr.shape == (2, 2, n // 2 + 1) and yi.shape == yr.shape
    assert rs.sirfft_stream(yr, yi, n).shape == (2, 2, n)
    assert rs.sdct2_stream(torch.as_tensor(x), n).shape == (2, 2, n)
    assert rs.sdct3_stream(torch.as_tensor(x), n).shape == (2, 2, n)


# ------------------------------------------------- K8 against the tail

def test_dct4_stream_tail_matches_reference():
    n = 4096                      # h = 2048: a stream length
    h = n // 2
    x = real_input((4, n), np.float32, seed=57)
    p = np.arange(h)
    pre = np.exp(-1j * np.pi * p / n)
    post = np.exp(-1j * np.pi * (2 * p + 0.5) / (2 * n))
    cr = x[:, 0::2]
    ci = x[:, ::-1][:, 0::2]
    prer = pre.real.astype(np.float32)
    prei = pre.imag.astype(np.float32)
    wr = cr * prer - ci * prei
    wi = cr * prei + ci * prer
    want = np.asarray(jdct._dct4_stream_tail(jnp.asarray(wr), jnp.asarray(wi),
                                             n, post))
    got = pdct._dct4_stream_tail(torch.as_tensor(wr), torch.as_tensor(wi), n,
                                 pdct._tab("dct4_post_perm", n,
                                           torch.as_tensor(x)))
    assert _err(to_np(got), want) < TOL
    # the whole of K8's plain version (pre-rotation included) against the
    # reference's DCT-IV core
    full = pdct._dct4_stream(torch.as_tensor(x), n)
    assert _err(to_np(full), np.asarray(jdct._dct4_core(jnp.asarray(x), n))
                ) < TOL


@pytest.mark.parametrize("n", [4096, 65536])
def test_dct4_tables(n):
    h = n // 2
    m = h // 128
    pre_mine, post_mine = pdct._dct4_phases(n)
    ppr, ppi = pdct._dct4_post_perm(n)
    p = np.arange(h)
    pre = np.exp(-1j * np.pi * p / n)
    post = np.exp(-1j * np.pi * (2 * p + 0.5) / (2 * n))
    k2 = np.arange(m)[:, None]
    k1 = np.arange(128)[None, :]
    pp = post[(k2 + m * k1).reshape(-1)].reshape(m, 128)  # reference layout
    assert np.array_equal(pre_mine, pre) and np.array_equal(post_mine, post)
    assert np.array_equal(ppr, pp.real) and np.array_equal(ppi, pp.imag)


# ------------------------------------------------- the routes

def test_srfft_sirfft_take_k7(monkeypatch, k1_small):
    fwd = _spy(monkeypatch, rs, "srfft_stream")
    inv = _spy(monkeypatch, rs, "sirfft_stream")
    n = 2048
    x = real_input((2, 2, n), np.float32, seed=71)
    yr, yi = core.srfft(torch.as_tensor(x), n)
    wr, wi = jcore.srfft(jnp.asarray(x), n)
    assert _err(to_np(yr) + 1j * to_np(yi),
                np.asarray(wr) + 1j * np.asarray(wi)) < TOL
    back = core.sirfft(yr, yi, n)
    assert _err(to_np(back), np.asarray(jcore.sirfft(wr, wi, n))) < TOL
    assert fwd == ["srfft_stream"] and inv == ["sirfft_stream"]


@pytest.mark.parametrize("name,core_name", [("sdct2_stream", "_dct2_core"),
                                            ("sdct3_stream", "_dct3_core")])
def test_dct_cores_take_k7(monkeypatch, k1_small, name, core_name):
    calls = _spy(monkeypatch, rs, name)
    n = 6144
    x = real_input((4, n), np.float32, seed=72)
    got = getattr(pdct, core_name)(torch.as_tensor(x), n)
    want = getattr(jdct, core_name)(jnp.asarray(x), n)
    assert _err(to_np(got), np.asarray(want)) < TOL
    assert calls == [name]


@pytest.mark.parametrize("core_name", ["_dct4_core", "_dst4_core"])
def test_dct4_cores_take_k8(monkeypatch, k1_small, core_name):
    calls = _spy(monkeypatch, pdct, "_dct4_stream")
    n = 4096
    x = real_input((3, n), np.float32, seed=73)
    got = getattr(pdct, core_name)(torch.as_tensor(x), n)
    want = getattr(jdct, core_name)(jnp.asarray(x), n)
    assert _err(to_np(got), np.asarray(want)) < TOL
    assert calls == ["_dct4_stream"]


@pytest.mark.parametrize("n", [4096, 65536])
def test_dst4_matches_reference_and_scipy(k1_small, n):
    """DST-IV on K8's route (the flip and sign are K8's flag, its plain
    version on the CPU) against the JAX package's _dst4_core and scipy,
    unscaled and with a scale."""
    x = real_input((4, n), np.float32, seed=n + 75)
    got = pdct._dst4_core(torch.as_tensor(x), n)
    want = np.asarray(jdct._dst4_core(jnp.asarray(x), n))
    assert _err(to_np(got), want) < TOL
    sp = scipy.fft.dst(x.astype(np.float64), 4) / 2
    assert _err(to_np(got), sp) < TOL
    half = pdct._dst4_core(torch.as_tensor(x), n, 0.5)
    assert _err(to_np(half), 0.5 * sp) < TOL


def _type4_scale(fn: str, norm: str, n: int) -> float:
    """The scale of type 4 under ``norm``: the forward's fftpack and
    forward norms and the inverse's backward norm carry 2/n, ortho
    sqrt(2/n) both ways."""
    if norm == "ortho":
        return float(np.sqrt(2.0 / n))
    full = (norm in ("fftpack", "forward")) != fn.startswith("i")
    return 2.0 / n if full else 1.0


@pytest.mark.parametrize("fn", ["dct", "idct", "dst", "idst"])
@pytest.mark.parametrize("norm", VALID_NORMS)
def test_type4_hands_its_norm_to_k8(monkeypatch, k1_small, fn, norm):
    """dct/idct/dst/idst type 4 on K8's route: one _dct4_stream call with
    the norm's scale and the DST flag, its result returned as it is (no
    flip, sign or multiply after), scipy's values."""
    got = []
    real = pdct._dct4_stream

    def spy(x, n, scale=1.0, dst=False):
        out = real(x, n, scale, dst)
        got.append((scale, dst, out))
        return out

    monkeypatch.setattr(pdct, "_dct4_stream", spy)
    n = 4096
    x = real_input((3, n), np.float32, seed=76)
    y = getattr(pt, fn)(torch.as_tensor(x), 4, norm=norm)
    assert len(got) == 1
    scale, dst, out = got[0]
    assert dst == fn.endswith("st")
    assert scale == pytest.approx(_type4_scale(fn, norm, n))
    assert torch.equal(y, out)
    sp = getattr(scipy.fft, fn.lstrip("i"))(x.astype(np.float64), 4) / 2
    assert _err(to_np(y), sp * scale) < TOL


def test_other_shapes_stay_off_k7_and_k8(monkeypatch):
    calls = _spy(monkeypatch, rs, "srfft_stream")
    _spy(monkeypatch, rs, "sdct2_stream", calls)
    _spy(monkeypatch, pdct, "_dct4_stream", calls)
    f32 = np.float32
    core.srfft(torch.as_tensor(real_input((3, 65536), f32, 1)), 65536)
    core.srfft(torch.zeros((2, 65536), dtype=torch.float64), 65536)
    core.srfft(torch.zeros((2, 16384)), 16384)      # K1 takes 8192
    pdct._dct2_core(torch.zeros((3, 32768)), 32768)  # odd batch
    pdct._dct4_core(torch.zeros((1, 16384)), 16384)  # K1 takes 8192
    assert calls == []


def test_public_rfft_split_reaches_k7(monkeypatch):
    import cfftpack_tpu as jt
    import cfftpack_tpu_torch as pt
    calls = _spy(monkeypatch, rs, "srfft_stream")
    _spy(monkeypatch, rs, "sirfft_stream", calls)
    n = 30720                                       # m = 240
    x = real_input((2, n), np.float32, seed=74)
    yr, yi = pt.rfft_split(torch.as_tensor(x), norm="ortho")
    wr, wi = jt.rfft_split(x, norm="ortho")
    assert _err(to_np(yr) + 1j * to_np(yi),
                np.asarray(wr) + 1j * np.asarray(wi)) < TOL
    back = pt.irfft_split(yr, yi, n, norm="ortho")
    assert np.abs(to_np(back) - x).max() < 5e-5
    assert calls == ["srfft_stream", "sirfft_stream"]


# ------------------------------------------------- the launch contract

def test_launch_refuses_what_the_kernel_does_not_take():
    n = 2048
    x = torch.zeros((2, n))
    with pytest.raises(ValueError, match="CUDA"):
        rs.launch("rfft", n, x)                                 # CPU tensor
    with pytest.raises(TypeError, match="float32"):
        rs.launch("dct2", n, x.double())
    with pytest.raises(ValueError, match="mode"):
        rs.launch("bogus", n, x)
    with pytest.raises(ValueError, match="im plane"):
        rs.launch("irfft", n, torch.zeros((2, n // 2 + 1)))      # no xi
    meta = torch.empty((2, n), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rs.srfft_stream(meta, n)                                # no fallback
    with pytest.raises(ValueError, match="CUDA"):
        rs.sdct3_stream(meta, n)
    with pytest.raises(ValueError, match="CUDA"):
        pdct._dct4_stream(torch.empty((2, 2 * n), device="meta"), 2 * n)
    assert {k: profiling.launches[k] for k in ("K7", "K8")} == {"K7": 0,
                                                                "K8": 0}


def test_launch_refuses_dst_and_w0_where_the_mode_takes_none():
    x = torch.zeros((2, 4096))
    with pytest.raises(ValueError, match="dst"):
        rs.launch("dct2", 4096, x, dst=True)
    with pytest.raises(ValueError, match="w0"):
        rs.launch("dct4", 4096, x, w0=2.0)
    assert {k: profiling.launches[k] for k in ("K7", "K8")} == {"K7": 0,
                                                                "K8": 0}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for n, B in ((2048, 4), (6144, 6), (65536, 8)):
        x = torch.as_tensor(real_input((B, n), np.float32, seed=n),
                            device="cuda")
        xc = x.cpu()
        yr, yi = rs.launch("rfft", n, x)
        pr, pi = rs._rfft_plain(xc, n)
        assert _err(to_np(yr) + 1j * to_np(yi), to_np(pr) + 1j * to_np(pi)
                    ) < 1e-5
        assert not to_np(yi)[:, 0].any() and not to_np(yi)[:, -1].any()
        assert _err(to_np(rs.launch("irfft", n, yr, yi)),
                    to_np(rs._irfft_plain(pr, pi, n))) < 1e-5
        for mode, plain in (("dct2", rs._dct2_plain),
                            ("dct3", rs._dct3_plain)):
            assert _err(to_np(rs.launch(mode, n, x)),
                        to_np(plain(xc, n))) < 1e-5, (n, mode)
        # K8 runs the half length: two rows as one of 2n, n a stream length
        x4 = x.reshape(-1, 2 * n)
        assert _err(to_np(pdct._dct4_stream(x4, 2 * n)),
                    to_np(pdct._dct4_stream(x4.cpu(), 2 * n))) < 1e-5
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256, 512, 1024, 48])
def test_k8_matches_plain_on_card(m):
    """K8's dct4 and dst4 with a scale on the cluster at every m it
    takes (the stage loop, the wrapper flipping and scaling, at m = 48)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n = 256 * m
    x = torch.as_tensor(real_input((3, n), np.float32, seed=m),
                        device="cuda")
    for dst in (False, True):
        before = profiling.launches["K8"]
        y = rs.launch("dct4", n, x, scale=0.25, dst=dst)
        assert profiling.launches["K8"] == before + 1
        want = pdct._dct4_stream_plain(x, n, 0.25, dst)
        torch.cuda.synchronize()
        assert _err(to_np(y), to_np(want)) < 1e-5, (m, dst)

