"""DCT/DST types I-IV of the port against the JAX package and the C
library's golden vectors.

The same seeded numpy inputs go through ``cfftpack_tpu`` (CPU, x64) and
``cfftpack_tpu_torch`` (CPU tensors: K1's, K3's, K7/K8's and K9's plain
versions).  Bars: 1e-12 of max |X| in float64, 1e-4 in float32
(torch_parity.BARS); the golden vectors at tests/test_golden.py's
tolerances.
"""
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cfftpack_tpu as jt
import cfftpack_tpu.ops.core as jcore

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch.ops import core

from torch_parity import bar, real_input, rel_err, to_np

jdct = importlib.import_module("cfftpack_tpu.ops.dct")
pdct = importlib.import_module("cfftpack_tpu_torch.ops.dct")
pcol = importlib.import_module("cfftpack_tpu_torch.ops.colfft")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GOLD = np.load(Path(__file__).parent / "golden" / "golden.npz")
NORMS = ("fftpack", "ortho", "backward")
# odd, n % 4 == 0, n % 4 == 2, and the edges 1 and 2
LENGTHS = (1, 2, 5, 6, 8, 30)
FUNCS = ("dct", "idct", "dst", "idst")


def _gold_tol(n):
    return 1e-12 * max(1.0, n ** 0.5)


# ------------------------------------------------- tables

@pytest.mark.parametrize("n", [2, 6, 8, 30, 1024, 65536])
def test_host_tables_match_reference(n):
    for a, b in zip(pdct._dct2_tables(n), jdct._dct2_tables(n)):
        assert np.array_equal(a, b)
    for ga, gb in zip(pdct._dct3_tables(n), jdct._dct3_tables(n)):
        for a, b in zip(ga, gb):
            assert np.array_equal(a, b)
    for s in (-1.0, 1.0):
        assert np.array_equal(pdct._cexp_half(n, s), jdct._cexp_half(n, s))


@pytest.mark.parametrize("n,m,a,b,nout", [(5, 10, 0.5, 0.5, 5),
                                          (7, 14, 0.5, 0.5, 7),
                                          (6, 16, 0.25, 0.0, 9)])
def test_shifted_dft_real_matches_reference(n, m, a, b, nout):
    for dt in (np.float64, np.float32):
        x = real_input((3, n), dt, seed=n + m)
        yr, yi = core.s_shifted_dft_real(torch.as_tensor(x), n, m, a, b,
                                         nout)
        wr, wi = jcore.s_shifted_dft_real(x, n, m, a, b, nout)
        assert yr.dtype == torch.from_numpy(x).dtype
        assert rel_err(to_np(yr) + 1j * to_np(yi),
                       np.asarray(wr) + 1j * np.asarray(wi)) < bar(dt)


def test_tables_cached_per_device_and_dtype():
    x = torch.zeros(8)
    a = pdct._tab("dct2", 8, x)
    assert pdct._tab("dct2", 8, x) is a
    assert pdct._tab("dct2", 8, x.double())[0].dtype == torch.float64


# ------------------------------------------------- parity with the reference

@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("fn", FUNCS)
def test_matches_reference_f64(fn, t):
    for n in LENGTHS:
        if t == 1 and fn in ("dct", "idct") and n < 2:
            continue
        x = real_input((3, n), np.float64, seed=10 * n + t)
        for norm in NORMS:
            got = getattr(pt, fn)(torch.as_tensor(x), t, norm=norm)
            want = np.asarray(getattr(jt, fn)(x, t, norm=norm))
            assert got.dtype == torch.float64
            assert rel_err(got, want) < 1e-12, (fn, t, n, norm)
        # "forward" is the alias of "fftpack"
        assert torch.equal(getattr(pt, fn)(torch.as_tensor(x), t,
                                           norm="forward"),
                           getattr(pt, fn)(torch.as_tensor(x), t))


@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("fn", FUNCS)
def test_matches_reference_f32(fn, t):
    for n in (6, 30):
        x = real_input((4, n), np.float32, seed=n + t)
        got = getattr(pt, fn)(torch.as_tensor(x), t, norm="ortho")
        want = np.asarray(getattr(jt, fn)(x, t, norm="ortho"))
        assert got.dtype == torch.float32
        assert rel_err(got, want) < 1e-4, (fn, t, n)


@pytest.mark.parametrize("n", [1024, 4096])
def test_large_even_lengths_match_reference(n):
    """K1 at n/2 (dct2/dct3 at 1024: K1 at 512), and the DCT-IV and DST
    paths at a length with every radix stage of the half-length FFT."""
    x = real_input((4, n), np.float32, seed=n)
    for fn, t in (("dct", 2), ("idct", 2), ("dct", 4), ("dst", 3)):
        got = getattr(pt, fn)(torch.as_tensor(x), t)
        want = np.asarray(getattr(jt, fn)(x, t))
        assert rel_err(got, want) < 1e-4, (fn, t)


# ------------------------------------------------- golden vectors

@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 960, 1000, 1250])
def test_dct_dst_pair_golden(n):
    x = torch.as_tensor(GOLD[f"dct_in_{n}"])
    tol = _gold_tol(n)
    np.testing.assert_allclose(pt.dct(x, 3).numpy(), GOLD[f"dct_fwd_{n}"],
                               atol=tol)
    np.testing.assert_allclose(pt.idct(x, 3).numpy(), GOLD[f"dct_inv_{n}"],
                               atol=tol * n)
    np.testing.assert_allclose(pt.dct(x, 3, norm="ortho").numpy(),
                               GOLD[f"dct_fwd_{n}_ortho"], atol=tol)
    np.testing.assert_allclose(pt.idct(x, 3, norm="ortho").numpy(),
                               GOLD[f"dct_inv_{n}_ortho"], atol=tol * n)
    y = torch.as_tensor(GOLD[f"dst_in_{n}"])
    np.testing.assert_allclose(pt.dst(y, 3).numpy(), GOLD[f"dst_fwd_{n}"],
                               atol=tol)
    np.testing.assert_allclose(pt.idst(y, 3).numpy(), GOLD[f"dst_inv_{n}"],
                               atol=tol * n)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 961, 1000])
def test_dct1_golden(n):
    x = torch.as_tensor(GOLD[f"dct1_in_{n}"])
    tol = _gold_tol(n)
    np.testing.assert_allclose(pt.dct(x, 1).numpy(), GOLD[f"dct1_fwd_{n}"],
                               atol=tol)
    np.testing.assert_allclose(pt.idct(x, 1).numpy(), GOLD[f"dct1_inv_{n}"],
                               atol=tol * n)
    np.testing.assert_allclose(pt.dct(x, 1, norm="ortho").numpy(),
                               GOLD[f"dct1_fwd_{n}_ortho"], atol=tol * n)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 959, 999])
def test_dst1_golden(n):
    x = torch.as_tensor(GOLD[f"dst1_in_{n}"])
    tol = _gold_tol(n)
    np.testing.assert_allclose(pt.dst(x, 1).numpy(), GOLD[f"dst1_fwd_{n}"],
                               atol=tol)
    np.testing.assert_allclose(pt.idst(x, 1).numpy(), GOLD[f"dst1_inv_{n}"],
                               atol=tol * n)
    np.testing.assert_allclose(pt.dst(x, 1, norm="ortho").numpy(),
                               GOLD[f"dst1_fwd_{n}_ortho"], atol=tol)


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 60, 960, 1000, 1250])
def test_dct4_dst4_golden(n):
    tol = _gold_tol(n)
    x = torch.as_tensor(GOLD[f"dct4_in_{n}"])
    np.testing.assert_allclose(pt.dct(x, 4).numpy(), GOLD[f"dct4_fwd_{n}"],
                               atol=tol)
    np.testing.assert_allclose(pt.idct(x, 4).numpy(), GOLD[f"dct4_inv_{n}"],
                               atol=tol * n)
    np.testing.assert_allclose(pt.dct(x, 4, norm="ortho").numpy(),
                               GOLD[f"dct4_fwd_{n}_ortho"], atol=tol)
    y = torch.as_tensor(GOLD[f"dst4_in_{n}"])
    np.testing.assert_allclose(pt.dst(y, 4).numpy(), GOLD[f"dst4_fwd_{n}"],
                               atol=tol)
    np.testing.assert_allclose(pt.idst(y, 4).numpy(), GOLD[f"dst4_inv_{n}"],
                               atol=tol * n)
    np.testing.assert_allclose(pt.dst(y, 4, norm="ortho").numpy(),
                               GOLD[f"dst4_fwd_{n}_ortho"], atol=tol)


# ------------------------------------------------- round trips, N-D

@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_round_trips(t, dt):
    for n in (2, 7, 30, 64):
        x = torch.as_tensor(real_input((2, 3, n), dt, seed=n + t))
        for norm in NORMS:
            for fwd, inv in ((pt.dct, pt.idct), (pt.dst, pt.idst)):
                back = inv(fwd(x, t, norm=norm), t, norm=norm)
                assert rel_err(back, x) < 10 * bar(dt), (t, n, norm)


@pytest.mark.parametrize("fn", ["dctn", "idctn", "dstn", "idstn"])
def test_nd_matches_reference(fn):
    x = real_input((2, 12, 10), np.float64, seed=5)
    for t, axes in ((2, (-2, -1)), (3, (-2, -1)), (4, None), (1, 1)):
        got = getattr(pt, fn)(torch.as_tensor(x), t, axes=axes, norm="ortho")
        want = np.asarray(getattr(jt, fn)(x, t, axes=axes, norm="ortho"))
        assert rel_err(got, want) < 1e-12, (t, axes)


@pytest.mark.parametrize("t", [2, 3])
def test_dctn_round_trip_f32(t):
    x = torch.as_tensor(real_input((4, 64, 48), np.float32, seed=t))
    back = pt.idctn(pt.dctn(x, t, axes=(-2, -1)), t, axes=(-2, -1))
    assert rel_err(back, x) < 1e-4


@pytest.mark.parametrize("inverse", [False, True])
def test_dst_along_axis_minus_2_is_the_dst(inverse):
    """dst/idst type 2 along axis -2 equal the transposed last-axis DST
    (the reference's TPU column route computes a DCT there)."""
    fn = pt.idst if inverse else pt.dst
    x = torch.as_tensor(real_input((16, 64, 32), np.float32, seed=9))
    got = fn(x, 2, axis=-2)
    want = fn(x.transpose(-1, -2), 2, axis=-1).transpose(-1, -2)
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * want.abs().max())
    ref = np.asarray((jt.idst if inverse else jt.dst)(x.numpy(), 2, axis=-2))
    assert rel_err(got, ref) < 1e-4
    dct = (pt.idct if inverse else pt.dct)(x, 2, axis=-2)
    assert rel_err(got, dct) > 0.1                 # not the DCT


# ------------------------------------------------- the column route (K9)

def _spy_cores(monkeypatch):
    """Record each call of K9's plain cores by name."""
    calls = []
    for name in ("coldct2_plain", "coldct3_plain"):
        real = getattr(pcol, name)

        def spy(x, n, name=name, real=real):
            calls.append(name)
            return real(x, n)

        monkeypatch.setattr(pcol, name, spy)
    return calls


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("t", [2, 3])
def test_axis_minus_2_takes_the_column_route(monkeypatch, t, norm):
    """dct/idct types 2 and 3 along axis -2 of (2, 64, 128) float32 run
    K9's plain core and equal the last-axis result on the transposed
    input (5e-6 of max |X|, the bar of the reference's own test)."""
    calls = _spy_cores(monkeypatch)
    x = torch.as_tensor(real_input((2, 64, 128), np.float32, seed=71))
    xt = x.transpose(-1, -2).contiguous()
    got = pt.dct(x, t, axis=-2, norm=norm)
    want = pt.dct(xt, t, axis=-1, norm=norm).transpose(-1, -2)
    assert calls == [f"coldct{t}_plain"]
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) / scale < 5e-6
    ref = np.asarray(jt.dct(x.numpy(), t, axis=-2, norm=norm))
    assert rel_err(got, ref) < 1e-4
    back = pt.idct(got, t, axis=-2, norm=norm)
    assert calls == [f"coldct{t}_plain", f"coldct{5 - t}_plain"]
    assert float((back - x).abs().max()) < 5e-5


@pytest.mark.parametrize("t", [2, 3])
def test_dctn_round_trip_takes_the_column_route(monkeypatch, t):
    calls = _spy_cores(monkeypatch)
    x = torch.as_tensor(real_input((2, 3, 48, 40), np.float32, seed=t))
    y = pt.dctn(x, t, axes=(-2, -1), norm="ortho")
    want = np.asarray(jt.dctn(x.numpy(), t, axes=(-2, -1), norm="ortho"))
    assert rel_err(y, want) < 1e-4
    back = pt.idctn(y, t, axes=(-2, -1), norm="ortho")
    assert rel_err(back, x) < 1e-4
    assert sorted(calls) == ["coldct2_plain", "coldct3_plain"]


@pytest.mark.parametrize("shape,dt", [((3, 64, 32), np.float32),    # odd count
                                      ((64, 32), np.float32),       # no batch
                                      ((2, 24, 32), np.float32),    # n0 = 24
                                      ((2, 64, 32), np.float64)])
def test_other_shapes_keep_the_moved_axis(monkeypatch, shape, dt):
    calls = _spy_cores(monkeypatch)
    x = torch.as_tensor(real_input(shape, dt, seed=3))
    got = pt.dct(x, 2, axis=-2, norm="ortho")
    want = pt.dct(x.transpose(-1, -2), 2, axis=-1, norm="ortho")
    assert calls == []
    assert rel_err(got, want.transpose(-1, -2)) < bar(dt)
    assert not pdct._coldct_ok(x, x.shape[-2])


def test_dst_and_other_types_stay_off_the_column_route(monkeypatch):
    calls = _spy_cores(monkeypatch)
    x = torch.as_tensor(real_input((2, 64, 32), np.float32, seed=4))
    assert pdct._coldct_ok(x, 64)
    pt.dst(x, 2, axis=-2)
    pt.idst(x, 3, axis=-2)
    pt.dct(x, 4, axis=-2)
    pt.dct(x, 1, axis=-2)
    pt.dct(x, 2, axis=0)
    assert calls == []


# ------------------------------------------------- the API's edges

def test_errors():
    x = torch.zeros((2, 8))
    with pytest.raises(TypeError, match="real"):
        pt.dct(torch.zeros(8, dtype=torch.complex64))
    for bad in (0, 9):
        with pytest.raises(ValueError, match="1..8"):
            pt.dct(x, bad)
    with pytest.raises(ValueError, match="n >= 2"):
        pt.dct(torch.zeros((2, 1)), 1)
    with pytest.raises(ValueError, match="norm"):
        pt.dst(x, 2, norm="bogus")
    with pytest.raises(ValueError, match="axis"):
        pt.dct(x, 2, axis=2)


def test_input_promotion():
    xi = np.arange(12).reshape(2, 6)
    got = pt.dct(torch.as_tensor(xi))
    assert got.dtype == torch.float64
    assert rel_err(got, np.asarray(jt.dct(xi))) < 1e-12
    assert pt.dst(torch.ones(6, dtype=torch.float16)).dtype == torch.float32
    y = pt.dct(torch.as_tensor(xi.astype(np.float32)))
    assert y.dtype == torch.float32 and y.shape == (2, 6)


def test_exports_match_reference():
    names = ("dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn")
    for name in names:
        assert callable(getattr(pt, name)) and hasattr(jt, name)
    code = ("import sys, torch, cfftpack_tpu_torch as pt; "
            "pt.dct(torch.tensor([1.0, 2.0])); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'cfftpack_tpu.'))]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
