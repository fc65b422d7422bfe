"""DCT/DST types V-VIII of the port against the JAX package and the C
library's golden vectors.

The same seeded numpy inputs go through ``cfftpack_tpu`` (CPU, x64) and
``cfftpack_tpu_torch`` (CPU tensors).  Bars: 1e-12 of max |X| in
float64, 1e-4 in float32 (torch_parity.BARS); the golden vectors at
tests/test_extras.py's tolerances.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import cfftpack_tpu as jt
import cfftpack_tpu.ops.oddtypes as jodd

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch.ops import oddtypes as podd

from torch_parity import bar, real_input, rel_err

pdct = importlib.import_module("cfftpack_tpu_torch.ops.dct")
pcol = importlib.import_module("cfftpack_tpu_torch.ops.colfft")
prs = importlib.import_module("cfftpack_tpu_torch.ops.rstream")

torch.set_num_threads(1)

GOLD = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden.npz")
NORMS = ("fftpack", "ortho", "backward", "forward")
FUNCS = ("dct", "idct", "dst", "idst")
TYPES = (5, 6, 7, 8)
# (family, type, the C library has an inverse of its own)
FAMS = [("dct5", 5, True), ("dct6", 6, False), ("dct7", 7, False),
        ("dct8", 8, True), ("dst5", 5, True), ("dst6", 6, False),
        ("dst7", 7, False), ("dst8", 8, True)]


def _t(a):
    return torch.as_tensor(a)


@pytest.fixture
def eager():
    """Run the reference op by op: its jit compiles one program per
    (function, type, n, norm), the eager ops one per shape."""
    with jax.disable_jit():
        yield


# ------------------------------------------------- the eight bases

@pytest.mark.parametrize("mode", [1, -1, 0])
@pytest.mark.parametrize("fam", [f[0] for f in FAMS])
def test_apply_matches_reference(eager, fam, mode):
    for n in (1, 2, 5, 8, 13):
        x = real_input((3, n), np.float64, seed=n + mode)
        got = getattr(podd, f"{fam}_apply")(_t(x), n, mode)
        want = np.asarray(getattr(jodd, f"{fam}_apply")(x, n, mode))
        assert got.dtype == torch.float64
        assert rel_err(got, want) < 1e-12, (fam, n, mode)


# ------------------------------------------------- parity with the reference

@pytest.mark.parametrize("t", TYPES)
@pytest.mark.parametrize("fn", FUNCS)
def test_matches_reference_f64(eager, fn, t):
    for n in (1, 2, 5, 6, 13, 30):
        x = real_input((3, n), np.float64, seed=10 * n + t)
        for norm in NORMS:
            got = getattr(pt, fn)(_t(x), t, norm=norm)
            want = np.asarray(getattr(jt, fn)(x, t, norm=norm))
            assert got.dtype == torch.float64
            assert rel_err(got, want) < 1e-12, (fn, t, n, norm)


@pytest.mark.parametrize("t", TYPES)
@pytest.mark.parametrize("fn", FUNCS)
def test_matches_reference_f32(eager, fn, t):
    for n in (6, 31):
        x = real_input((4, n), np.float32, seed=n + t)
        got = getattr(pt, fn)(_t(x), t, norm="ortho")
        want = np.asarray(getattr(jt, fn)(x, t, norm="ortho"))
        assert got.dtype == torch.float32
        assert rel_err(got, want) < 1e-4, (fn, t, n)


@pytest.mark.parametrize("t", TYPES)
def test_non_last_axis_matches_reference(eager, t):
    x = real_input((13, 4), np.float64, seed=t)
    for fn in FUNCS:
        got = getattr(pt, fn)(_t(x), t, axis=0, norm="ortho")
        want = np.asarray(getattr(jt, fn)(x, t, axis=0, norm="ortho"))
        assert rel_err(got, want) < 1e-12, (fn, t)


def test_bluestein_length_matches_reference(eager):
    """n = 24: M = 47 and 49 = 7 * 7, a Bluestein and a dense-radix
    length of the shifted DFT."""
    x = real_input((2, 24), np.float64, seed=24)
    for t in TYPES:
        for fn in ("dct", "dst"):
            got = getattr(pt, fn)(_t(x), t)
            want = np.asarray(getattr(jt, fn)(x, t))
            assert rel_err(got, want) < 1e-12, (fn, t)


# ------------------------------------------------- golden vectors

@pytest.mark.parametrize("fam,t,has_inv", FAMS)
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 13])
def test_golden(fam, t, has_inv, n):
    x = _t(GOLD[f"{fam}_in_{n}"])
    fwd, inv = ((pt.dct, pt.idct) if fam.startswith("dct")
                else (pt.dst, pt.idst))
    np.testing.assert_allclose(fwd(x, t).numpy(), GOLD[f"{fam}_fwd_{n}"],
                               atol=1e-12 * n)
    if has_inv:
        np.testing.assert_allclose(inv(x, t).numpy(), GOLD[f"{fam}_inv_{n}"],
                                   atol=1e-12 * n * n)
        np.testing.assert_allclose(inv(x, t, norm="ortho").numpy(),
                                   GOLD[f"{fam}_inv_{n}_ortho"],
                                   atol=1e-12 * n)
    if fam != "dct7":
        # the C library's ortho dct7 does not invert its ortho dct6; both
        # packages keep the invertible pair
        np.testing.assert_allclose(fwd(x, t, norm="ortho").numpy(),
                                   GOLD[f"{fam}_fwd_{n}_ortho"],
                                   atol=1e-12 * n)


# ------------------------------------------------- round trips, N-D

@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("t", TYPES)
def test_round_trips(t, norm, dt):
    for n in (2, 5, 13, 31):
        x = _t(real_input((2, 3, n), dt, seed=n + t))
        for fwd, inv in ((pt.dct, pt.idct), (pt.dst, pt.idst)):
            back = inv(fwd(x, t, norm=norm), t, norm=norm)
            assert rel_err(back, x) < 10 * bar(dt), (t, n, norm)


@pytest.mark.parametrize("fn", ["dctn", "idctn", "dstn", "idstn"])
def test_nd_matches_reference(eager, fn):
    x = real_input((2, 12, 10), np.float64, seed=5)
    for t, axes in ((5, (-2, -1)), (6, None), (7, 1), (8, (0, 2))):
        got = getattr(pt, fn)(_t(x), t, axes=axes, norm="ortho")
        want = np.asarray(getattr(jt, fn)(x, t, axes=axes, norm="ortho"))
        assert rel_err(got, want) < 1e-12, (t, axes)


@pytest.mark.parametrize("t", TYPES)
def test_dctn_round_trip(t):
    x = _t(real_input((3, 6, 8), np.float64, seed=t))
    assert rel_err(pt.idctn(pt.dctn(x, t), t), x) < 1e-11
    assert rel_err(pt.idstn(pt.dstn(x, t, axes=(1, 2)), t, axes=(1, 2)),
                   x) < 1e-11


# ------------------------------------------------- the kernel gates stay shut

def test_odd_types_stay_off_the_kernel_routes(monkeypatch):
    """Shapes at which types 2-4 take K9 (axis -2 of an even image
    count) and K7/K8 (float32, n = 65536, even batch): types 5-8 go
    through the engine's default dispatch only."""
    def boom(*a, **k):
        raise AssertionError("a DCT-II/III/IV kernel route took an odd type")

    for name in ("scoldct", "coldct_plain"):
        monkeypatch.setattr(pcol, name, boom)
    for name in ("sdct2_stream", "sdct3_stream", "launch"):
        monkeypatch.setattr(prs, name, boom)
    monkeypatch.setattr(pdct, "_dct4_stream", boom)
    x = _t(real_input((2, 64, 32), np.float32, seed=6))
    assert pdct._coldct_ok(x, 64)
    for t in TYPES:
        for fn in (pt.dct, pt.idct, pt.dst, pt.idst):
            y = fn(x, t, axis=-2)
            want = fn(x.transpose(-1, -2), t).transpose(-1, -2)
            assert torch.equal(y, want)
    z = torch.zeros((2, 65536))
    for t in TYPES:
        assert tuple(pt.dct(z, t).shape) == (2, 65536)


def test_errors_and_promotion():
    x = torch.zeros((2, 8))
    for bad in (0, 9):
        with pytest.raises(ValueError, match="1..8"):
            pt.dst(x, bad)
    with pytest.raises(TypeError, match="real"):
        pt.dct(torch.zeros(8, dtype=torch.complex64), 5)
    xi = np.arange(12).reshape(2, 6)
    got = pt.dct(_t(xi), 6)
    assert got.dtype == torch.float64
    assert rel_err(got, np.asarray(jt.dct(xi, 6))) < 1e-12
    assert pt.dst(torch.ones(6, dtype=torch.float16), 7).dtype == torch.float32
