"""The port's public transforms against the JAX package's: all four
norms, a non-last axis, promotion, and the error cases."""
import numpy as np
import pytest
import torch

import cfftpack_tpu as jt
import cfftpack_tpu_torch as pt

from torch_parity import bar, complex_input, real_input, rel_err, to_np

torch.set_num_threads(1)

NORMS = ["fftpack", "ortho", "backward", "forward"]
SHAPE = (6, 60)       # axis -1: n = 60 (radix 4/3/5); axis 0: n = 6


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("norm", NORMS)
def test_fft_ifft(norm, axis, dtype):
    x = complex_input(SHAPE, dtype, seed=1)
    for mine, ref in ((pt.fft, jt.fft), (pt.ifft, jt.ifft)):
        got = mine(_t(x), axis=axis, norm=norm)
        want = np.asarray(ref(x, axis=axis, norm=norm))
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        assert rel_err(got, want) < bar(dtype)


def test_fft_promotes_real_input():
    x = real_input(SHAPE, np.float64, seed=2)
    got = pt.fft(_t(x))
    assert got.dtype == torch.complex128
    assert rel_err(got, np.asarray(jt.fft(x))) < 1e-12


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("norm", NORMS)
def test_fft_split(norm, axis, dtype):
    x = complex_input(SHAPE, np.complex128, seed=3)
    xr, xi = x.real.astype(dtype), x.imag.astype(dtype)
    for mine, ref in ((pt.fft_split, jt.fft_split),
                      (pt.ifft_split, jt.ifft_split)):
        yr, yi = mine(_t(xr), _t(xi), axis=axis, norm=norm)
        wr, wi = ref(xr, xi, axis=axis, norm=norm)
        assert yr.dtype == getattr(torch, np.dtype(dtype).name)
        assert rel_err(to_np(yr) + 1j * to_np(yi),
                       np.asarray(wr) + 1j * np.asarray(wi)) < bar(dtype)


def test_fft_split_promotes_integers():
    xr = np.arange(64, dtype=np.int32).reshape(2, 32)
    xi = np.zeros_like(xr)
    yr, yi = pt.fft_split(_t(xr), _t(xi))
    wr, wi = jt.fft_split(xr, xi)
    assert yr.dtype == torch.float32 and np.asarray(wr).dtype == np.float32
    assert rel_err(to_np(yr) + 1j * to_np(yi),
                   np.asarray(wr) + 1j * np.asarray(wi)) < 1e-4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("norm", NORMS)
def test_rfft_irfft(norm, axis, dtype):
    x = real_input(SHAPE, dtype, seed=4)
    n = x.shape[axis]
    got = pt.rfft(_t(x), axis=axis, norm=norm)
    want = np.asarray(jt.rfft(x, axis=axis, norm=norm))
    assert rel_err(got, want) < bar(dtype)
    back = pt.irfft(got, n, axis=axis, norm=norm)
    wback = np.asarray(jt.irfft(want, n, axis=axis, norm=norm))
    assert back.dtype == getattr(torch, np.dtype(dtype).name)
    assert rel_err(back, wback) < bar(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("norm", NORMS)
def test_rfft_irfft_split(norm, axis, dtype):
    x = real_input(SHAPE, dtype, seed=5)
    n = x.shape[axis]
    yr, yi = pt.rfft_split(_t(x), axis=axis, norm=norm)
    wr, wi = jt.rfft_split(x, axis=axis, norm=norm)
    assert rel_err(to_np(yr) + 1j * to_np(yi),
                   np.asarray(wr) + 1j * np.asarray(wi)) < bar(dtype)
    back = pt.irfft_split(yr, yi, n, axis=axis, norm=norm)
    wback = jt.irfft_split(wr, wi, n, axis=axis, norm=norm)
    assert rel_err(back, np.asarray(wback)) < bar(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [60, 15])       # fused even n; odd n
@pytest.mark.parametrize("norm", NORMS)
def test_rfilter_split(norm, n, dtype):
    x = real_input((4, n), dtype, seed=6)
    f = complex_input((n // 2 + 1,), np.complex128, seed=7)
    fr, fi = f.real.astype(dtype), f.imag.astype(dtype)
    fi[0] = 0.0
    if n % 2 == 0:
        fi[-1] = 0.0
    got = pt.rfilter_split(_t(x), _t(fr), _t(fi), norm=norm)
    want = np.asarray(jt.rfilter_split(x, fr, fi, norm=norm))
    assert rel_err(got, want) < bar(dtype)


def test_rfilter_split_axis0():
    x = real_input((60, 3), np.float64, seed=8)
    f = complex_input((31,), np.complex128, seed=9)
    fr, fi = f.real.copy(), f.imag.copy()
    fi[0] = fi[-1] = 0.0
    got = pt.rfilter_split(_t(x), _t(fr), _t(fi), axis=0)
    want = np.asarray(jt.rfilter_split(x, fr, fi, axis=0))
    assert rel_err(got, want) < 1e-12


def test_errors_match_reference():
    x = complex_input(SHAPE, np.complex128, seed=10)
    xr = x.real.copy()
    for api in (jt, pt):
        arg = x if api is jt else _t(x)
        rarg = xr if api is jt else _t(xr)
        with pytest.raises(ValueError, match="norm"):
            api.fft(arg, norm="bogus")
        with pytest.raises(ValueError, match="norm"):
            api.rfft_split(rarg, norm="bogus")
        with pytest.raises(TypeError):
            api.rfft(arg)                             # complex input
        with pytest.raises(TypeError):
            api.rfft_split(arg)
        with pytest.raises(ValueError, match="bins"):
            api.irfft(arg, 60)                        # 60 bins, not 31
        with pytest.raises(ValueError, match="bins"):
            api.irfft_split(rarg, rarg, 60)
        with pytest.raises(ValueError, match="bins"):
            api.rfilter_split(rarg, rarg[0], rarg[0])
        with pytest.raises(ValueError, match="shapes differ"):
            api.fft_split(rarg, rarg[:3])
        with pytest.raises(ValueError, match="impl"):
            api.fft_split(rarg, rarg, impl="bogus")


def test_fft_split_rejects_complex_planes():
    # the JAX package would run the real engine on them silently
    z = torch.zeros((2, 8), dtype=torch.complex64)
    with pytest.raises(TypeError, match="real input"):
        pt.fft_split(z, z)


def test_pallas_impl_at_k10_length_raises():
    """impl="pallas" names a kernel: K10 at its lengths, else K1, else
    ``ValueError`` where no kernel takes (n, dtype), in both packages."""
    for n in (101, 131072):           # Bluestein; past both kernels' caps
        z = np.zeros((1, n), np.float32)
        for api, arg in ((jt, z), (pt, _t(z))):
            for fn in (api.fft_split, api.ifft_split):
                with pytest.raises(ValueError, match=f"n={n}"):
                    fn(arg, arg, impl="pallas")
    # past the port's K1 (one block's shared memory holds n <= 14528 in
    # float32) and not a K10 length; the TPU kernel's cap is its own
    z = torch.zeros((1, 32768))
    with pytest.raises(ValueError, match="n=32768"):
        pt.fft_split(z, z, impl="pallas")
    with pytest.raises(ValueError, match="float64"):
        pt.fft_split(z.double(), z.double(), impl="pallas")
    # n = 60 is K1 under both engines; 4096 is K10 against K1
    y = _t(real_input((2, 60), np.float32, seed=11))
    a = pt.fft_split(y, y, impl="pallas")
    b = pt.fft_split(y, y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    y = _t(real_input((2, 4096), np.float32, seed=12))
    a = pt.fft_split(y, y, impl="pallas", norm="ortho")
    b = pt.fft_split(y, y, norm="ortho")
    assert rel_err(to_np(a[0]) + 1j * to_np(a[1]),
                   to_np(b[0]) + 1j * to_np(b[1])) < 1e-5
    assert not torch.equal(a[0], b[0])            # another engine


# ------------------------------------------------- shifts and grids

GOLD = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden.npz")


@pytest.mark.parametrize("n", [8, 15])
def test_shift_golden(n):
    x = _t(GOLD[f"shift_in_{n}"])
    assert np.array_equal(pt.fftshift(x).numpy(), GOLD[f"fftshift_{n}"])
    assert np.array_equal(pt.ifftshift(x).numpy(), GOLD[f"ifftshift_{n}"])
    assert torch.equal(pt.ifftshift(pt.fftshift(x)), x)


@pytest.mark.parametrize("axes", [None, 0, (1,), (0, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.complex128, np.int64])
def test_shift_matches_reference(dtype, axes):
    x = 10 * complex_input((4, 5, 6), np.complex128, seed=13)
    x = (x if np.dtype(dtype).kind == "c" else x.real).astype(dtype)
    for mine, ref, npf in ((pt.fftshift, jt.fftshift, np.fft.fftshift),
                           (pt.ifftshift, jt.ifftshift, np.fft.ifftshift)):
        got = mine(_t(x), axes=axes)
        assert got.dtype == _t(x).dtype
        assert np.array_equal(to_np(got), np.asarray(ref(x, axes=axes)))
        assert np.array_equal(to_np(got), npf(x, axes=axes))


@pytest.mark.parametrize("n", [1, 2, 7, 8, 15, 60])
@pytest.mark.parametrize("d", [1.0, 0.25])
def test_fftfreq_rfftfreq(n, d):
    f = pt.fftfreq(n, d, device="cpu")
    r = pt.rfftfreq(n, d, device="cpu")
    assert f.dtype == torch.float64 and r.dtype == torch.float64
    # numpy multiplies by 1/(n*d) where both packages divide: one rounding
    np.testing.assert_allclose(f.numpy(), np.fft.fftfreq(n, d), rtol=4e-16,
                               atol=0)
    np.testing.assert_allclose(r.numpy(), np.fft.rfftfreq(n, d), rtol=4e-16,
                               atol=0)
    assert np.array_equal(f.numpy(), np.asarray(jt.fftfreq(n, d)))
    assert np.array_equal(r.numpy(), np.asarray(jt.rfftfreq(n, d)))


def test_freq_grids_go_to_the_card_by_default():
    if torch.cuda.is_available():
        assert pt.fftfreq(8).is_cuda and pt.rfftfreq(8).is_cuda
    else:
        for fn in (pt.fftfreq, pt.rfftfreq):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(8)


def _direct_circular(a, b):
    n = a.shape[-1]
    idx = (np.arange(n)[:, None] - np.arange(n)[None, :]) % n
    return np.einsum("...j,...kj->...k", a, b[..., idx])


@pytest.mark.parametrize("n", [15, 60])
@pytest.mark.parametrize("kind", ["real", "complex", "mixed"])
def test_circular_convolve(kind, n):
    a = complex_input((3, n), np.complex128, seed=n)
    b = complex_input((3, n), np.complex128, seed=n + 1)
    if kind == "real":
        a, b = a.real.copy(), b.real.copy()
    elif kind == "mixed":
        b = b.real.copy()
    got = pt.circular_convolve(_t(a), _t(b))
    assert got.is_complex() == (kind != "real")
    assert rel_err(got, _direct_circular(a, b)) < 1e-12
    assert rel_err(got, np.asarray(jt.circular_convolve(a, b))) < 1e-12


def test_circular_convolve_axis_and_errors():
    a = real_input((12, 3), np.float32, seed=14)
    b = real_input((12, 3), np.float32, seed=15)
    got = pt.circular_convolve(_t(a), _t(b), axis=0)
    want = _direct_circular(a.T.astype(np.float64), b.T.astype(np.float64)).T
    assert got.dtype == torch.float32 and rel_err(got, want) < 1e-4
    for api, x, y in ((jt, a, b[:5]), (pt, _t(a), _t(b[:5]))):
        with pytest.raises(ValueError, match="lengths differ"):
            api.circular_convolve(x, y, axis=0)


def _zero_length_cases():
    """Every entry point with a transform axis, on a length-0 axis."""
    real = lambda *s: torch.zeros(s)                                # noqa: E731
    cplx = lambda *s: torch.zeros(s, dtype=torch.complex64)         # noqa: E731
    one = torch.zeros(1)
    cases = {
        "fft": lambda: pt.fft(cplx(3, 0)),
        "ifft": lambda: pt.ifft(cplx(3, 0)),
        "fft axis 0": lambda: pt.fft(cplx(0, 3), axis=0),
        "fft2": lambda: pt.fft2(cplx(2, 0, 3)),
        "ifft2": lambda: pt.ifft2(cplx(2, 3, 0)),
        "fftn": lambda: pt.fftn(cplx(2, 0, 3)),
        "ifftn": lambda: pt.ifftn(cplx(0, 2, 3)),
        "fft_split": lambda: pt.fft_split(real(3, 0), real(3, 0)),
        "ifft_split": lambda: pt.ifft_split(real(3, 0), real(3, 0)),
        "fft_split pallas": lambda: pt.fft_split(real(3, 0), real(3, 0),
                                                 impl="pallas"),
        "fft2_split": lambda: pt.fft2_split(real(2, 0, 3), real(2, 0, 3)),
        "ifft2_split": lambda: pt.ifft2_split(real(2, 3, 0), real(2, 3, 0)),
        "rfft": lambda: pt.rfft(real(3, 0)),
        "rfft axis 0": lambda: pt.rfft(real(0, 3), axis=0),
        "irfft": lambda: pt.irfft(cplx(3, 1), 0),
        "rfft_split": lambda: pt.rfft_split(real(3, 0)),
        "irfft_split": lambda: pt.irfft_split(real(3, 1), real(3, 1), 0),
        "rfft2 last": lambda: pt.rfft2(real(2, 3, 0)),
        "rfft2 first": lambda: pt.rfft2(real(2, 0, 4)),
        "rfft2_split last": lambda: pt.rfft2_split(real(2, 3, 0)),
        "rfft2_split first": lambda: pt.rfft2_split(real(2, 0, 4)),
        "rfilter_split": lambda: pt.rfilter_split(real(3, 0), one, one),
        "circular_convolve real": lambda: pt.circular_convolve(
            real(3, 0), real(3, 0)),
        "circular_convolve complex": lambda: pt.circular_convolve(
            cplx(3, 0), cplx(3, 0)),
        "gdft": lambda: pt.gdft(cplx(3, 0), 0.5, 0.25),
        "igdft": lambda: pt.igdft(cplx(3, 0), 0.5, 0.25),
    }
    for t in range(1, 9):
        for name in ("dct", "idct", "dst", "idst"):
            cases[f"{name} type {t}"] = (
                lambda name=name, t=t: getattr(pt, name)(real(3, 0), t))
    for name in ("dctn", "idctn", "dstn", "idstn"):
        for t in (2, 4, 5):
            cases[f"{name} type {t}"] = (
                lambda name=name, t=t: getattr(pt, name)(real(2, 0, 3), t))
    cases["dct axis -2"] = lambda: pt.dct(real(2, 0, 4), 2, axis=-2)
    return cases


_ZERO_LENGTH = _zero_length_cases()


@pytest.mark.parametrize("name", sorted(_ZERO_LENGTH))
def test_zero_length_axis_raises_one_clear_error(name):
    """A length-0 transform axis raises the same ValueError from every
    entry point, before any table is built (the reference raises
    ZeroDivisionError, IndexError or returns an empty array at these
    places, so it is not the oracle here)."""
    with pytest.raises(ValueError, match="transform length must be >= 1"):
        _ZERO_LENGTH[name]()
