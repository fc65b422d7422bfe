"""The ``*_hp`` names of the port against the JAX package's own ``*_hp``
(the double-float engine, on the CPU) and against numpy/scipy in
float64, on the same seeded inputs, at 1e-12 of max |X|; the quad
contract of ``sfft_hp``, the f64 policy names, errors, dtypes and
devices.

The reference's engine compiles one program per (function, length) on
the CPU, about 20 s each at the Bluestein length 101, so every name is
held against it at the mixed-radix length 60, and at 101 the pair
``fft_hp``/``ifft_hp`` (the Bluestein core the other names share); at
101 every name is held against numpy/scipy.
"""
import numpy as np
import pytest
import scipy.fft as sf
import torch

import cfftpack_tpu.ops.hp as J
import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import config
from cfftpack_tpu_torch.ops import hp as T

from oracles import naive_gdft
from torch_parity import complex_input, real_input, rel_err, to_np

torch.set_num_threads(1)

NORMS = ("fftpack", "ortho", "backward", "forward")
BAR = 1e-12
# numpy's norm for each of ours: fftpack scales the forward by 1/n
NP_NORM = {"fftpack": "forward", "forward": "forward", "ortho": "ortho",
           "backward": "backward"}

# (name, extra positional args, input kind, shape)
ONE_D = [(nm, (), "c", (3, 60)) for nm in ("fft_hp", "ifft_hp")]
ONE_D += [(nm, (0.5, 0.25), "c", (3, 60)) for nm in ("gdft_hp", "igdft_hp")]
ONE_D += [(nm, (), "r", (3, 60)) for nm in (
    "rfft_hp", "dct1_hp", "idct1_hp", "dct2_hp", "idct2_hp", "dct4_hp",
    "idct4_hp", "dst1_hp", "idst1_hp", "dst2_hp", "idst2_hp", "dst4_hp",
    "idst4_hp")]
ONE_D += [(nm, (t,), "r", (3, 60)) for nm in ("dct_hp", "idct_hp", "dst_hp",
                                              "idst_hp")
          for t in range(1, 9)]
ONE_D += [("irfft_hp", (60,), "s", (3, 60))]
ONE_D += [(nm, (), "c", (2, 101)) for nm in ("fft_hp", "ifft_hp")]
ONE_D += [(nm, (), "c", (6, 10)) for nm in ("fft2_hp", "ifft2_hp")]
ONE_D += [("rfft2_hp", (), "r", (6, 10)), ("irfft2_hp", ((6, 10),), "s2",
                                           (6, 10))]
ONE_D += [(nm, (t, ax), "r", (2, 3, 8)) for nm in ("dctn_hp", "idctn_hp",
                                                   "dstn_hp", "idstn_hp")
          for t, ax in ((2, None), (3, (-2, -1)))]


def _input(kind, shape, seed):
    if kind == "c":
        return complex_input(shape, np.complex128, seed)
    if kind == "s":        # a packed spectrum of a real signal
        return np.fft.rfft(real_input(shape, np.float64, seed))
    if kind == "s2":
        return np.fft.rfft2(real_input(shape, np.float64, seed))
    return real_input(shape, np.float64, seed)


def _case_id(case):
    nm, args, _, shape = case
    extra = "-".join(str(a) for a in args if not isinstance(a, tuple))
    return f"{nm}{extra and '-' + extra}-{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("case", ONE_D, ids=_case_id)
def test_hp_matches_reference(case, norm):
    nm, args, kind, shape = case
    x = _input(kind, shape, seed=len(nm) + shape[-1])
    got = getattr(T, nm)(torch.from_numpy(x), *args, norm=norm)
    want = getattr(J, nm)(x, *args, norm=norm)
    assert rel_err(got, want) < BAR


def _scipy_trig(kind, t, norm, x):
    """The port's forward DCT/DST types 1-4 from scipy's unnormalised or
    orthonormal sums: fftpack scales by 1/n (1/(n+1) for DST-I, 1/(n-1)
    with halved ends for DCT-I), backward is half the unnormalised sum
    (DCT-I: its even-extension sum)."""
    fn = sf.dct if kind == "dct" else sf.dst
    n = x.shape[-1]
    if norm == "ortho":
        return fn(x, t, norm="ortho")
    s = fn(x, t)
    if kind == "dct" and t == 1:
        ends = x[..., :1] + (-1.0) ** np.arange(n) * x[..., -1:]
        if norm == "backward":
            return 0.5 * s + 0.5 * ends
        w = np.ones(n)
        w[[0, -1]] = 0.5
        return s / (n - 1) * w
    if norm == "backward":
        return 0.5 * s
    return s / (n + 1 if (kind, t) == ("dst", 1) else n)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("shape", [(3, 60), (2, 101)])
def test_hp_matches_numpy(shape, norm):
    """Every name in float64 against numpy/scipy, the inverses on the
    oracle's forward output."""
    n = shape[-1]
    x = real_input(shape, np.float64, seed=n)
    xc = complex_input(shape, np.complex128, seed=n + 1)
    nn = NP_NORM[norm]
    tx, txc = torch.from_numpy(x), torch.from_numpy(xc)
    pairs = [
        (pt.fft_hp(txc, norm), np.fft.fft(xc, norm=nn)),
        (pt.ifft_hp(txc, norm), np.fft.ifft(xc, norm=nn)),
        (pt.rfft_hp(tx, norm), np.fft.rfft(x, norm=nn)),
        (pt.irfft_hp(torch.from_numpy(np.fft.rfft(x, norm=nn)), n, norm), x),
        (pt.fft2_hp(txc[:, :10].reshape(-1, 5, 2), norm),
         np.fft.fft2(xc[:, :10].reshape(-1, 5, 2), norm=nn)),
        (pt.ifft2_hp(txc[:, :10].reshape(-1, 5, 2), norm),
         np.fft.ifft2(xc[:, :10].reshape(-1, 5, 2), norm=nn)),
        (pt.rfft2_hp(tx[:, :12].reshape(-1, 3, 4), norm),
         np.fft.rfft2(x[:, :12].reshape(-1, 3, 4), norm=nn)),
        (pt.irfft2_hp(torch.from_numpy(np.fft.rfft2(
            x[:, :12].reshape(-1, 3, 4), norm=nn)), (3, 4), norm),
         x[:, :12].reshape(-1, 3, 4)),
    ]
    # gdft: its definition times the norm's forward scale, and back
    g = pt.gdft_hp(txc, 0.5, 0.25, norm)
    scale = {"backward": 1.0, "ortho": n ** -0.5}.get(norm, 1.0 / n)
    pairs += [(g, naive_gdft(xc, 0.5, 0.25) * scale),
              (pt.igdft_hp(g, 0.5, 0.25, norm), xc)]
    hp_norm = "fftpack" if norm == "forward" else norm
    for kind in ("dct", "dst"):
        fwd, inv = getattr(pt, f"{kind}_hp"), getattr(pt, f"i{kind}_hp")
        for t in (1, 2, 3, 4):
            want = _scipy_trig(kind, t, hp_norm, x)
            pairs += [(fwd(tx, t, norm), want),
                      (inv(torch.from_numpy(want), t, norm), x)]
            if t != 3:
                named = getattr(pt, f"{kind}{t}_hp")
                pairs.append((named(tx, norm), want))
                pairs.append((getattr(pt, f"i{kind}{t}_hp")(
                    torch.from_numpy(want), norm), x))
        for t in (5, 6, 7, 8):     # no scipy form: the round trip
            pairs.append((inv(fwd(tx, t, norm), t, norm), x))
        fwdn, invn = getattr(pt, f"{kind}n_hp"), getattr(pt, f"i{kind}n_hp")
        x3 = x[:, :12].reshape(-1, 3, 4)
        want = _scipy_trig(kind, 2, hp_norm, _scipy_trig(
            kind, 2, hp_norm, x3).swapaxes(-1, -2)).swapaxes(-1, -2)
        got = fwdn(torch.from_numpy(x3), 2, (-2, -1), norm)
        pairs += [(got, want), (invn(got, 2, (-2, -1), norm), x3)]
    for i, (got, want) in enumerate(pairs):
        assert got.dtype in (torch.float64, torch.complex128), i
        assert rel_err(got, want) < BAR, i


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [60, 101])
def test_sfft_hp_quad_matches_reference(n, inverse):
    """The quad contract: (hi, lo) float32 pairs summed in float64, the
    unscaled DFT, hi = float32(y), lo = float32(y - hi)."""
    x = complex_input((2, n), np.complex128, seed=n)
    quad = []
    for v in (x.real, x.imag):
        hi = v.astype(np.float32)
        quad += [hi, (v - hi).astype(np.float32)]
    got = T.sfft_hp(*(torch.from_numpy(q) for q in quad), n, inverse)
    want = J.sfft_hp(*quad, n, inverse)
    assert all(g.dtype == torch.float32 for g in got)
    merged = [to_np(got[k]).astype(np.float64) + to_np(got[k + 1])
              for k in (0, 2)]
    ref = [np.asarray(want[k], np.float64) + np.asarray(want[k + 1])
           for k in (0, 2)]
    y = merged[0] + 1j * merged[1]
    assert rel_err(y, ref[0] + 1j * ref[1]) < BAR
    oracle = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert rel_err(y, oracle) < BAR
    # hi is the float32 rounding of y and lo the float32 rounding of the rest
    yr = to_np(got[0]).astype(np.float64) + to_np(got[1])
    assert np.array_equal(to_np(got[0]), yr.astype(np.float32))


ZERO_LENGTH = {
    "fft_hp": lambda x: pt.fft_hp(x), "ifft_hp": lambda x: pt.ifft_hp(x),
    "rfft_hp": lambda x: pt.rfft_hp(x), "dct_hp": lambda x: pt.dct_hp(x),
    "dst4_hp": lambda x: pt.dst4_hp(x), "gdft_hp": lambda x: pt.gdft_hp(x),
    "fft2_hp": lambda x: pt.fft2_hp(x), "dctn_hp": lambda x: pt.dctn_hp(x),
    "sfft_hp": lambda x: pt.sfft_hp(x, x, x, x, 0, False),
}


@pytest.mark.parametrize("name", sorted(ZERO_LENGTH))
def test_zero_length_axis_raises(name):
    with pytest.raises(ValueError):
        ZERO_LENGTH[name](torch.zeros((2, 0)))


def test_output_dtype_and_device():
    """float32 or integer input comes back float64 / complex128 on the
    input's device."""
    x = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    for fn, dt in ((pt.fft_hp, torch.complex128),
                   (pt.rfft_hp, torch.complex128),
                   (pt.dct_hp, torch.float64), (pt.dst1_hp, torch.float64),
                   (pt.fft2_hp, torch.complex128),
                   (pt.gdft_hp, torch.complex128),
                   (pt.dctn_hp, torch.float64)):
        y = fn(x)
        assert y.dtype == dt and y.device == x.device
    assert pt.dct_hp(torch.arange(6)).dtype == torch.float64
    y = pt.irfft_hp(pt.rfft_hp(x), 6)
    assert y.dtype == torch.float64 and torch.allclose(y, x.double())
    with pytest.raises(TypeError):
        pt.dct_hp(x.to(torch.complex64))


def test_f64_policy():
    assert pt.f64_policy() == "hp"
    try:
        pt.set_f64_policy("native")
        assert pt.f64_policy() == "native"
        with pytest.raises(ValueError):
            pt.set_f64_policy("df64")
        assert pt.f64_policy() == "native"
    finally:
        pt.set_f64_policy("hp")
    assert config.hp_route(np.zeros(3), torch.zeros(3, dtype=torch.float64)) \
        is False
