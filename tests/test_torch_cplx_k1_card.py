"""K1's interleaved complex mode on the card (``-m cuda``).

``fft``/``ifft`` of complex64 and complex128 rows at every length of
``plan.REG_LENGTHS`` against ``torch.fft`` in complex128 (1e-5 of
max |X| in complex64, 1e-12 in complex128), at 1, 3 and 4096 rows under
three norms, with one K1 launch a transform and no other kernel entry;
and the views of ``test_torch_cplx_k1.py`` (conjugate and negative bits,
transposed and strided rows, storage offsets, 0 and 1 rows, leading
axes, axis 0) made on the card; and the gradient through both
directions on the card at 960 and 1024 in both dtypes against the CPU's
and ``torch.fft``'s.  This file imports no JAX; it also holds
the cases and views the CPU file uses.
"""
import numpy as np
import pytest
import torch

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.config import fwd_scale, inv_scale
from cfftpack_tpu_torch.utils import profiling

from torch_parity import complex_input, rel_err, to_np

NORMS = ("fftpack", "ortho", "backward")
DTYPES = {np.complex64: torch.complex64, np.complex128: torch.complex128}
CASES = [(dt, n) for dt, tdt in DTYPES.items()
         for n in plan.REG_LENGTHS[tdt.to_real()]]
VIEWS = ("conj", "neg_bit", "negated", "transposed", "strided", "offset",
         "flat_offset", "no_rows", "one_row", "vector", "leading_axes",
         "axis0")


def _want(x: np.ndarray, inverse: bool, norm: str, axis: int = -1):
    """numpy's transform of ``x`` in complex128 times the norm's scale."""
    n = x.shape[axis]
    x = x.astype(np.complex128)
    if inverse:
        return np.fft.ifft(x, axis=axis) * n * inv_scale(norm, n)
    return np.fft.fft(x, axis=axis) * fwd_scale(norm, n)


def _port(inverse: bool):
    return pt.ifft if inverse else pt.fft


def _view(kind: str, dt, n: int, device="cpu"):
    """(the view on ``device``, its numpy value, axis, route) of each input
    kind."""
    def made(shape, seed):
        return torch.from_numpy(complex_input(shape, dt, seed)).to(device)
    base = made((4, 2 * n), 3)
    x = base[:, :n].contiguous()
    axis, route = -1, "interleaved"
    if kind == "conj":
        v = x.conj()
    elif kind == "neg_bit":
        v = torch._neg_view(x)
    elif kind == "negated":
        v = -x
    elif kind == "transposed":                 # rows one element apart
        v = made((n, 4), 4).T
    elif kind == "strided":
        v = base[:, ::2]
    elif kind == "offset":
        v = x[1:]
    elif kind == "flat_offset":           # a base one pair in
        v = base.reshape(-1)[1:1 + 3 * n].view(3, n)
    elif kind == "no_rows":
        v = x[:0]
    elif kind == "one_row":
        v = x[2:3]
    elif kind == "vector":
        v = x[1]
    elif kind == "leading_axes":
        v = base.reshape(2, 4, n)
    else:                                      # "axis0": the planes' route
        v, axis, route = made((n, 3), 5), 0, "planes"
    assert v.dtype == DTYPES[dt]
    return v, to_np(v.resolve_conj().resolve_neg()).copy(), axis, route


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt, n", CASES)
def test_interleaved_matches_torch_fft_on_card(dt, n):
    dev = _card()
    tdt = DTYPES[dt]
    tol = 1e-5 if dt is np.complex64 else 1e-12
    for b in (1, 3, 4096):
        x = torch.from_numpy(complex_input((b, n), dt, seed=n + b)).to(dev)
        x128 = x.to(torch.complex128)
        for inverse, norm in ((False, "fftpack"), (True, "fftpack"),
                              (False, "ortho"), (True, "backward")):
            profiling.reset()
            got = _port(inverse)(x, norm=norm)
            assert profiling.launches["K1"] == 1
            assert sum(profiling.launches.values()) == 1
            want = (torch.fft.ifft(x128) * n * inv_scale(norm, n) if inverse
                    else torch.fft.fft(x128) * fwd_scale(norm, n))
            assert got.dtype == tdt
            assert rel_err(got, want) < tol, (b, inverse, norm)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", VIEWS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_views_match_torch_fft_on_card(dt, kind):
    dev = _card()
    n = 960 if dt is np.complex64 else 480
    tol = 1e-5 if dt is np.complex64 else 1e-12
    v, want_in, axis, route = _view(kind, dt, n, dev)
    for inverse in (False, True):
        profiling.reset()
        got = _port(inverse)(v, axis=axis)
        if route == "interleaved":
            assert profiling.launches["K1"] == (1 if v.numel() else 0)
        if v.numel():
            want = _want(want_in, inverse, "fftpack", axis)
            assert rel_err(to_np(got), want) < tol, inverse


@pytest.mark.cuda
@pytest.mark.parametrize("n", [960, 1024])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_backward_on_card_matches_cpu(dt, n):
    """The gradient of a real loss through ``fft`` and ``ifft`` on the
    card (K1's interleaved mode both ways: one launch forward, one for
    the adjoint) against the same gradient on the CPU (the plain
    version) and against ``torch.fft``'s autograd on the card."""
    dev = _card()
    tol = 1e-5 if dt is np.complex64 else 1e-12
    x = complex_input((3, n), dt, seed=n + 7)
    cot = complex_input((3, n), dt, seed=n + 8)
    for inverse in (False, True):
        s = inv_scale("fftpack", n) * n if inverse else fwd_scale(
            "fftpack", n)
        ref = torch.fft.ifft if inverse else torch.fft.fft

        def grad(fn, device):
            xg = torch.from_numpy(x).to(device).requires_grad_(True)
            loss = (fn(xg) * torch.from_numpy(cot).to(device)).real.sum()
            return torch.autograd.grad(loss, xg)[0]
        profiling.reset()
        got = grad(_port(inverse), dev)
        torch.cuda.synchronize()
        assert profiling.launches["K1"] == 2, inverse
        assert sum(profiling.launches.values()) == 2, inverse
        assert got.dtype == DTYPES[dt]
        assert rel_err(got, grad(_port(inverse), "cpu")) < tol, inverse
        assert rel_err(got, grad(lambda a: ref(a) * s, dev)) < tol, inverse
