"""K1's real modes: the real route of ``core.srfft`` and ``core.sirfft``.

Even n with n/2 a register length (``fused_fft.real_eligible``) runs the
r2c and c2r modes of K1 (``fused_fft.srfft_real``, ``sirfft_real``): one
launch each on the card, ``fused_fft.real_plain`` (the glue over a table
set) on the CPU.  Each mode reads one table set of
``plan.device_tables(n).real``; the adjoint of each is the other mode with
the transposed set.

* On the CPU: the table sets against dense matrices built from the plain
  glue (each transposed set is the transpose of the map, every bin
  included), the r2c set against ``numpy.fft.rfft`` with exact-zero
  imaginary DC and Nyquist, the route rule (register halves only, disjoint
  from the real-stream route), and the dot-product identity of each mode
  against its adjoint in float64.
* On the card (``-m cuda``): both modes against the plain glue for every
  n = 2 * ``REG_LENGTHS[dtype]``, at 1e-5 of max |X| in float32 and 1e-12
  in float64, at batch 1, 3 and 4 with a scale, on rows from ``movedim``
  of axis 0 and a strided view, with nonzero imaginary DC and Nyquist fed
  to c2r and exact zeros out of r2c; the dot-product identity of each mode
  against its adjoint in float64 on the card.
"""
import numpy as np
import pytest
import torch

from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.ops import core, fused_fft, rstream
from cfftpack_tpu_torch.utils import profiling

SETS = ("rfft", "irfft", "rfft_adj", "irfft_adj")
BAR = {torch.float32: 1e-5, torch.float64: 1e-12}
CARD_CASES = [(dt, 2 * h) for dt in (torch.float32, torch.float64)
              for h in plan.REG_LENGTHS[dt]]


def _map(n: int, tables: str, planes, scale: float = 1.0):
    """The map of a table set on the (re, im) or real planes given."""
    if fused_fft._REAL_MODE[tables] == "r2c":
        return fused_fft.srfft_real(planes[0], n, scale, tables)
    return (fused_fft.sirfft_real(planes[0], planes[1], n, scale, tables),)


def _dense(n: int, tables: str) -> np.ndarray:
    """The matrix of a set's plain map in float64 (``plan.real_tables`` of
    the host tables), columns the input coordinates (real rows, or the re
    plane's bins then the im plane's)."""
    h = n // 2
    host = plan.host_tables(n)
    tab = torch.from_numpy(plan.real_tables(host["rfft_merge"],
                                            host["irfft_merge"])[tables])
    mode = fused_fft._REAL_MODE[tables]
    width = n if mode == "r2c" else 2 * (h + 1)
    eye = torch.eye(width, dtype=torch.float64)
    if mode == "r2c":
        out = fused_fft.real_plain(eye, None, n, mode, tab)
    else:
        out = (fused_fft.real_plain(eye[:, :h + 1], eye[:, h + 1:], n, mode,
                                    tab),)
    return torch.cat(out, dim=-1).T.numpy()


@pytest.mark.parametrize("n", [16, 960])
def test_transposed_sets_are_the_adjoint_maps(n):
    """Every bin of each transposed set, DC and Nyquist included, gives
    the transpose of its set's map: A(rfft_adj) = A(rfft)^T and
    A(irfft_adj) = A(irfft)^T, to rounding."""
    for a, b in (("rfft", "rfft_adj"), ("irfft", "irfft_adj")):
        A, At = _dense(n, a), _dense(n, b)
        assert np.abs(At - A.T).max() < 1e-12 * np.abs(A).max(), (n, a)


def test_transposed_sets_only_where_the_modes_run():
    """The device plan holds the transposed sets for the real modes'
    lengths alone, so a long even n keeps the plain route's two."""
    assert set(plan.device_tables(960, torch.float32, "cpu").real) == set(
        SETS)
    assert set(plan.device_tables(65536, torch.float32, "cpu").real) == {
        "rfft", "irfft"}
    assert set(plan.device_tables(16384, torch.float64, "cpu").real) == {
        "rfft", "irfft"}


@pytest.mark.parametrize("n", [16, 960, 2048])
def test_rfft_set_is_numpy_rfft(n):
    """The r2c map of the ``rfft`` set is numpy's rfft, with imaginary DC
    and Nyquist exact zeros; the c2r map of ``irfft`` inverts it to n x."""
    x = torch.tensor(np.random.default_rng(n).standard_normal((3, n)))
    yr, yi = _map(n, "rfft", (x,), 0.5)
    want = 0.5 * np.fft.rfft(x.numpy())
    err = np.abs(yr.numpy() + 1j * yi.numpy() - want).max()
    assert err < 1e-13 * np.abs(want).max()
    assert (yi[:, 0] == 0).all() and (yi[:, -1] == 0).all()
    (back,) = _map(n, "irfft", (yr, yi), 2.0 / n)
    assert np.abs(back.numpy() - x.numpy()).max() < 1e-13


def test_route_rule():
    """The real modes take even n with n/2 a register length (float32:
    960 .. 16384, float64: 960 .. 8192), and none of the real-stream
    route's lengths."""
    want = {torch.float32: {2 * h for h in (480, 512, 960, 1024, 2048, 4096,
                                            8192)},
            torch.float64: {2 * h for h in (480, 512, 960, 1024, 2048,
                                            4096)}}
    for dt, ns in want.items():
        got = {n for n in range(2, 70000, 2) if fused_fft.real_eligible(n,
                                                                        dt)}
        assert got == ns, dt
        assert not any(core._use_rstream(n, 4, dt) for n in ns)
        assert not any(fused_fft.real_eligible(n, dt) for n in range(1, 70000,
                                                                     2))
    assert rstream.rstream_eligible(32768, torch.float32, 4)
    assert not fused_fft.real_eligible(32768, torch.float32)


def _dot_identity(n: int, tables: str, device, dtype=torch.float64):
    """|<A u, g> - <u, A^T g>| over ||A u|| ||g||, A^T g from the
    Function's backward (the other mode with the transposed set)."""
    h = n // 2
    r = np.random.default_rng(n + SETS.index(tables))
    shapes = ([(3, n)] if fused_fft._REAL_MODE[tables] == "r2c"
              else [(3, h + 1)] * 2)
    us = [torch.tensor(r.standard_normal(s), dtype=dtype, device=device,
                       requires_grad=True) for s in shapes]
    ys = _map(n, tables, us, 0.3)
    gs = [torch.tensor(r.standard_normal(tuple(y.shape)), dtype=dtype,
                       device=device) for y in ys]
    grads = torch.autograd.grad(ys, us, gs)
    ys = [y.detach() for y in ys]
    us = [u.detach() for u in us]
    lhs = sum(float((g * y).sum()) for g, y in zip(gs, ys))
    rhs = sum(float((u * g).sum()) for u, g in zip(us, grads))
    norm = (np.sqrt(sum(float((y ** 2).sum()) for y in ys))
            * np.sqrt(sum(float((g ** 2).sum()) for g in gs)))
    return abs(lhs - rhs) / norm


@pytest.mark.parametrize("tables", SETS)
@pytest.mark.parametrize("n", [960, 1024, 2048])
def test_dot_product_identity_f64(n, tables):
    assert _dot_identity(n, tables, "cpu") < 1e-13


# ----------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _plain(n, tables, planes, scale):
    """The plain glue of a set on CPU copies of the planes, in the
    planes' dtype."""
    tab = plan.device_tables(n, planes[0].dtype, "cpu").real[tables]
    cpu = [p.cpu() for p in planes]
    mode = fused_fft._REAL_MODE[tables]
    lead = planes[0].shape[:-1]
    flat = [p.reshape(-1, p.shape[-1]) for p in cpu]
    out = fused_fft.real_plain(flat[0], flat[1] if len(flat) > 1 else None,
                               n, mode, tab, scale)
    out = out if isinstance(out, tuple) else (out,)
    return [o.reshape(lead + o.shape[-1:]) for o in out]


def _check(n, tables, planes, scale, bar):
    with torch.no_grad():
        got = _map(n, tables, planes, scale)
    want = _plain(n, tables, planes, scale)
    peak = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_cuda
        err = float((g.cpu() - w).abs().max()) / peak
        assert err < bar, (n, tables, err)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, n", CARD_CASES)
def test_real_modes_match_plain_on_card(dtype, n):
    _card()
    h = n // 2
    bar = BAR[dtype]
    g = torch.Generator(device="cuda").manual_seed(n)
    for rows in (1, 3, 4):
        x = torch.randn((rows, n), generator=g, device="cuda", dtype=dtype)
        yr, yi = _check(n, "rfft", (x,), 0.5, bar)
        # imaginary DC and Nyquist out of r2c are exact zeros
        assert (yi[:, 0] == 0).all() and (yi[:, h] == 0).all()
        yr = yr.clone()
        yi = torch.randn((rows, h + 1), generator=g, device="cuda",
                         dtype=dtype)
        assert (yi[:, 0] != 0).all() and (yi[:, h] != 0).all()
        for tables in ("irfft", "rfft_adj"):
            _check(n, tables, (yr, yi), 1.5, bar)
        _check(n, "irfft_adj", (x,), 0.25, bar)
    # rows of another axis and strided views are read as they lie
    xt = torch.randn((n, 3), generator=g, device="cuda", dtype=dtype)
    _check(n, "rfft", (xt.movedim(0, -1),), 1.0, bar)
    xs = torch.randn((3, 2 * n), generator=g, device="cuda",
                     dtype=dtype)[:, ::2]
    _check(n, "rfft", (xs,), 1.0, bar)
    off = torch.randn(3 * n + 1, generator=g, device="cuda",
                      dtype=dtype)[1:].view(3, n)       # an odd offset
    _check(n, "rfft", (off,), 1.0, bar)
    pr = torch.randn((h + 1, 2), generator=g, device="cuda", dtype=dtype)
    pi = torch.randn((2, 2 * (h + 1)), generator=g, device="cuda",
                     dtype=dtype)[:, ::2]
    _check(n, "irfft", (pr.movedim(0, -1), pi), 1.0, bar)


@pytest.mark.cuda
@pytest.mark.parametrize("tables", SETS)
@pytest.mark.parametrize("n", [960, 2048, 8192])
def test_dot_product_identity_f64_on_card(n, tables):
    _card()
    profiling.reset()
    assert _dot_identity(n, tables, "cuda") < 1e-13
    assert profiling.launches["K1"] == 2
