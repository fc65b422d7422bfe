"""Gradients through the port's transforms and kernels.

Every kernel wrapper of the port is a ``torch.autograd.Function`` whose
backward is the adjoint transform on the same wrappers
(``cfftpack_tpu_torch/ops/_adjoint.py``).  On CPU tensors the forward and
the backward run the plain versions, so these tests hold the adjoint
formulas that the card runs.

* The port's counterparts of the JAX package's four gradient tests
  (``test_cfft.py``, ``test_rfft.py``, ``test_dct.py``,
  ``test_utils_misc.py``), at their seeds.
* Each public entry that reaches a kernel, with a random cotangent w
  (the loss sum(w * y) over each real plane of the output; a complex
  input or output is taken as its two real planes), against ``jax.grad``
  of the JAX package's function on the same numpy inputs, at the
  reference's bars: 1e-12 of max |g| in float64, 1e-4 in float32.  The
  entries of one group share a length that reaches one wrapper on the
  CPU (K1: n = 16 in float64; K3: 16384; K5: 2^20 at batch 2; K7, K8 and
  K2 with K4: 32768; K6 and K9: (2, 64, 64); K10: ``impl="pallas"`` at
  1024) and one JAX program computes the whole group's gradients, since
  the JAX package compiles a program per (function, shape).  The
  flagship step runs at the JAX entry's own inputs (K1 at 960).
* For every wrapper, the dot-product identity <A x, g> = <x, A^T g>
  through the Function's backward, and ``torch.autograd.gradcheck``
  where the plain version takes float64.
* K1's real modes and its interleaved complex mode under autograd
  against ``jax.vjp`` of the JAX package's functions, in float64.
* A Hessian-vector product through ``dct`` ortho (a second derivative
  through the Function), a cotangent from a sliced loss, and that no
  ``apply`` runs and no ``grad_fn`` is made when no input requires grad.

Where the port's forward leaves the JAX package's off the packed layout's
contract, the gradient follows the port's forward.  The K7 route of
``irfft``/``irfft_split`` decodes two real rows from one complex row,
so a complex DC or Nyquist bin crosses into the paired row, where the
JAX package's c2r reads it as an alternating or a constant term; the
streaming filter (K2 with K4, or K5) mixes the pair through a complex
DC or Nyquist filter bin the same way.  Those entries of the gradient
(the imaginary planes' bins 0 and n/2) are held against autograd
through the plain versions, which is the derivative of the port's
forward; every other entry against ``jax.grad``.
"""
import functools
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import cfftpack_tpu as ct

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch.entry import step as pt_step
from cfftpack_tpu_torch.ops import (_adjoint, cmul, colfft, fourstep_fft,
                                    fused_fft, rstream, stream_fft)
from cfftpack_tpu_torch.utils import profiling

torch.set_num_threads(1)

pdct = importlib.import_module("cfftpack_tpu_torch.ops.dct")

BARS = {np.float64: 1e-12, np.float32: 1e-4}


def rng_real(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------ the JAX package's gradient tests

def test_grad_flows():
    """test_cfft.py::test_grad_flows: sum |fft(x)|^2 at n = 16; under the
    fftpack norm (1/n forward) it is sum |x|^2 / n, gradient 2x/n."""
    x = np.random.default_rng(1).standard_normal(16)
    v = torch.tensor(x, requires_grad=True)
    (pt.fft(v).abs() ** 2).sum().backward()
    g = v.grad.numpy()
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(g, 2 * x / 16, atol=1e-15)


def test_rfft_grad_flows():
    """test_rfft.py::test_rfft_grad_flows: sum |rfft(v)|^2 at n = 32,
    finite and equal to torch.fft's autograd of the same loss."""
    x = rng_real((32,), seed=4)
    v = torch.tensor(x, requires_grad=True)
    (pt.rfft(v).abs() ** 2).sum().backward()
    w = torch.tensor(x, requires_grad=True)
    (torch.fft.rfft(w, norm="forward").abs() ** 2).sum().backward()
    assert np.all(np.isfinite(v.grad.numpy()))
    np.testing.assert_allclose(v.grad.numpy(), w.grad.numpy(), atol=1e-15)


def test_dct_grad_flows():
    """test_dct.py::test_grad_flows: the ortho DCT-II is an isometry, so
    the gradient of ||Dx||^2 is 2x."""
    x = rng_real((16,), seed=17)
    v = torch.tensor(x, requires_grad=True)
    (pt.dct(v, 2, norm="ortho") ** 2).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), 2 * x, atol=1e-10)


def test_grad_through_split_api():
    """test_utils_misc.py::test_grad_through_split_api: sum(yr^2 + yi^2)
    of rfft_split at n = 16, finite and equal to torch.fft's autograd."""
    x = np.random.default_rng(1).standard_normal(16)
    v = torch.tensor(x, requires_grad=True)
    yr, yi = pt.rfft_split(v)
    (yr ** 2 + yi ** 2).sum().backward()
    w = torch.tensor(x, requires_grad=True)
    (torch.fft.rfft(w, norm="forward").abs() ** 2).sum().backward()
    assert np.all(np.isfinite(v.grad.numpy()))
    np.testing.assert_allclose(v.grad.numpy(), w.grad.numpy(), atol=1e-15)


# ---------------------------------------- public entries vs jax.grad

def _cx(a, b):
    if isinstance(a, torch.Tensor):
        return torch.complex(a, b)
    return jax.lax.complex(a, b)


def _planes(y) -> list:
    """The real planes of a result: a tuple's members, a complex tensor's
    real and imaginary parts."""
    if isinstance(y, (tuple, list)):
        return [p for t in y for p in _planes(t)]
    cplx = (y.is_complex() if isinstance(y, torch.Tensor)
            else jnp.iscomplexobj(y))
    return [y.real, y.imag] if cplx else [y]


def _real(*shape):
    return lambda r: [r.standard_normal(shape)]


def _pair(*shape):
    return lambda r: [r.standard_normal(shape), r.standard_normal(shape)]


def _filtered(b: int, n: int):
    """x (b, n) and a packed filter whose DC and Nyquist bins are real,
    as rfilter_split's contract asks."""
    def make(r):
        fr, fi = r.standard_normal(n // 2 + 1), r.standard_normal(n // 2 + 1)
        fi[0] = fi[-1] = 0.0
        return [r.standard_normal((b, n)), fr, fi]
    return make


def _plain_grad(e, ins, cots, k: int):
    """Input k's gradient by autograd through the plain versions (every
    wrapper's Function taken out)."""
    saved = _adjoint.needs_grad
    _adjoint.needs_grad = lambda *t: False
    try:
        return _port_grads(e, ins, cots)[k]
    finally:
        _adjoint.needs_grad = saved


def _pair_filter_grad(e, ins, cots, k: int):
    """The streaming filter's fi gradient by autograd through its forward
    written with torch.fft in float64: row pairs z = x[2p] + i*x[2p+1], the
    conjugate-symmetric extension F of the packed filter with whatever
    imaginary DC and Nyquist parts it holds, w = ifft(F * fft(z)) (the
    scale 1/n of the fftpack and ortho norms), rows Re w and Im w.  (The
    plain version writes into its output planes in place, which autograd
    does not follow; gradcheck holds its own derivative.)"""
    x, fr, fi = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                 for a in ins)
    h = x.shape[-1] // 2
    F = torch.complex(torch.cat([fr, fr[1:h].flip(-1)]),
                      torch.cat([fi, -fi[1:h].flip(-1)]))
    w = torch.fft.ifft(F * torch.fft.fft(torch.complex(x[0::2], x[1::2])))
    y = torch.stack([w.real, w.imag], dim=1).reshape(x.shape)
    (torch.tensor(cots[0], dtype=torch.float64) * y).sum().backward()
    return (x, fr, fi)[k].grad.numpy()


# (name, group, inputs, fn(package, *planes), masked entries of the
# gradient: (input, bins, oracle) held against the oracle, not jax.grad)
ENTRIES = [
    # K1, float64, n = 16
    ("fft", "k1_f64", _pair(4, 16), lambda m, a, b: m.fft(_cx(a, b)), ()),
    ("ifft", "k1_f64", _pair(4, 16),
     lambda m, a, b: m.ifft(_cx(a, b), norm="ortho"), ()),
    ("fft2", "k1_f64", _pair(2, 6, 10),
     lambda m, a, b: m.fft2(_cx(a, b), norm="backward"), ()),
    ("fftn", "k1_f64", _pair(2, 4, 6), lambda m, a, b: m.fftn(_cx(a, b)),
     ()),
    ("fft_split", "k1_f64", _pair(4, 16),
     lambda m, a, b: m.fft_split(a, b, norm="ortho"), ()),
    ("rfft", "k1_f64", _real(4, 16), lambda m, x: m.rfft(x), ()),
    ("irfft", "k1_f64", _pair(4, 9),
     lambda m, a, b: m.irfft(_cx(a, b), 16, norm="ortho"), ()),
    ("rfft_split", "k1_f64", _real(4, 16),
     lambda m, x: m.rfft_split(x, norm="backward"), ()),
    ("irfft_split", "k1_f64", _pair(4, 9),
     lambda m, a, b: m.irfft_split(a, b, 16), ()),
    ("rfilter_split", "k1_f64", _filtered(4, 16),
     lambda m, x, fr, fi: m.rfilter_split(x, fr, fi, norm="ortho"), ()),
    ("gdft", "k1_f64", _pair(4, 16),
     lambda m, a, b: m.gdft(_cx(a, b), 0.5, 0.25, norm="ortho"), ()),
    ("circular_convolve", "k1_f64", _pair(4, 16),
     lambda m, a, b: m.circular_convolve(a, b), ()),
    ("dctn", "k1_f64", _real(2, 4, 6),
     lambda m, x: m.dctn(x, 2, norm="ortho"), ()),
    # the JAX package's fft_hp runs through host numpy, which jax.grad
    # cannot trace: its complex128 fft is the same function
    ("fft_hp", "k1_f64", _pair(4, 16),
     lambda m, a, b: (m.fft_hp if m is pt else m.fft)(_cx(a, b)), ()),
] + [
    (f"{name} type {t}", "k1_f64", _real(4, 16),
     lambda m, x, t=t, name=name, norm=norm: getattr(m, name)(x, t,
                                                               norm=norm),
     ())
    for t in range(1, 9)
    for name, norm in (("dct", "ortho"), ("dst", "fftpack"))
] + [
    # K3
    ("fft_split 16384", "k3", _pair(2, 16384),
     lambda m, a, b: m.fft_split(a, b, norm="ortho"), ()),
    # K5 (s = 2)
    ("fft_split 2^20", "k5", _pair(2, 1 << 20),
     lambda m, a, b: m.fft_split(a, b, norm="ortho"), ()),
    # K7, K8, K2 with K4
    ("rfft_split 32768", "k7", _real(2, 32768),
     lambda m, x: m.rfft_split(x, norm="ortho"), ()),
    ("irfft_split 32768", "k7", _pair(2, 16385),
     lambda m, a, b: m.irfft_split(a, b, 32768, norm="ortho"),
     (1, (0, 16384), _plain_grad)),
    ("dct type 2 32768", "k7", _real(2, 32768),
     lambda m, x: m.dct(x, 2, norm="ortho"), ()),
    ("dct type 4 32768", "k7", _real(2, 32768),
     lambda m, x: m.dct(x, 4, norm="ortho"), ()),
    ("rfilter_split 32768", "k7", _filtered(2, 32768),
     lambda m, x, fr, fi: m.rfilter_split(x, fr, fi),
     (2, (0, 16384), _pair_filter_grad)),
    # K6, K9
    ("fft2 (2, 64, 64)", "col", _pair(2, 64, 64),
     lambda m, a, b: m.fft2(_cx(a, b), norm="ortho"), ()),
    ("dctn (2, 64, 64)", "col", _real(2, 64, 64),
     lambda m, x: m.dctn(x, 2, axes=(-2, -1), norm="ortho"), ()),
    # K10 (the JAX package's default engine computes the same function)
    ("fft_split impl=pallas 1024", "k10", _pair(2, 1024),
     lambda m, a, b: m.fft_split(a, b, norm="ortho",
                                 impl="pallas" if m is pt else "xla"), ()),
]
GROUP_DTYPE = {"k1_f64": np.float64}
NAMES = [e[0] for e in ENTRIES]
assert len(set(NAMES)) == len(NAMES)


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(entry, inputs, cotangents) of one entry, made with numpy from a
    seed of its own; the cotangents have the output planes' shapes."""
    i = NAMES.index(name)
    e = ENTRIES[i]
    dt = GROUP_DTYPE.get(e[1], np.float32)
    r = np.random.default_rng(1000 + i)
    ins = [a.astype(dt) for a in e[2](r)]
    with torch.no_grad():
        outs = _planes(e[3](pt, *(torch.from_numpy(a) for a in ins)))
    cots = [r.standard_normal(tuple(o.shape)).astype(dt) for o in outs]
    return e, ins, cots


@functools.lru_cache(maxsize=None)
def _jax_group(group: str) -> dict:
    """jax.grad of every entry of ``group``, in one jitted program."""
    names = [e[0] for e in ENTRIES if e[1] == group]
    cases = [_case(nm) for nm in names]

    def grads(ins, cots):
        out = []
        for (e, _, _), x, w in zip(cases, ins, cots):
            def loss(p, fn=e[3], w=w):
                return sum(jnp.sum(c * y) for c, y in zip(
                    w, _planes(fn(ct, *p))))
            out.append(jax.grad(loss)(list(x)))
        return out

    args = ([c[1] for c in cases], [c[2] for c in cases])
    # the program runs once: at the small lengths XLA's backend
    # optimisations would cost more compile time than they save
    opts = {} if group == "k5" else {"xla_backend_optimization_level": 0}
    res = jax.jit(grads).lower(*args).compile(compiler_options=opts)(*args)
    return {nm: [np.asarray(g) for g in gs] for nm, gs in zip(names, res)}


def _port_grads(e, ins, cots) -> list:
    planes = [torch.from_numpy(a).requires_grad_() for a in ins]
    outs = _planes(e[3](pt, *planes))
    assert [tuple(o.shape) for o in outs] == [c.shape for c in cots]
    sum((torch.from_numpy(c) * o).sum() for c, o in zip(cots, outs)
        ).backward()
    return [p.grad.numpy() for p in planes]


@pytest.mark.parametrize("name", NAMES)
def test_entry_gradient_matches_jax(name):
    e, ins, cots = _case(name)
    bar = BARS[ins[0].dtype.type]
    got = _port_grads(e, ins, cots)
    want = _jax_group(e[1])[name]
    for k, (g, w) in enumerate(zip(got, want)):
        if e[4] and e[4][0] == k:
            bins = list(e[4][1])
            oracle = e[4][2](e, ins, cots, k)[..., bins]
            err = float(np.abs(g[..., bins] - oracle).max()
                        / np.abs(w).max())
            assert err < bar, (name, k, "bins 0 and n/2", err)
            g, w = g.copy(), w.copy()
            g[..., bins] = w[..., bins] = 0.0
        assert _err(g, w) < bar, (name, k, _err(g, w))


def test_rfilter_split_2_20_matches_its_pair_formula():
    """rfilter_split at 2^20, batch 2 (K5's split_conj modes, the filter's
    gradient through K5's forward of the row pairs): the gradients of x,
    fr and fi against autograd through the streaming filter's forward
    written with torch.fft in float64 (:func:`_pair_filter_grad`), at the
    float32 bar.  The JAX package's rfilter_split is the same function
    on the filter's contract; ``rfilter_split 32768`` holds the two
    against each other through jax.grad."""
    n = 1 << 20
    r = np.random.default_rng(20)
    ins = [a.astype(np.float32) for a in _filtered(2, n)(r)]
    cots = [r.standard_normal((2, n)).astype(np.float32)]
    e = (None, None, None, lambda m, x, fr, fi: m.rfilter_split(
        x, fr, fi, norm="ortho"), ())
    got = _port_grads(e, ins, cots)
    for k in range(3):
        want = _pair_filter_grad(e, ins, cots, k)
        assert _err(got[k], want) < 1e-4, k


def test_complex_leaf_gradient():
    """A complex leaf: PyTorch's x.grad of a real loss is dL/dRe x +
    i dL/dIm x (the conjugate of what jax.grad returns for a complex
    input), so it equals the ``fft`` entry's two real planes' gradients
    from jax.grad joined, at the float64 bar."""
    e, ins, cots = _case("fft")
    gr, gi = _jax_group("k1_f64")["fft"]
    x = torch.tensor(ins[0] + 1j * ins[1], requires_grad=True)
    y = pt.fft(x)
    (torch.from_numpy(cots[0]) * y.real
     + torch.from_numpy(cots[1]) * y.imag).sum().backward()
    assert _err(x.grad.numpy().view(np.float64),
                (gr + 1j * gi).view(np.float64)) < 1e-12


SLICED = {
    "rfft_split": lambda v, axis: pt.rfft_split(v, axis=axis),
    "irfft_split": lambda v, axis: pt.irfft_split(
        *pt.rfft_split(v, axis=axis), v.shape[axis], axis=axis),
    "rfilter_split": lambda v, axis: pt.rfilter_split(
        v, _SLICE_FILTER[0], _SLICE_FILTER[1], axis=axis),
    "fft_split": lambda v, axis: pt.fft_split(v, v.flip(0), axis=axis),
    "dct type 4": lambda v, axis: pt.dct(v, 4, axis=axis),
}
_SLICE_FILTER = tuple(torch.tensor(a, dtype=torch.float32)
                      for a in _filtered(2, 32768)(
                          np.random.default_rng(4))[1:])


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("name", list(SLICED))
def test_sliced_cotangent(name, axis):
    """A loss on a strided slice of the first output plane and the plain
    sum of the second hands the backward a cotangent with a strided
    nonzero block and an expanded (stride 0) one, transposed along axis 0;
    at 32768 (K7, K2 with K4, K8; K3 at 16384 for fft_split) the gradient
    equals the one for the same cotangents made dense and contiguous."""
    n = 16384 if name == "fft_split" else 32768
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    v = torch.tensor(x, requires_grad=True)
    ys = SLICED[name](v, axis)
    ys = ys if isinstance(ys, tuple) else (ys, ys)
    sl = [slice(None)] * 2
    sl[axis] = slice(5, None, 3)
    ((ys[0][tuple(sl)]).sum() + ys[1].sum()).backward(retain_graph=True)
    mask = torch.zeros_like(ys[0])
    mask[tuple(sl)] = 1.0
    ones = torch.ones_like(ys[1])
    if ys[0] is ys[1]:
        (want,) = torch.autograd.grad(ys[0], v, mask + ones)
    else:
        (want,) = torch.autograd.grad(ys, v, (mask, ones))
    assert _err(v.grad.numpy(), want.numpy()) < 1e-6


# ------------------------------------------------- wrapper by wrapper

def _fixed(*shapes, like):
    """Operands that a wrapper's test holds fixed (K4's filter or input,
    K9's row weight), from a seed of their own, in the dtype and on the
    device of the planes ``like``."""
    r = np.random.default_rng(99)
    return [torch.tensor(r.uniform(0.5, 1.5, s) if s == (64,)
                         else r.standard_normal(s), dtype=like.dtype,
                         device=like.device)
            for s in shapes]


# (name, fn(*planes), input shapes, whether the plain version takes
# float64, whether the test needs K5's small cap)
WRAPPERS = [
    ("K1", lambda a, b: fused_fft.sfft_fused(a, b, 60, False, 0.3),
     [(3, 60)] * 2, True, False),
    ("K1 inverse", lambda a, b: fused_fft.sfft_fused(a, b, 60, True, 0.3),
     [(3, 60)] * 2, True, False),
    ("K2", lambda a, b: stream_fft.sfft_stream_permuted(a, b, 2048, False),
     [(3, 2048)] * 2, True, False),
    ("K2 inverse",
     lambda a, b: stream_fft.sfft_stream_permuted(a, b, 2048, True),
     [(3, 2048)] * 2, True, False),
    ("K3", lambda a, b: stream_fft.sfft_stream(a, b, 2048, False, 0.5),
     [(3, 2048)] * 2, True, False),
    ("K3 inverse",
     lambda a, b: stream_fft.sfft_stream(a, b, 2048, True, 0.5),
     [(3, 2048)] * 2, True, False),
    ("K4 input", lambda x: stream_fft.sfilter_stream(
        x, *_fixed((2048,), (2048,), like=x), 2048, 0.5),
     [(4, 2048)], True, False),
    ("K4 filter", lambda fr, fi: stream_fft.sfilter_stream(
        _fixed((4, 2048), like=fr)[0], fr, fi, 2048, 0.5),
     [(2048,)] * 2, True, False),
    ("K5", lambda a, b: stream_fft.sfft_stream_split(a, b, 4096, False,
                                                       0.5),
     [(3, 4096)] * 2, True, True),
    ("K5 inverse",
     lambda a, b: stream_fft.sfft_stream_split(a, b, 4096, True, 0.5),
     [(3, 4096)] * 2, True, True),
    ("K4 split input", lambda x: stream_fft.sfilter_stream(
        x, *_fixed((4096,), (4096,), like=x), 4096, 0.5),
     [(4, 4096)], True, True),
    ("K4 split filter", lambda fr, fi: stream_fft.sfilter_stream(
        _fixed((4, 4096), like=fr)[0], fr, fi, 4096, 0.5),
     [(4096,)] * 2, True, True),
    ("K7 rfft", lambda x: rstream.srfft_stream(x, 2048, 0.5),
     [(4, 2048)], True, False),
    ("K7 irfft", lambda a, b: rstream.sirfft_stream(a, b, 2048, 0.5),
     [(4, 1025)] * 2, True, False),
    ("K7 dct2", lambda x: rstream.sdct2_stream(x, 2048, 0.5, 0.7),
     [(4, 2048)], True, False),
    ("K7 dct3", lambda x: rstream.sdct3_stream(x, 2048, 0.5, 1.3),
     [(4, 2048)], True, False),
    ("K8 dct4", lambda x: pdct._dct4_stream(x, 4096, 0.5, False),
     [(3, 4096)], True, False),
    ("K8 dst4", lambda x: pdct._dct4_stream(x, 4096, 0.5, True),
     [(3, 4096)], True, False),
    ("K6", lambda a, b: colfft.scolfft(a, b, False, 0.5),
     [(2, 64, 5)] * 2, False, False),
    ("K6 inverse", lambda a, b: colfft.scolfft(a, b, True, 0.5),
     [(2, 64, 5)] * 2, False, False),
    ("K9 dct2", lambda x: colfft.scoldct(
        x, 2, _fixed((64,), like=x)[0], 0.5), [(2, 64, 5)], False,
     False),
    ("K9 dct3", lambda x: colfft.scoldct(
        x, 3, _fixed((64,), like=x)[0], 0.5), [(2, 64, 5)], False,
     False),
    ("K9 dct2 unweighted", lambda x: colfft.scoldct(x, 2, None, 2.0),
     [(2, 64, 5)], False, False),
    ("K9 dct3 unweighted", lambda x: colfft.scoldct(x, 3),
     [(2, 64, 5)], False, False),
    ("K10", lambda a, b: fourstep_fft.sfft_fourstep(a, b, 1024, False),
     [(3, 1024)] * 2, False, False),
    ("K10 inverse",
     lambda a, b: fourstep_fft.sfft_fourstep(a, b, 1024, True),
     [(3, 1024)] * 2, False, False),
    ("K11", lambda a, b: stream_fft.sfft_mm2(a, b, 640, False),
     [(3, 640)] * 2, False, False),
    ("K11 inverse", lambda a, b: stream_fft.sfft_mm2(a, b, 640, True),
     [(3, 640)] * 2, False, False),
    ("K11 permuted",
     lambda a, b: stream_fft.sfft_mm2_permuted(a, b, 640, False),
     [(3, 640)] * 2, False, False),
    ("K11 permuted inverse",
     lambda a, b: stream_fft.sfft_mm2_permuted(a, b, 640, True),
     [(3, 640)] * 2, False, False),
] + [
    # K1's real modes (the real route of core.srfft and core.sirfft)
    entry for n in (960, 1024, 2048) for entry in (
        (f"K1 r2c {n}", lambda x, n=n: fused_fft.srfft_real(x, n, 0.3),
         [(3, n)], True, False),
        (f"K1 c2r {n}",
         lambda a, b, n=n: fused_fft.sirfft_real(a, b, n, 0.3),
         [(3, n // 2 + 1)] * 2, True, False))
] + [
    # K1's interleaved complex mode (the route of fft and ifft), on the
    # complex tensor of the two planes, its result as planes
    (f"K1 cplx{' inverse' if inverse else ''} {n}",
     lambda a, b, n=n, inverse=inverse: _cplx_planes(a, b, n, inverse),
     [(3, n)] * 2, True, False)
    for n in (960, 1024) for inverse in (False, True)
] + [
    # the step's filter map, in the planes and in the filter apart (as
    # K4), with the filter conjugated, and the filter gradient's row sums
    # (the map a double backward runs) in the cotangent and the spectrum
    ("cmul planes", lambda a, b: cmul.spectral_mul(
        a, b, *_fixed((481,), (481,), like=a)),
     [(3, 481)] * 2, True, False),
    ("cmul filter", lambda c, d: cmul.spectral_mul(
        *_fixed((3, 481), (3, 481), like=c), c, d),
     [(481,)] * 2, True, False),
    ("cmul conj planes", lambda a, b: cmul.spectral_mul(
        a, b, *_fixed((17,), (17,), like=a), True),
     [(5, 17)] * 2, True, False),
    ("cmul conj filter", lambda c, d: cmul.spectral_mul(
        *_fixed((5, 17), (5, 17), like=c), c, d, True),
     [(17,)] * 2, True, False),
    ("cmul sums", lambda a, b: cmul.cmul_sums(
        a, b, *_fixed((5, 17), (5, 17), like=a)),
     [(5, 17)] * 2, True, False),
    ("cmul sums spectrum", lambda c, d: cmul.cmul_sums(
        *_fixed((5, 17), (5, 17), like=c), c, d),
     [(5, 17)] * 2, True, False),
]
WNAMES = [w[0] for w in WRAPPERS]


def _cplx_planes(a, b, n: int, inverse: bool):
    """``fused_fft.cfft_interleaved`` at scale 0.3 on the complex tensor
    ``torch.complex(a, b)`` (complex64 from float32 planes, complex128
    from float64), returned as its two planes."""
    y = fused_fft.cfft_interleaved(torch.complex(a, b), n, inverse, 0.3)
    return tuple(torch.view_as_real(y).unbind(-1))


def _wrapper(name: str, monkeypatch):
    """(fn, input shapes) of a wrapper, with K5's cap lowered to m = 16
    where the test needs the split at n = 4096 (s = 2)."""
    fn, shapes, _, cap = WRAPPERS[WNAMES.index(name)][1:]
    if cap:
        monkeypatch.setattr(stream_fft, "_MAX_M", 16)
    return fn, shapes


@pytest.mark.parametrize("name", WNAMES)
def test_wrapper_dot_product_identity(name, monkeypatch):
    """<A x, g> = <x, A^T g> with A^T g from the Function's backward, in
    float32, to 1e-5 of ||A x|| ||g|| (sums in float64)."""
    fn, shapes = _wrapper(name, monkeypatch)
    r = np.random.default_rng(WNAMES.index(name))
    xs = [torch.tensor(r.standard_normal(s), dtype=torch.float32,
                       requires_grad=True) for s in shapes]
    ys = fn(*xs)
    ys = ys if isinstance(ys, tuple) else (ys,)
    assert all(y.grad_fn is not None for y in ys)
    gs = [torch.tensor(r.standard_normal(tuple(y.shape)),
                       dtype=torch.float32) for y in ys]
    sum((g * y).sum() for g, y in zip(gs, ys)).backward()
    lhs = sum(float((g.double() * y.detach().double()).sum())
              for g, y in zip(gs, ys))
    rhs = sum(float((x.detach().double() * x.grad.double()).sum())
              for x in xs)
    norm = (np.sqrt(sum(float((y.detach().double() ** 2).sum())
                        for y in ys))
            * np.sqrt(sum(float((g.double() ** 2).sum()) for g in gs)))
    assert abs(lhs - rhs) < 1e-5 * norm, (lhs, rhs, norm)


@pytest.mark.parametrize("name", [w[0] for w in WRAPPERS if w[3]])
def test_wrapper_gradcheck(name, monkeypatch):
    """gradcheck in float64 through the plain version: the backward is
    the derivative of the forward, the imaginary DC and Nyquist bins of
    K7's irfft and K4's filter included (fast mode: a random projection
    of the Jacobian)."""
    fn, shapes = _wrapper(name, monkeypatch)
    r = np.random.default_rng(WNAMES.index(name))
    xs = [torch.tensor(r.standard_normal(s), requires_grad=True)
          for s in shapes]
    assert torch.autograd.gradcheck(fn, xs, fast_mode=True)


@pytest.mark.parametrize("name", ["K1", "K3", "K7 irfft", "K7 dct2",
                                  "K8 dst4", "K9 dct3", "K1 r2c 960",
                                  "K1 c2r 960", "K1 r2c 1024",
                                  "K1 c2r 1024", "K1 r2c 2048",
                                  "K1 c2r 2048", "K1 cplx 960",
                                  "K1 cplx inverse 1024", "cmul planes",
                                  "cmul filter", "cmul conj filter",
                                  "cmul sums", "cmul sums spectrum"])
def test_wrapper_gradient_matches_plain_autograd(name, monkeypatch):
    """The Function's backward equals autograd through the plain version
    (the gradient the CPU path gave before), in float32."""
    def grads(fn, shapes):
        r = np.random.default_rng(5)
        xs = [torch.tensor(r.standard_normal(s), dtype=torch.float32,
                           requires_grad=True) for s in shapes]
        ys = fn(*xs)
        ys = ys if isinstance(ys, tuple) else (ys,)
        sum((torch.tensor(r.standard_normal(tuple(y.shape)),
                          dtype=torch.float32) * y).sum()
            for y in ys).backward()
        return [x.grad.numpy() for x in xs]

    fn, shapes = _wrapper(name, monkeypatch)
    got = grads(fn, shapes)
    monkeypatch.setattr(_adjoint, "needs_grad", lambda *t: False)
    want = grads(fn, shapes)
    for a, b in zip(got, want):
        assert _err(a, b) < 1e-5


@pytest.mark.parametrize("n", [960, 1024, 2048])
def test_real_maps_match_jax_vjp(n):
    """K1's real modes under autograd against ``jax.vjp`` of the JAX
    package's unscaled ``srfft`` and ``sirfft`` in float64 (times the
    scale), at 1e-12 of max |g|: the r2c map's adjoint (c2r with the
    transposed set) and the c2r map's, which gives the imaginary DC and
    Nyquist bins the gradients of the JAX package's c2r."""
    from cfftpack_tpu.ops import core as jcore
    h = n // 2
    r = np.random.default_rng(n)
    x = r.standard_normal((3, n))
    yr, yi = r.standard_normal((2, 3, h + 1))
    gr, gi = r.standard_normal((2, 3, h + 1))
    g = r.standard_normal((3, n))

    def vjps(x, yr, yi, gr, gi, g):
        _, f = jax.vjp(lambda v: jcore.srfft(v, n), x)
        _, b = jax.vjp(lambda a, c: jcore.sirfft(a, c, n), yr, yi)
        return f((gr, gi)) + b(g)

    want = jax.jit(vjps)(x, yr, yi, gr, gi, g)
    s = 0.3
    xt = torch.tensor(x, requires_grad=True)
    got = torch.autograd.grad(fused_fft.srfft_real(xt, n, s),
                              xt, (torch.tensor(gr), torch.tensor(gi)))
    at, bt = (torch.tensor(a, requires_grad=True) for a in (yr, yi))
    got += torch.autograd.grad(fused_fft.sirfft_real(at, bt, n, s),
                               (at, bt), torch.tensor(g))
    for a, b in zip(got, want):
        assert _err(a.numpy(), s * np.asarray(b)) < 1e-12


@pytest.mark.parametrize("n", [960, 1024])
def test_cplx_map_matches_jax_vjp(n):
    """K1's interleaved complex mode under autograd (``fft`` and ``ifft``
    of complex128 rows at a register length) against ``jax.vjp`` of the
    JAX package's ``fft`` and ``ifft`` at 1e-12 of max |g|.  ``jax.vjp``
    pulls a cotangent back through the transpose of the linear map and
    PyTorch through its conjugate transpose, so the gradient for the
    cotangent g is conj(vjp(conj g))."""
    r = np.random.default_rng(n)
    x, g = (r.standard_normal((3, n)) + 1j * r.standard_normal((3, n))
            for _ in range(2))
    for name in ("fft", "ifft"):
        _, pull = jax.vjp(getattr(ct, name), x)
        (want,) = pull(np.conj(g))
        want = np.conj(np.asarray(want))
        xt = torch.tensor(x, requires_grad=True)
        before = profiling.complex_maps["interleaved"]
        (got,) = torch.autograd.grad(getattr(pt, name)(xt), xt,
                                     torch.tensor(g))
        assert profiling.complex_maps["interleaved"] == before + 1
        got = got.numpy()
        assert got.dtype == np.complex128
        assert (np.abs(got - want).max() / np.abs(want).max()) < 1e-12, name


@pytest.mark.parametrize("dtype, n, bar", [(torch.float64, 60, 1e-12),
                                           (torch.float32, 32768, 1e-5)])
def test_hessian_vector_product_through_dct(dtype, n, bar):
    """L = ||dct(x, ortho)||^2 has the Hessian 2I: a double backward through
    the Function (K1 at n = 60, K7's DCT-II and DCT-III at 32768) gives
    H v = 2v."""
    r = np.random.default_rng(n)
    x = torch.tensor(r.standard_normal((2, n)), dtype=dtype,
                     requires_grad=True)
    v = torch.tensor(r.standard_normal((2, n)), dtype=dtype)
    (g,) = torch.autograd.grad((pt.dct(x, 2, norm="ortho") ** 2).sum(), x,
                               create_graph=True)
    assert g.grad_fn is not None
    (hv,) = torch.autograd.grad((g * v).sum(), x)
    assert _err(hv.numpy(), 2 * v.numpy()) < bar


# --------------------------------------------- the inference path

def test_no_apply_without_grad(monkeypatch):
    """With no input requiring grad, or under no_grad, no wrapper enters
    the Function and no result has a grad_fn; with one, each does."""
    calls = []
    orig = _adjoint._Map.apply

    def spy(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(_adjoint._Map, "apply", spy)
    for name in (nm for nm in NAMES if not nm.endswith("2^20")):
        e, ins, _ = _case(name)
        for mode in ("off", "no_grad"):
            planes = [torch.from_numpy(a).requires_grad_(mode == "no_grad")
                      for a in ins]
            with torch.set_grad_enabled(mode == "off"):
                outs = _planes(e[3](pt, *planes))
            assert all(o.grad_fn is None for o in outs), (name, mode)
        assert not calls, name
    for fn, shapes, _, cap in (w[1:] for w in WRAPPERS):
        if cap:
            continue
        xs = [torch.zeros(s, dtype=torch.float32, requires_grad=True)
              for s in shapes]
        with torch.no_grad():
            fn(*xs)
    assert not calls
    e, ins, _ = _case("fft_split")
    planes = [torch.from_numpy(a).requires_grad_() for a in ins]
    outs = _planes(e[3](pt, *planes))
    assert calls and all(o.grad_fn is not None for o in outs)


def test_flagship_step_entry_gradient():
    """``entry.step`` itself, at the JAX entry's inputs (batch 64, n =
    960), against jax.grad of ``__graft_entry__.entry``'s step for the
    three inputs."""
    import __graft_entry__
    jstep, jargs = __graft_entry__.entry()
    r = np.random.default_rng(11)
    w = r.standard_normal((64, 960)).astype(np.float32)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(w * jstep(*a)),
                            argnums=(0, 1, 2)))(*jargs)
    args = [torch.from_numpy(np.array(a)).requires_grad_() for a in jargs]
    (torch.from_numpy(w) * pt_step(*args)).sum().backward()
    for a, b in zip(args, want):
        assert _err(a.grad.numpy(), np.asarray(b)) < 1e-4


# ----------------------------------------------------------- the card

@pytest.mark.cuda
def test_backward_on_card_matches_cpu():
    """Each wrapper's backward on the card (its kernels) against the same
    backward on the CPU (the plain versions), in float32; K5 at its full
    length is in chip_smoke.py's phase 36."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for name, fn, shapes, _, cap in WRAPPERS:
        if cap:
            continue
        r = np.random.default_rng(WNAMES.index(name))
        data = [r.standard_normal(s).astype(np.float32) for s in shapes]
        grads = []
        for dev in ("cpu", "cuda"):
            xs = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in data]
            ys = fn(*xs)
            ys = ys if isinstance(ys, tuple) else (ys,)
            rr = np.random.default_rng(1)
            sum((torch.tensor(rr.standard_normal(tuple(y.shape)),
                              dtype=torch.float32, device=dev) * y).sum()
                for y in ys).backward()
            grads.append([x.grad.cpu().numpy() for x in xs])
        torch.cuda.synchronize()
        for a, b in zip(*grads):
            assert _err(b, a) < 1e-5, name
