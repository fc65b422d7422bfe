"""The step's filter map (``ops.cmul``): its plain version, its adjoint
and the route to it in ``ops.core``, on the CPU.

* The plain version, and ``core.spectral_mul`` through the wrapper's
  Function, against the step's two-line expression at (rows, h1) of
  (7, 1), (5, 2), (3, 481), (64, 17) in float32 and float64.
* The adjoint identity <M(s, F), g> = <s, M_s^T g> = <F, M_F^T g> in each
  argument, for the filter and its conjugate.
* The gradients for every subset of (sr, si, fr, fi) that requires grad
  against ``torch.autograd`` of the expression.
* A Hessian-vector product through ``entry.step`` at batch 4 against
  ``jax.jvp`` of ``jax.grad`` of ``__graft_entry__``'s step.
* The route: ``core.spectral_mul`` sends eligible inputs to the C entry
  (a recorder here, as ``test_torch_tracing.py``'s ``k1_entry``) and
  takes the plain expression for other dtypes, per-row or broadcast
  filters, strided or misaligned views; the launch refuses a CPU tensor.
"""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfftpack_tpu_torch.entry import step as pt_step
from cfftpack_tpu_torch.ops import _build, cmul, core
from cfftpack_tpu_torch.utils import profiling

torch.set_num_threads(1)

SHAPES = [(7, 1), (5, 2), (3, 481), (64, 17)]
DTYPES = [torch.float32, torch.float64]
BAR = {torch.float32: 1e-6, torch.float64: 1e-13}


def _expr(sr, si, fr, fi):
    return sr * fr - si * fi, sr * fi + si * fr


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def r(s):
        return torch.randn(s, generator=g, dtype=dtype)
    return r(shape), r(shape), r(shape[-1:]), r(shape[-1:])


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_expression(shape, dtype):
    sr, si, fr, fi = _inputs(shape, dtype, sum(shape))
    want = _expr(sr, si, fr, fi)
    for got in (cmul.cmul_plain(sr, si, fr, fi),
                cmul.spectral_mul(sr, si, fr, fi),
                core.spectral_mul(sr, si, fr, fi)):
        assert all(g.dtype == dtype and g.shape == sr.shape for g in got)
        assert max(_rel(a, b) for a, b in zip(got, want)) < BAR[dtype]
    got = cmul.cmul_plain(sr, si, fr, fi, conj=True)
    want = _expr(sr, si, fr, -fi)
    assert max(_rel(a, b) for a, b in zip(got, want)) < BAR[dtype]


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_adjoint_identity(shape, dtype, conj):
    """<M(s, F), g> = <s, g_s> = <F, g_F>: the map is linear in s and in F
    apart, and its backward gives both adjoints (sums in float64)."""
    sr, si, fr, fi = _inputs(shape, dtype, 10 + sum(shape))
    gr, gi, _, _ = _inputs(shape, dtype, 20 + sum(shape))
    xs = [t.clone().requires_grad_() for t in (sr, si, fr, fi)]
    tr, ti = cmul.spectral_mul(*xs, conj)
    ((gr * tr).sum() + (gi * ti).sum()).backward()

    def dot(*pairs):
        return sum(float((a.double() * b.double()).sum()) for a, b in pairs)

    tr, ti = tr.detach(), ti.detach()
    lhs = dot((gr, tr), (gi, ti))
    in_s = dot((sr, xs[0].grad), (si, xs[1].grad))
    in_f = dot((fr, xs[2].grad), (fi, xs[3].grad))
    norm = float(torch.sqrt((tr.double() ** 2 + ti.double() ** 2).sum())
                 * torch.sqrt((gr.double() ** 2 + gi.double() ** 2).sum()))
    bar = 1e-5 if dtype == torch.float32 else 1e-12
    assert abs(lhs - in_s) < bar * norm and abs(lhs - in_f) < bar * norm
    plain = cmul.adjoint_plain(gr, gi, sr, si, fr, fi, conj, True)
    for got, want in zip([x.grad for x in xs], plain):
        assert _rel(got, want) < BAR[dtype]


NEEDS = [n for n in itertools.product((False, True), repeat=4) if any(n)]


@pytest.mark.parametrize("needs", NEEDS,
                         ids=["".join("sSfF"[i] if n else "-"
                                      for i, n in enumerate(nd))
                              for nd in NEEDS])
def test_gradients_for_every_needs_subset(needs):
    """The Function's backward for each subset of (sr, si, fr, fi) that
    requires grad against autograd of the expression, in both dtypes at
    (64, 17) and (3, 481)."""
    for dtype, shape in itertools.product(DTYPES, [(64, 17), (3, 481)]):
        ins = _inputs(shape, dtype, 30)
        cots = _inputs(shape, dtype, 31)[:2]
        grads = []
        for fn in (core.spectral_mul, _expr):
            xs = [t.clone().requires_grad_(n) for t, n in zip(ins, needs)]
            out = fn(*xs)
            grads.append(torch.autograd.grad(
                out, [x for x in xs if x.requires_grad], cots))
        for got, want in zip(*grads):
            assert got.shape == want.shape and got.dtype == dtype
            assert _rel(got, want) < (1e-5 if dtype == torch.float32
                                      else 1e-12), (dtype, shape)
    xs = [t.clone().requires_grad_(n) for t, n in zip(ins, needs)]
    out = core.spectral_mul(*xs)
    assert all(o.grad_fn is not None for o in out)


@pytest.mark.parametrize("dtype, bar", [(np.float32, 1e-4),
                                        (np.float64, 1e-10)])
def test_hessian_vector_product_through_the_step(dtype, bar):
    """H u of L = sum(w * step(v, phi_r, phi_i)) at batch 4: a second
    derivative through the step's K1 real maps and the filter's map (its
    adjoint composed of the forward map and the row sums under grad mode)
    against ``jax.jvp`` of ``jax.grad`` of ``__graft_entry__``'s step."""
    import __graft_entry__
    jstep, _ = __graft_entry__.entry()
    r = np.random.default_rng(26)
    v = r.standard_normal((4, 960)).astype(dtype)
    phase = r.standard_normal(481)
    fr, fi = np.cos(phase).astype(dtype), np.sin(phase).astype(dtype)
    w = r.standard_normal((4, 960)).astype(dtype)
    tangent = [r.standard_normal(a.shape).astype(dtype) for a in (v, fr, fi)]

    def loss(*a):
        return jnp.sum(w * jstep(*a))

    def hvp(x, u):
        return jax.jvp(jax.grad(loss, argnums=(0, 1, 2)), x, u)[1]

    want = jax.jit(hvp)((v, fr, fi), tuple(tangent))
    xs = [torch.from_numpy(a).requires_grad_() for a in (v, fr, fi)]
    g = torch.autograd.grad((torch.from_numpy(w) * pt_step(*xs)).sum(), xs,
                            create_graph=True)
    assert all(t.grad_fn is not None for t in g)
    hv = torch.autograd.grad(
        sum((a * torch.from_numpy(u)).sum() for a, u in zip(g, tangent)),
        xs, allow_unused=True)
    for got, ref, x in zip(hv, want, xs):
        got = torch.zeros_like(x) if got is None else got
        ref = np.asarray(ref)
        assert got.dtype == x.dtype
        err = np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max()
        assert err < bar, err


# ------------------------------------------------------------ the route

@pytest.fixture
def cmul_entry(monkeypatch):
    """The C entries of cmul as a recorder on CPU tensors: the wrapper
    takes its launch for a CPU tensor, and ``_build.call`` counts as on
    the card; the registry is restored after."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(cmul_f32=record, cmul_f64=record,
                                cmul_adj_f32=record, cmul_adj_f64=record)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "_enter",
                        lambda fn, dev, args: fn(*args, None))
    monkeypatch.setattr(cmul, "_check", lambda *a: None)
    monkeypatch.setattr(cmul, "_sms", lambda device: 132)
    monkeypatch.setattr(cmul, "cmul_plain", cmul._launch)
    monkeypatch.setattr(profiling, "launches",
                        dict.fromkeys(profiling.KERNELS, 0))
    return calls


def _route_case(kind):
    """(sr, si, fr, fi) of each input kind, and whether the kernel takes
    it."""
    sr, si, fr, fi = _inputs((3, 481), torch.float32, 40)
    wide = torch.randn(3, 962)
    if kind == "float32":
        return (sr, si, fr, fi), True
    if kind == "float64":
        return tuple(t.double() for t in (sr, si, fr, fi)), True
    if kind == "leading axes":
        return (sr.reshape(3, 1, 481).expand(3, 2, 481).contiguous(),
                si.reshape(3, 1, 481).expand(3, 2, 481).contiguous(),
                fr, fi), True
    if kind == "float16":
        return tuple(t.half() for t in (sr, si, fr, fi)), False
    if kind == "mixed dtypes":
        return (sr, si, fr.double(), fi.double()), False
    if kind == "per-row filter":
        return (sr, si, sr + 1, si + 1), False
    if kind == "broadcast filter":
        return (sr, si, fr[None], fi[None]), False
    if kind == "broadcast planes":
        return (sr[:1], si, fr, fi), False
    if kind == "strided planes":
        return (wide[:, ::2][:, :481], si, fr, fi), False
    if kind == "transposed planes":
        return (sr.t().contiguous().t(), si, fr, fi), False
    if kind == "misaligned planes":
        flat = torch.randn(3 * 481 + 1)
        return (flat[1:].view(3, 481), si, fr, fi), False
    return (sr, si, wide[0, ::2][:481], fi), False      # strided filter


ROUTE_KINDS = ["float32", "float64", "leading axes", "float16",
               "mixed dtypes", "per-row filter", "broadcast filter",
               "broadcast planes", "strided planes", "transposed planes",
               "misaligned planes", "strided filter"]


@pytest.mark.parametrize("kind", ROUTE_KINDS)
def test_route_by_dtype_shape_rank_and_layout(kind, cmul_entry):
    """Eligible inputs reach the C entry once, with their own pointers, the
    flat length, h1 and the grid; every other kind takes the plain
    expression and reaches no entry."""
    (sr, si, fr, fi), kernel = _route_case(kind)
    assert cmul.cmul_eligible(sr, si, fr, fi) == kernel
    tr, ti = core.spectral_mul(sr, si, fr, fi)
    assert tr.shape == ti.shape == torch.broadcast_shapes(
        *(t.shape for t in (sr, si, fr, fi)))
    if kernel:
        (call,) = cmul_entry
        assert call[:4] == tuple(t.data_ptr() for t in (sr, si, fr, fi))
        assert call[4:6] == (tr.data_ptr(), ti.data_ptr())
        assert call[6:9] == (sr.numel(), 481, 0) and call[9] >= 1
        assert call[-1] is None
        assert {k: v for k, v in profiling.launches.items() if v} == {
            "cmul": 1}
    else:
        assert not cmul_entry and profiling.launches["cmul"] == 0
        want = _expr(sr, si, fr, fi)
        assert all(torch.equal(a, b) for a, b in zip((tr, ti), want))


def test_adjoint_entry_gets_strips_and_scratch(cmul_entry, monkeypatch):
    """Both gradients wanted: one call of the adjoint entry with the strips
    of groups of 4 float32 rows over 132 blocks and the float64 scratch of
    their slots; the filter's alone: no plane pointers."""
    monkeypatch.setattr(cmul, "adjoint_plain", cmul._adj_launch)
    sr, si, fr, fi = _inputs((1000, 481), torch.float32, 41)
    xs = [t.clone().requires_grad_() for t in (sr, si, fr, fi)]
    out = core.spectral_mul(*xs)
    torch.autograd.grad(out, xs, _inputs((1000, 481), torch.float32, 42)[:2])
    fwd, adj = cmul_entry
    assert len(fwd) == 11 and len(adj) == 18
    blocks, per_block, threads = adj[14:17]
    assert adj[11:14] == (1000, 481, 0) and threads == 512
    assert per_block == 2 and blocks == 125        # 250 groups of 4 rows
    assert all(p is not None for p in adj[4:11])
    xs = [t.clone().requires_grad_(n)
          for t, n in zip((sr, si, fr, fi), (False, False, True, True))]
    torch.autograd.grad(core.spectral_mul(*xs), xs[2:],
                        _inputs((1000, 481), torch.float32, 43)[:2])
    adj = cmul_entry[-1]
    assert adj[4:8] == (None,) * 4 and adj[8] is not None


def test_launch_refuses_a_cpu_tensor():
    sr, si, fr, fi = _inputs((3, 481), torch.float32, 44)
    with pytest.raises(ValueError, match="CUDA"):
        cmul._launch(sr, si, fr, fi)
    with pytest.raises(ValueError, match="CUDA"):
        cmul._adj_launch(sr, si, sr, si, fr, fi, False, True)
