"""Gradients through the parallel layer (``cfftpack_tpu_torch.parallel``)
at D = 2 and 4 gloo ranks on the CPU.

Every all-to-all of the layer is ``_comm.all_to_all_tiled``, recorded
under autograd as ``_comm._AllToAll``, whose backward is the exchange
with the two axes swapped; the layer's local passes go through the
kernels' own ``torch.autograd.Function`` (``ops/_adjoint.py``).

Each D is one ``torch.multiprocessing.spawn`` (a module-scoped fixture):
every rank takes its block of each case's seeded global input (the JAX
function's ``PartitionSpec`` at the rank's mesh coordinate) with
``requires_grad``, and its block of a seeded global cotangent w, runs
``backward`` on sum(w * y) over each real plane of its output and saves
its gradient blocks and the collectives of the forward and of forward
and backward.  The parent joins the blocks and holds them against
``jax.grad`` of sum(w * f(x)) for the JAX package's function on a
D-device sub-mesh of the conftest's virtual devices: 1e-12 of max |g| in
float64, 1e-4 in float32 (the bars of ``tests/test_torch_grad.py``).
One jitted JAX program computes the gradients of a group of cases.

The exchange alone: the dot-product identity <A x, g> = <x, A^T g>
summed over ranks, ``gradcheck``, its collectives, an ignored output
plane, a rank whose loss is ``(y * 0).sum()``; and a Hessian-vector
product through ``fft2_sharded_split``, the chunked four-step against
the unchunked one, and that no ``apply`` runs without grad.  JAX is
imported in the parent only.
"""
import socket
from dataclasses import dataclass
from functools import partial

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cfftpack_tpu_torch import parallel as tp
from cfftpack_tpu_torch.parallel import _comm
from cfftpack_tpu_torch.parallel._comm import (all_to_all_tiled,
                                             count_collectives)
from cfftpack_tpu_torch.parallel.fourstep_split import _split

BARS = {np.float64: 1e-12, np.float32: 1e-4}
N4 = 1024                                  # the four-step's length
N1, N2 = 32, 32                            # _split(1024, D) at D = 2, 4


def _cx(a, b):
    if isinstance(a, torch.Tensor):
        return torch.complex(a, b)
    import jax
    return jax.lax.complex(a, b)


def _planes(y) -> list:
    """The real planes of a result: a tuple's members, a complex array's
    real and imaginary parts."""
    if isinstance(y, (tuple, list)):
        return [p for t in y for p in _planes(t)]
    if isinstance(y, torch.Tensor):
        return [y.real, y.imag] if y.is_complex() else [y]
    import jax.numpy as jnp
    return [jnp.real(y), jnp.imag(y)] if jnp.iscomplexobj(y) else [y]


def _real(*shape):
    return lambda r: [r.standard_normal(shape)]


def _pair(*shape):
    return lambda r: [r.standard_normal(shape), r.standard_normal(shape)]


@dataclass(frozen=True)
class Case:
    """One function of the layer: its global inputs (real planes), how a
    rank's input and output blocks are cut (``in_l``, ``out_l``), the
    call on the port (``fn(tp, mesh, *planes)``) and on the JAX package
    (``fn(jp, mesh, *planes)``), and the seed of its inputs and
    cotangents."""
    name: str
    group: str
    dtype: type
    inputs: object
    in_l: str
    out_l: str
    fn: object
    seed: int
    mesh2: bool = False


def _fourstep_cases():
    cases = []
    for reorder in (False, True):
        for c in (1, 2):
            # the chunked and the unchunked form share their inputs
            seed = 100 + 10 * reorder
            cases.append(Case(
                f"fft_fourstep reorder={reorder} overlap_chunks={c}",
                "fourstep", np.float64, _pair(2, N4), "slab",
                "last" if reorder else "rows",
                lambda m, mesh, a, b, reorder=reorder, c=c: m.fft_fourstep(
                    _cx(a, b), mesh, reorder=reorder, overlap_chunks=c),
                seed))
            cases.append(Case(
                f"ifft_fourstep reordered={reorder} overlap_chunks={c}",
                "fourstep", np.float64,
                _pair(2, N4) if reorder else _pair(2, N1, N2),
                "last" if reorder else "rows", "slab",
                lambda m, mesh, a, b, reorder=reorder, c=c: m.ifft_fourstep(
                    _cx(a, b), mesh, reordered=reorder, overlap_chunks=c),
                seed + 1))
        cases.append(Case(
            f"fft_fourstep_split reorder={reorder}", "fourstep", np.float64,
            _pair(2, N4), "slab", "last" if reorder else "rows",
            lambda m, mesh, a, b, reorder=reorder: m.fft_fourstep_split(
                a, b, mesh, reorder=reorder), 120 + reorder))
        cases.append(Case(
            f"ifft_fourstep_split reordered={reorder}", "fourstep",
            np.float64, _pair(2, N4) if reorder else _pair(2, N1, N2),
            "last" if reorder else "rows", "slab",
            lambda m, mesh, a, b, reorder=reorder: m.ifft_fourstep_split(
                a, b, mesh, norm="ortho", reordered=reorder), 130 + reorder))
    cases.append(Case(
        "fft_fourstep_split float32 ortho n=4096", "fourstep", np.float32,
        _pair(4096), "slab", "rows",
        lambda m, mesh, a, b: m.fft_fourstep_split(a, b, mesh, norm="ortho",
                                                   reorder=False), 140))
    return cases


def _fft2_cases():
    cases = []
    for inv in (False, True):
        pre = "i" if inv else ""
        cases.append(Case(
            f"{pre}fft2_sharded (2, 32, 48)", "fft2", np.float64,
            _pair(2, 32, 48), "rows", "rows",
            lambda m, mesh, a, b, pre=pre: getattr(m, f"{pre}fft2_sharded")(
                _cx(a, b), mesh), 200 + inv))
        cases.append(Case(
            f"{pre}fft2_sharded_split (2, 32, 48) ortho", "fft2", np.float64,
            _pair(2, 32, 48), "rows", "rows",
            lambda m, mesh, a, b, pre=pre: getattr(
                m, f"{pre}fft2_sharded_split")(a, b, mesh, norm="ortho"),
            210 + inv))
    cases.append(Case(
        "fft2_sharded_split float32 (2, 16, 32)", "fft2", np.float32,
        _pair(2, 16, 32), "rows", "rows",
        lambda m, mesh, a, b: m.fft2_sharded_split(a, b, mesh), 220))
    # n1 = 24 and 13: 13 and 7 bins, padded to a multiple of D
    for n1 in (24, 13):
        h = n1 // 2 + 1
        cases += [
            Case(f"rfft2_sharded (16, {n1})", "fft2", np.float64,
                 _real(16, n1), "rows", "rows",
                 lambda m, mesh, x: m.rfft2_sharded(x, mesh), 230 + n1),
            Case(f"rfft2_sharded_split (16, {n1}) ortho", "fft2", np.float64,
                 _real(16, n1), "rows", "rows",
                 lambda m, mesh, x: m.rfft2_sharded_split(x, mesh,
                                                          norm="ortho"),
                 260 + n1),
            Case(f"irfft2_sharded (16, {h}) n1={n1}", "fft2", np.float64,
                 _pair(16, h), "rows", "rows",
                 lambda m, mesh, a, b, n1=n1: m.irfft2_sharded(
                     _cx(a, b), n1, mesh), 290 + n1),
            Case(f"irfft2_sharded_split (16, {h}) n1={n1} ortho", "fft2",
                 np.float64, _pair(16, h), "rows", "rows",
                 lambda m, mesh, a, b, n1=n1: m.irfft2_sharded_split(
                     a, b, n1, mesh, norm="ortho"), 320 + n1)]
    cases.append(Case(
        "fft2_sharded_split (2, 16, 32) on (data, model)", "fft2",
        np.float64, _pair(2, 16, 32), "mesh2", "mesh2",
        lambda m, mesh, a, b: m.fft2_sharded_split(
            a, b, mesh, axis_name="model", batch_axis_name="data"), 360,
        mesh2=True))
    return cases


def _jax_trig(name, t):
    def fn(a):
        import cfftpack_tpu as ct
        return getattr(ct, name)(a, t)
    return fn


_JAX_DCT2 = _jax_trig("dct", 2)
_JAX_DST2 = _jax_trig("dst", 2)


def _rowcol_pair(m, mesh, x):
    if m is tp:
        from cfftpack_tpu_torch.ops import dct, dst
        return tp.rowcol2d_sharded(x, mesh, partial(dct, type=2),
                                   partial(dst, type=2))
    return m.rowcol2d_sharded(x, mesh, _JAX_DCT2, _JAX_DST2)


def _rowcol_cases():
    cases = []
    for kind in ("dctn2_sharded", "dstn2_sharded"):
        for t in (1, 2, 3, 4):
            cases.append(Case(
                f"{kind} type {t}", "rowcol", np.float64, _real(16, 16),
                "rows", "rows",
                lambda m, mesh, x, kind=kind, t=t: getattr(m, kind)(
                    x, mesh, type=t), 400 + 10 * len(kind) + t))
        inv = "i" + kind
        cases.append(Case(
            f"{inv} type 2 ortho", "rowcol", np.float64, _real(2, 16, 16),
            "rows", "rows",
            lambda m, mesh, x, inv=inv: getattr(m, inv)(x, mesh, type=2,
                                                        norm="ortho"),
            500 + len(kind)))
    cases.append(Case("rowcol2d_sharded dct type 2, dst type 2", "rowcol",
                      np.float64, _real(16, 16), "rows", "rows",
                      _rowcol_pair, 520))
    cases.append(Case(
        "dctn2_sharded (4, 16, 16) on (data, model)", "rowcol", np.float64,
        _real(4, 16, 16), "mesh2", "mesh2",
        lambda m, mesh, x: m.dctn2_sharded(x, mesh, type=2,
                                           axis_name="model",
                                           batch_axis_name="data"), 530,
        mesh2=True))
    return cases


def _hp(name):
    """The port's float64 batch form; the JAX package's runs the
    double-float engine through host numpy, which jax.grad cannot trace:
    its complex128 batch form is the same function."""
    def fn(m, mesh, *p):
        x = _cx(*p) if len(p) == 2 else p[0]
        return getattr(m, name if m is tp else name[:-3])(x, mesh)
    return fn


def _batch_cases():
    return [
        Case("pfft (8, 60)", "batch", np.float64, _pair(8, 60), "batch",
             "batch", lambda m, mesh, a, b: m.pfft(_cx(a, b), mesh), 600),
        Case("pifft (8, 60) ortho", "batch", np.float64, _pair(8, 60),
             "batch", "batch",
             lambda m, mesh, a, b: m.pifft(_cx(a, b), mesh, norm="ortho"),
             601),
        Case("prfft (8, 32)", "batch", np.float64, _real(8, 32), "batch",
             "batch", lambda m, mesh, x: m.prfft(x, mesh), 602),
        Case("pirfft (8, 17) n=32", "batch", np.float64, _pair(8, 17),
             "batch", "batch",
             lambda m, mesh, a, b: m.pirfft(_cx(a, b), 32, mesh), 603),
        Case("pdct type 2 (8, 32)", "batch", np.float64, _real(8, 32),
             "batch", "batch", lambda m, mesh, x: m.pdct(x, 2, mesh), 604),
        Case("pfft_hp (8, 24)", "batch", np.float64, _pair(8, 24), "whole",
             "batch", _hp("pfft_hp"), 605),
        Case("pifft_hp (8, 24)", "batch", np.float64, _pair(8, 24), "whole",
             "batch", _hp("pifft_hp"), 606),
        Case("prfft_hp (8, 16)", "batch", np.float64, _real(8, 16), "whole",
             "batch", _hp("prfft_hp"), 607)]


CASES = _fourstep_cases() + _fft2_cases() + _rowcol_cases() + _batch_cases()
NAMES = [c.name for c in CASES]
assert len(set(NAMES)) == len(NAMES)
CASE = dict(zip(NAMES, CASES))


# ------------------------------------------------------------- layouts

def _coords(layout: str, d: int, r: int):
    """(axis, parts, index) of each sharded axis of a block."""
    return {"slab": [(-1, d, r)], "rows": [(-2, d, r)], "last": [(-1, d, r)],
            "batch": [(0, d, r)], "whole": [],
            "mesh2": [(0, d // 2, r // 2), (-2, 2, r % 2)]}[layout]


def _cut(layout: str, x: torch.Tensor, d: int, r: int) -> torch.Tensor:
    """Rank r's block of the global ``x``."""
    if layout == "slab":
        n = x.shape[-1]
        n1, n2 = _split(n, d)
        w = n2 // d
        lead = x.shape[:-1]
        return x.reshape(lead + (n1, n2))[..., r * w:(r + 1) * w].reshape(
            lead + (n1 * w,))
    for axis, parts, i in _coords(layout, d, r):
        b = x.shape[axis] // parts
        x = x.narrow(axis, i * b, b)
    return x


def _global_shape(layout: str, shape, d: int) -> tuple:
    shape = list(shape)
    for axis, parts, _ in _coords(layout, d, 0):
        shape[axis] *= parts
    return tuple(shape)


def _join(layout: str, blocks, d: int) -> torch.Tensor:
    """The global array from every rank's block (a gradient of the whole
    input, as the float64 batch forms take it, is summed over ranks)."""
    if layout == "whole":
        return sum(blocks[1:], blocks[0])
    if layout == "slab":
        lead = blocks[0].shape[:-1]
        n = blocks[0].shape[-1] * d
        n1, n2 = _split(n, d)
        parts = [b.reshape(lead + (n1, n2 // d)) for b in blocks]
        return torch.cat(parts, dim=-1).reshape(lead + (n,))
    if layout == "mesh2":
        # rank = 2 * data + model: rows over "model", axis 0 over "data"
        return torch.cat([torch.cat(blocks[2 * i:2 * i + 2], dim=-2)
                          for i in range(d // 2)], dim=0)
    ((axis, _, _),) = _coords(layout, d, 0)
    return torch.cat(list(blocks), dim=axis)


def _global_inputs(case: Case) -> list:
    r = np.random.default_rng(case.seed)
    return [a.astype(case.dtype) for a in case.inputs(r)]


def _cotangents(case: Case, shapes) -> list:
    r = np.random.default_rng(case.seed + 5000)
    return [r.standard_normal(s).astype(case.dtype) for s in shapes]


# ----------------------------------------------------------- rank bodies

def _run_case(case: Case, d: int, r: int, mesh) -> dict:
    blocks = [_cut(case.in_l, torch.from_numpy(a), d, r).clone()
              for a in _global_inputs(case)]
    with torch.no_grad(), count_collectives() as plain:
        y0 = _planes(case.fn(tp, mesh, *blocks))
    xs = [b.clone().requires_grad_() for b in blocks]
    with count_collectives() as cc:
        ys = _planes(case.fn(tp, mesh, *xs))
        fwd = dict(cc)
        shapes = [_global_shape(case.out_l, y.shape, d) for y in ys]
        ws = [_cut(case.out_l, torch.from_numpy(w), d, r)
              for w in _cotangents(case, shapes)]
        sum((w * y).sum() for w, y in zip(ws, ys)).backward()
    return {"grads": [x.grad for x in xs], "shapes": shapes,
            "plain": dict(plain), "fwd": fwd, "fwd_bwd": dict(cc),
            "grad_fn": all(y.grad_fn is not None for y in ys),
            "same": all(torch.equal(a, b.detach()) for a, b in zip(y0, ys))}


# the exchange alone: (block shape, planes, split axis, concat axis)
EXCHANGES = [((8, 12), 1, -1, -2), ((3, 8, 4), 1, 1, 0),
             ((8, 12), 2, -2, -1), ((2, 4, 8, 4), 3, -1, 1),
             ((4, 2, 8), 2, 0, 2)]


def _exchange_dot(d: int, r: int, group) -> list:
    """(<A x, g>, <x, A^T g>, ||A x||^2, ||g||^2, fwd and fwd+bwd
    collectives) of this rank for each exchange of EXCHANGES."""
    out = []
    for k, (shape, p, s, c) in enumerate(EXCHANGES):
        rng = np.random.default_rng(700 + 10 * k + r)
        xs = [torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
              for _ in range(p)]
        with count_collectives() as cc:
            ys = all_to_all_tiled(tuple(xs) if p > 1 else xs[0], group, s, c)
            ys = ys if isinstance(ys, tuple) else (ys,)
            fwd = dict(cc)
            gs = [torch.from_numpy(rng.standard_normal(tuple(y.shape)))
                  for y in ys]
            sum((g * y).sum() for g, y in zip(gs, ys)).backward()
        out.append((float(sum((g * y.detach()).sum() for g, y in zip(gs, ys))),
                    float(sum((x.detach() * x.grad).sum() for x in xs)),
                    float(sum((y.detach() ** 2).sum() for y in ys)),
                    float(sum((g ** 2).sum() for g in gs)), fwd, dict(cc)))
    return out


def _exchange_gradcheck(d: int, r: int, group) -> bool:
    """gradcheck of (a, b) -> A^T(w * A a, sin(A b)) on this rank's (4, 2D)
    planes: the map is elementwise on each rank, so a rank's finite
    differences see its own Jacobian, and its backward runs both
    exchanges' adjoints."""
    rng = np.random.default_rng(800 + r)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (4 * d, 2)))

    def f(a, b):
        p, q = all_to_all_tiled((a, b), group, -1, -2)
        return all_to_all_tiled((p * w, torch.sin(q)), group, -2, -1)

    ab = [torch.from_numpy(rng.standard_normal((4, 2 * d))).requires_grad_()
          for _ in range(2)]
    return torch.autograd.gradcheck(f, ab)


def _ignored_plane(d: int, r: int, group) -> dict:
    """Two planes exchanged, the loss on plane 0 only, on every rank and
    then on rank 0 only: the backward completes; b's gradient is zero in
    the first, and in the second sum_r <b_r, grad b_r> is the cotangent
    of the other ranks' plane 1 against their received plane."""
    out = {}
    for who in ("all", "rank0"):
        rng = np.random.default_rng(900 + r)
        a, b = (torch.from_numpy(rng.standard_normal((8, 4 * d)))
                .requires_grad_() for _ in range(2))
        p, q = all_to_all_tiled((a, b), group, -1, -2)
        gp, gq = (torch.from_numpy(rng.standard_normal(tuple(p.shape)))
                  for _ in range(2))
        loss = (gp * p).sum()
        if who == "rank0" and r != 0:
            loss = loss + (gq * q).sum()
        loss.backward()
        out[who] = {"b_grad": b.grad, "a_dot": float((a.detach() * a.grad)
                                                     .sum()),
                    "p_dot": float((gp * p.detach()).sum()),
                    "b_dot": float((b.detach() * b.grad).sum()),
                    "q_dot": float((gq * q.detach()).sum())
                    if who == "rank0" and r != 0 else 0.0}
    return out


def _zero_loss_rank(d: int, r: int, mesh) -> dict:
    """fft2_sharded_split with rank 0's loss (y * 0).sum(), the other
    ranks' sum(w * y): the gradient blocks of every rank."""
    case = CASE["fft2_sharded_split (2, 32, 48) ortho"]
    xs = [_cut("rows", torch.from_numpy(a), d, r).clone().requires_grad_()
          for a in _global_inputs(case)]
    yr, yi = tp.fft2_sharded_split(*xs, mesh, norm="ortho")
    if r == 0:
        loss = (yr * 0).sum() + (yi * 0).sum()
    else:
        wr, wi = (_cut("rows", torch.from_numpy(w), d, r)
                  for w in _cotangents(case, [(2, 32, 48)] * 2))
        loss = (wr * yr).sum() + (wi * yi).sum()
    loss.backward()
    return {"grads": [x.grad for x in xs]}


def _hvp(d: int, r: int, mesh) -> list:
    """H v of L = sum yr^2 + yi^2 through fft2_sharded_split: the gradient
    with create_graph, then the gradient of <g, v>."""
    rng = np.random.default_rng(950)
    x = [rng.standard_normal((2, 16, 32)) for _ in range(2)]
    v = [rng.standard_normal((2, 16, 32)) for _ in range(2)]
    xs = [_cut("rows", torch.from_numpy(a), d, r).clone().requires_grad_()
          for a in x]
    vs = [_cut("rows", torch.from_numpy(a), d, r) for a in v]
    yr, yi = tp.fft2_sharded_split(*xs, mesh)
    g = torch.autograd.grad((yr ** 2 + yi ** 2).sum(), xs, create_graph=True)
    hv = torch.autograd.grad(sum((a * b).sum() for a, b in zip(g, vs)), xs)
    return [h.detach() for h in hv]


def _no_apply(d: int, r: int, mesh) -> dict:
    """Calls of _AllToAll.apply and grad_fns of the outputs with no input
    requiring grad, under no_grad, and with grad."""
    calls = []
    orig = _comm._AllToAll.apply

    def spy(*args):
        calls.append(len(args))
        return orig(*args)

    _comm._AllToAll.apply = spy
    try:
        x = torch.from_numpy(np.random.default_rng(990).standard_normal(
            (2, 16, 32)))
        out = {}
        for mode in ("off", "no_grad", "grad"):
            xs = [x.clone().requires_grad_(mode != "off") for _ in range(2)]
            with torch.set_grad_enabled(mode != "no_grad"):
                ys = (list(tp.fft2_sharded_split(*xs, mesh))
                      + [tp.fft_fourstep(torch.complex(
                          xs[0].reshape(-1)[:N4 // d],
                          xs[1].reshape(-1)[:N4 // d]), mesh,
                          overlap_chunks=2)]
                      + [tp.dctn2_sharded(xs[0], mesh)])
            out[mode] = (len(calls), [y.grad_fn is not None for y in ys])
    finally:
        _comm._AllToAll.apply = orig
    return out


def _rank(r: int, d: int, port: int, path: str) -> None:
    torch.set_num_threads(1)
    tp.init_distributed(f"127.0.0.1:{port}", d, r, device="cpu")
    try:
        mesh = tp.make_mesh((d,), ("data",), devices="cpu")
        mesh2 = tp.make_mesh((d // 2, 2), ("data", "model"), devices="cpu")
        group = mesh.get_group("data")
        out = {"cases": {c.name: _run_case(c, d, r, mesh2 if c.mesh2
                                           else mesh) for c in CASES},
               "dot": _exchange_dot(d, r, group),
               "gradcheck": _exchange_gradcheck(d, r, group),
               "ignored": _ignored_plane(d, r, group),
               "zero_loss": _zero_loss_rank(d, r, mesh),
               "hvp": _hvp(d, r, mesh),
               "no_apply": _no_apply(d, r, mesh)}
        torch.save(out, f"{path}/rank{r}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(D, every rank's results) of one spawn of D gloo ranks."""
    d = request.param
    path = tmp_path_factory.mktemp(f"grad_ranks{d}")
    torch.multiprocessing.spawn(_rank, nprocs=d,
                                args=(d, _free_port(), str(path)))
    return d, [torch.load(path / f"rank{r}.pt", weights_only=True)
               for r in range(d)]


# --------------------------------------------------------- JAX references

def _jax_mesh(d: int, shape=None, names=("data",)):
    import jax
    from cfftpack_tpu.parallel import make_mesh
    return make_mesh(shape or (d,), names, devices=jax.devices()[:d])


_JAX_GRADS: dict = {}


def _jax_group(d: int, group: str, res) -> dict:
    """jax.grad of sum(w * f(x)) for every case of ``group`` at D, in one
    jitted program (the cotangents' global shapes from rank 0)."""
    if (d, group) in _JAX_GRADS:
        return _JAX_GRADS[d, group]
    import jax
    import jax.numpy as jnp
    import cfftpack_tpu.parallel as jp
    meshes = {False: _jax_mesh(d),
              True: _jax_mesh(d, (d // 2, 2), ("data", "model"))}
    cases = [c for c in CASES if c.group == group]
    ins = [_global_inputs(c) for c in cases]
    cots = [_cotangents(c, res[0]["cases"][c.name]["shapes"]) for c in cases]

    def grads(ins, cots):
        out = []
        for c, x, w in zip(cases, ins, cots):
            def loss(p, c=c, w=w):
                ys = _planes(c.fn(jp, meshes[c.mesh2], *p))
                return sum(jnp.sum(wk * yk) for wk, yk in zip(w, ys))
            out.append(jax.grad(loss)(list(x)))
        return out

    # the program runs once: XLA's backend optimisations would cost more
    # compile time than they save
    res_ = jax.jit(grads).lower(ins, cots).compile(
        compiler_options={"xla_backend_optimization_level": 0})(ins, cots)
    _JAX_GRADS[d, group] = {c.name: [np.asarray(g) for g in gs]
                            for c, gs in zip(cases, res_)}
    return _JAX_GRADS[d, group]


def _err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _joined_grads(res, name: str, d: int) -> list:
    case = CASE[name]
    per_rank = [rk["cases"][name]["grads"] for rk in res]
    return [_join(case.in_l, [g[k] for g in per_rank], d).numpy()
            for k in range(len(per_rank[0]))]


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("name", NAMES)
def test_gradient_matches_jax(ranks, name):
    """Each rank's gradient blocks, joined by the JAX function's
    PartitionSpec, against jax.grad of the JAX package's function on the
    global array."""
    d, res = ranks
    case = CASE[name]
    want = _jax_group(d, case.group, res)[name]
    got = _joined_grads(res, name, d)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        err = _err(g, w)
        assert err < BARS[case.dtype], (name, k, err)


@pytest.mark.parametrize("name", NAMES)
def test_backward_doubles_the_collectives(ranks, name):
    """Forward and backward call twice the forward's all_to_all_single
    and no other collective; the forward under grad calls what the
    forward without grad calls."""
    d, res = ranks
    for rk in res:
        rec = rk["cases"][name]
        assert rec["fwd"] == rec["plain"], (name, rec)
        a2a = rec["fwd"]["all_to_all_single"]
        assert rec["fwd_bwd"] == {"all_to_all_single": 2 * a2a,
                                  "all_reduce": 0,
                                  "all_gather_into_tensor": 0,
                                  "reduce_scatter_tensor": 0}, (name, rec)
        assert a2a > 0 or CASE[name].group == "batch"


@pytest.mark.parametrize("name", NAMES)
def test_forward_under_grad_is_bit_identical(ranks, name):
    """The outputs of a forward under autograd equal those of the forward
    without grad to the last bit, and each has a grad_fn."""
    d, res = ranks
    assert all(rk["cases"][name]["same"] for rk in res)
    assert all(rk["cases"][name]["grad_fn"] for rk in res)


@pytest.mark.parametrize("k", range(len(EXCHANGES)))
def test_exchange_dot_product_identity(ranks, k):
    """<A x, g> = <x, A^T g> summed over ranks, in float64, with A^T g from
    _AllToAll's backward; one all_to_all_single a direction, the tuple of
    planes included."""
    d, res = ranks
    rows = [rk["dot"][k] for rk in res]
    lhs, rhs = sum(t[0] for t in rows), sum(t[1] for t in rows)
    norm = np.sqrt(sum(t[2] for t in rows)) * np.sqrt(sum(t[3] for t in rows))
    assert abs(lhs - rhs) < 1e-12 * norm, (lhs, rhs, norm)
    for t in rows:
        assert t[4]["all_to_all_single"] == 1
        assert t[5]["all_to_all_single"] == 2
        assert sum(t[5].values()) == 2


def test_exchange_gradcheck(ranks):
    """gradcheck in float64 through two exchanges and their adjoints on
    every rank at once."""
    d, res = ranks
    assert all(rk["gradcheck"] for rk in res)


def test_ignored_output_plane(ranks):
    """A loss that ignores plane 1 of an exchange on every rank leaves
    that plane's input gradient zero; on rank 0 only, sum_r <b_r, grad
    b_r> is the other ranks' <g_q, q>, and plane 0 keeps its identity."""
    d, res = ranks
    every = [rk["ignored"]["all"] for rk in res]
    assert all(bool((e["b_grad"] == 0).all()) for e in every)
    for who in ("all", "rank0"):
        recs = [rk["ignored"][who] for rk in res]
        a_dot, p_dot = sum(e["a_dot"] for e in recs), sum(e["p_dot"]
                                                          for e in recs)
        b_dot, q_dot = sum(e["b_dot"] for e in recs), sum(e["q_dot"]
                                                          for e in recs)
        assert abs(a_dot - p_dot) < 1e-12 * max(1.0, abs(p_dot))
        assert abs(b_dot - q_dot) < 1e-12 * max(1.0, abs(q_dot))
    assert not bool((res[0]["ignored"]["rank0"]["b_grad"] == 0).all())


def test_rank_with_a_zero_loss(ranks):
    """Rank 0's loss is (y * 0).sum(): every rank completes the backward,
    and the joined gradient is that of the other ranks' losses, the
    single-device fft2_split's with rank 0's rows of the cotangent set
    to zero."""
    import cfftpack_tpu_torch as pt
    d, res = ranks
    case = CASE["fft2_sharded_split (2, 32, 48) ortho"]
    got = [_join("rows", [rk["zero_loss"]["grads"][k] for rk in res], d)
           for k in range(2)]
    xs = [torch.from_numpy(a).requires_grad_()
          for a in _global_inputs(case)]
    ws = [torch.from_numpy(w) for w in _cotangents(case, [(2, 32, 48)] * 2)]
    for w in ws:
        w[:, :32 // d] = 0.0
    yr, yi = pt.fft2_split(*xs, norm="ortho")
    ((ws[0] * yr).sum() + (ws[1] * yi).sum()).backward()
    for g, x in zip(got, xs):
        assert _err(g, x.grad) < 1e-12


def test_hessian_vector_product_through_fft2_sharded(ranks):
    """H v of sum |fft2(x)|^2 through fft2_sharded_split (a second
    derivative through _AllToAll and the kernels' Function) against the
    same through the single-device fft2_split on the global array; under
    the fftpack norm it is 2 v / (n0 n1)."""
    import cfftpack_tpu_torch as pt
    d, res = ranks
    got = [_join("rows", [rk["hvp"][k] for rk in res], d) for k in range(2)]
    rng = np.random.default_rng(950)
    xs = [torch.from_numpy(rng.standard_normal((2, 16, 32)))
          .requires_grad_() for _ in range(2)]
    vs = [torch.from_numpy(rng.standard_normal((2, 16, 32)))
          for _ in range(2)]
    yr, yi = pt.fft2_split(*xs)
    g = torch.autograd.grad((yr ** 2 + yi ** 2).sum(), xs, create_graph=True)
    want = torch.autograd.grad(sum((a * b).sum() for a, b in zip(g, vs)), xs)
    for h, w, v in zip(got, want, vs):
        assert _err(h, w) < 1e-12
        assert _err(h, 2 * v / (16 * 32)) < 1e-12


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("kind", ["fft_fourstep", "ifft_fourstep"])
def test_chunked_exchange_gradient(ranks, kind, reorder):
    """The gradient with overlap_chunks=2 (two exchanges, each applied as
    _AllToAll once its collective is waited on) equals the one with 1
    within 1e-12."""
    d, res = ranks
    key = "reordered" if kind.startswith("i") else "reorder"
    one = _joined_grads(res, f"{kind} {key}={reorder} overlap_chunks=1", d)
    two = _joined_grads(res, f"{kind} {key}={reorder} overlap_chunks=2", d)
    for a, b in zip(one, two):
        assert _err(b, a) < 1e-12


def test_no_apply_without_grad(ranks):
    """With no input requiring grad, or under no_grad, all_to_all_tiled
    applies no Function and no output has a grad_fn; with grad it does,
    and each has one."""
    d, res = ranks
    for rk in res:
        calls, fns = rk["no_apply"]["off"]
        assert calls == 0 and not any(fns)
        calls, fns = rk["no_apply"]["no_grad"]
        assert calls == 0 and not any(fns)
        calls, fns = rk["no_apply"]["grad"]
        assert calls > 0 and all(fns)


def test_split_is_square_at_both_widths():
    """The four-step cases' (N1, N2) blocks hold at D = 2 and 4."""
    assert _split(N4, 2) == _split(N4, 4) == (N1, N2)
