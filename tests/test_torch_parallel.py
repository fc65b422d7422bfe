"""The parallel layer (``cfftpack_tpu_torch.parallel``) at D = 2 and 4
gloo ranks on the CPU against the JAX package's ``cfftpack_tpu.parallel``
on a D-device sub-mesh of its virtual devices (tests/conftest.py), and
the collectives each function calls.

Each D is one ``torch.multiprocessing.spawn`` (a module-scoped
fixture): every rank runs every case of ``_rank_cases`` on its block of
the same seeded numpy inputs and saves its results and collective
counts under ``tmp_path``.  The parent joins the blocks by the JAX
function's ``PartitionSpec`` and compares them with the JAX global
result: float64 at the JAX tests' bar (1e-12 of max |X|), float32 at
1e-5.  JAX is imported inside the tests only, so a spawned rank imports
torch and the port alone.
"""
import socket
from functools import partial

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cfftpack_tpu_torch import parallel as tp
from cfftpack_tpu_torch.models import (asian_option_qmc_device, bs_cf,
                                       conv_option_price, vg_mc_price_device)
from cfftpack_tpu_torch.parallel._comm import count_collectives
from cfftpack_tpu_torch.parallel.fourstep_split import _split
from cfftpack_tpu_torch.utils import black_scholes_option

from torch_parity import complex_input, real_input, rel_err

F64, F32 = 1e-12, 1e-5
STRIKES = np.arange(85.0, 115.0, 1.0)          # 30 strikes, pads to 32
FOURSTEP = {"n512": (), "n1024": (3,), "n4096": (2,)}   # lead shapes


def _n(name: str) -> int:
    return int(name[1:])


def _inputs():
    """The global inputs, the same in every rank and in the parent."""
    x = {name: complex_input(lead + (_n(name),), np.complex128, _n(name))
         for name, lead in FOURSTEP.items()}
    x["n4096_f32"] = x["n4096"].astype(np.complex64)
    x["batch"] = complex_input((16, 60), np.complex128, 1)
    x["batch_real"] = real_input((8, 32), np.float64, 3)
    x["fft2_64"] = complex_input((2, 64, 64), np.complex128, 21)
    x["fft2_32x48"] = complex_input((32, 48), np.complex128, 23)
    x["rfft2_32x15"] = real_input((32, 15), np.float64, 5)
    x["rfft2_16x24"] = real_input((16, 24), np.float64, 6)
    x["trig"] = real_input((32, 32), np.float64, 31)
    x["rowcol"] = real_input((4, 16, 16), np.float64, 33)
    x["hp"] = complex_input((8, 24), np.complex128, 4)
    x["hp_real"] = real_input((8, 16), np.float64, 4)
    return x


def _slab(x, d: int, r: int):
    """Rank r's column slab of (..., n): the four-step's input block."""
    n = x.shape[-1]
    n1, n2 = _split(n, d)
    lead = x.shape[:-1]
    w = n2 // d
    return x.reshape(lead + (n1, n2))[..., r * w:(r + 1) * w].reshape(
        lead + (n1 * w,))


def _rows(x, d: int, r: int, axis: int = -2):
    """Rank r's block of ``axis``."""
    b = x.shape[axis] // d
    return x.narrow(axis, r * b, b)


def _join_slabs(blocks, n: int, d: int):
    n1, n2 = _split(n, d)
    lead = blocks[0].shape[:-1]
    parts = [b.reshape(lead + (n1, n2 // d)) for b in blocks]
    return torch.cat(parts, dim=-1).reshape(lead + (n,))


def _cat(blocks, axis: int):
    return torch.cat(list(blocks), dim=axis)


def _counted(out: dict, name: str, fn):
    with count_collectives() as cc:
        res = fn()
    res = res if isinstance(res, tuple) else (res,)
    out[name] = ([t.detach().cpu() if isinstance(t, torch.Tensor) else t
                  for t in res], dict(cc))


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


# ----------------------------------------------------------- rank bodies

def _rank_cases(r: int, d: int, port: int, path: str) -> None:
    torch.set_num_threads(1)
    tp.init_distributed(f"127.0.0.1:{port}", d, r, device="cpu")
    try:
        out = {}
        mesh = tp.make_mesh((d,), ("data",), devices="cpu")
        mesh2 = tp.make_mesh((d // 2, 2), ("data", "model"), devices="cpu")
        x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
        out["mesh_errors"] = [
            _raises(lambda: tp.make_mesh((d + 1,), devices="cpu"),
                    ValueError),
            _raises(lambda: tp.make_mesh((d,), ("a", "b"), devices="cpu"),
                    ValueError),
            tp.local_mesh(devices="cpu").shape == (d,),
            tuple(mesh2.shape) == (d // 2, 2)]

        # batch forms: the rank's block of the batch, no collective
        xb = tp.shard_batch(x["batch"], mesh)
        vb = tp.shard_batch(x["batch_real"], mesh)
        _counted(out, "pfft", lambda: tp.pfft(xb, mesh))
        _counted(out, "pifft", lambda: tp.pifft(tp.pfft(xb, mesh), mesh))
        _counted(out, "prfft", lambda: tp.prfft(vb, mesh))
        _counted(out, "pirfft", lambda: tp.pirfft(tp.prfft(vb, mesh), 32,
                                                  mesh))
        _counted(out, "pdct", lambda: tp.pdct(vb, 2, mesh))
        out["shard_batch_error"] = _raises(
            lambda: tp.shard_batch(x["batch"][: d + 1], mesh), ValueError)

        # the four-step
        for name in FOURSTEP:
            s = _slab(x[name], d, r)
            _counted(out, f"fwd_{name}", lambda: tp.fft_fourstep(
                s, mesh, reorder=False))
            _counted(out, f"fwd_nat_{name}", lambda: tp.fft_fourstep(s, mesh))
            spec = out[f"fwd_{name}"][0][0]
            nat = out[f"fwd_nat_{name}"][0][0]
            _counted(out, f"inv_{name}", lambda: tp.ifft_fourstep(
                spec, mesh, reordered=False))
            _counted(out, f"inv_nat_{name}", lambda: tp.ifft_fourstep(
                nat, mesh))
        s32 = _slab(x["n4096_f32"], d, r)
        _counted(out, "fwd_ortho_f32", lambda: tp.fft_fourstep(
            s32, mesh, norm="ortho", reorder=False))
        s = _slab(x["n1024"], d, r)
        for c in (2, 4):
            _counted(out, f"fwd_chunks{c}", lambda: tp.fft_fourstep(
                s, mesh, reorder=False, overlap_chunks=c))
            spec = out[f"fwd_chunks{c}"][0][0]
            _counted(out, f"inv_chunks{c}", lambda: tp.ifft_fourstep(
                spec, mesh, reordered=False, overlap_chunks=c))
        _counted(out, "inv_chunks1", lambda: tp.ifft_fourstep(
            out["fwd_n1024"][0][0], mesh, reordered=False))
        _counted(out, "split_fwd", lambda: tp.fft_fourstep_split(
            s.real, s.imag, mesh))
        yr, yi = out["split_fwd"][0]
        _counted(out, "split_inv", lambda: tp.ifft_fourstep_split(
            yr, yi, mesh))
        _counted(out, "split_fwd_raw", lambda: tp.fft_fourstep_split(
            s.real, s.imag, mesh, reorder=False))
        yr, yi = out["split_fwd_raw"][0]
        _counted(out, "split_inv_raw", lambda: tp.ifft_fourstep_split(
            yr, yi, mesh, reordered=False))
        z = torch.zeros(512 // d, dtype=torch.complex64)
        out["fourstep_errors"] = [
            _raises(lambda: tp.fft_fourstep(torch.zeros(3), mesh),
                    ValueError),
            _raises(lambda: tp.fft_fourstep(z, mesh, overlap_chunks=3),
                    ValueError),
            _raises(lambda: tp.fft_fourstep(z, mesh, overlap_chunks=0),
                    ValueError)]

        # the sharded 2-D FFTs, rows sharded
        for name in ("fft2_64", "fft2_32x48"):
            b = _rows(x[name], d, r)
            _counted(out, name, lambda: tp.fft2_sharded(b, mesh))
            spec = out[name][0][0]
            _counted(out, f"i{name}", lambda: tp.ifft2_sharded(spec, mesh))
            _counted(out, f"{name}_split", lambda: tp.fft2_sharded_split(
                b.real, b.imag, mesh))
            yr, yi = out[f"{name}_split"][0]
            _counted(out, f"i{name}_split", lambda: tp.ifft2_sharded_split(
                yr, yi, mesh))
        out["fft2_error"] = _raises(lambda: tp.fft2_sharded(
            torch.zeros((2, 2 * d + 1), dtype=torch.complex128), mesh),
            ValueError)
        for name in ("rfft2_32x15", "rfft2_16x24"):
            n1 = x[name].shape[-1]
            b = _rows(x[name], d, r)
            _counted(out, name, lambda: tp.rfft2_sharded(b, mesh))
            spec = out[name][0][0]
            _counted(out, f"i{name}", lambda: tp.irfft2_sharded(spec, n1,
                                                                mesh))
            _counted(out, f"{name}_ortho", lambda: tp.rfft2_sharded_split(
                b, mesh, norm="ortho"))
            yr, yi = out[f"{name}_ortho"][0]
            _counted(out, f"i{name}_ortho", lambda: tp.irfft2_sharded_split(
                yr, yi, n1, mesh, norm="ortho"))
        out["irfft2_error"] = _raises(lambda: tp.irfft2_sharded_split(
            yr, yi, 2 * yr.shape[-1] + 1, mesh), ValueError)

        # row-column DCT/DST, types 1-4, and the (data, model) mesh
        b = _rows(x["trig"], d, r)
        for fwd, inv in ((tp.dctn2_sharded, tp.idctn2_sharded),
                         (tp.dstn2_sharded, tp.idstn2_sharded)):
            for t in (1, 2, 3, 4):
                key = f"{fwd.__name__}_{t}"
                _counted(out, key, lambda: fwd(b, mesh, type=t))
                spec = out[key][0][0]
                _counted(out, f"i{key}", lambda: inv(spec, mesh, type=t))
        rc = _rows(_rows(x["rowcol"], 2, mesh2.get_coordinate()[1]),
                   d // 2, mesh2.get_coordinate()[0], axis=0)
        _counted(out, "rowcol_mesh2", lambda: tp.dctn2_sharded(
            rc, mesh2, axis_name="model", batch_axis_name="data"))
        from cfftpack_tpu_torch.ops import dct, dst
        _counted(out, "rowcol_pair", lambda: tp.rowcol2d_sharded(
            _rows(x["trig"], d, r), mesh, partial(dct, type=2),
            partial(dst, type=2)))

        # float64 batch forms: the whole batch in, the rank's block out
        _counted(out, "pfft_hp", lambda: tp.pfft_hp(x["hp"], mesh))
        _counted(out, "pifft_hp", lambda: tp.pifft_hp(
            np.fft.fft(x["hp"].numpy()) / 24, mesh))
        _counted(out, "prfft_hp", lambda: tp.prfft_hp(x["hp_real"], mesh))
        out["hp_error"] = _raises(
            lambda: tp.pfft_hp(x["hp"][: d + 1], mesh), ValueError)

        # the pricers on the mesh, against their mesh=None calls
        def ladder(m):
            return conv_option_price(100.0, STRIKES, 1 / 12, 0.03,
                                     lambda u: bs_cf(u, 1 / 12, 0.15, 0.03),
                                     n=4096, grid_sigma=0.15, mesh=m,
                                     device="cpu" if m is None else None)
        _counted(out, "ladder", lambda: torch.from_numpy(ladder(mesh)))
        out["ladder_single"] = torch.from_numpy(ladder(None))
        out["asian_single"] = asian_option_qmc_device(samples=4096,
                                                      device="cpu")
        out["vg_single"] = vg_mc_price_device(samples=200000, seed=2,
                                              device="cpu")
        for key, m in (("mesh1", mesh), ("mesh2", mesh2)):
            _counted(out, f"asian_{key}", lambda: torch.tensor(
                asian_option_qmc_device(samples=4096, mesh=m)))
            _counted(out, f"vg_{key}", lambda: torch.tensor(
                vg_mc_price_device(samples=200000, seed=2, mesh=m)))
        out["mc_errors"] = [
            _raises(lambda: asian_option_qmc_device(samples=4097, mesh=mesh),
                    ValueError),
            _raises(lambda: vg_mc_price_device(samples=200001, mesh=mesh),
                    ValueError)]
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
    path = tmp_path_factory.mktemp(f"ranks{d}")
    torch.multiprocessing.spawn(_rank_cases, nprocs=d,
                                args=(d, _free_port(), str(path)))
    return d, [torch.load(path / f"rank{r}.pt", weights_only=True)
               for r in range(d)]


# --------------------------------------------------------- JAX references

def _jax_mesh(d: int, shape=None, names=("data",)):
    import jax
    from cfftpack_tpu.parallel import make_mesh
    return make_mesh(shape or (d,), names, devices=jax.devices()[:d])


def _outs(res, name, i=0):
    return [rk[name][0][i] for rk in res]


def _counts(res, name):
    return [rk[name][1] for rk in res]


def _a2a_only(res, name, n: int) -> bool:
    return all(c == {"all_to_all_single": n, "all_reduce": 0,
                     "all_gather_into_tensor": 0,
                     "reduce_scatter_tensor": 0} for c in _counts(res, name))


def test_make_mesh_errors(ranks):
    d, res = ranks
    assert all(all(rk["mesh_errors"]) for rk in res)


def test_mesh_helpers_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tp.make_mesh, tp.local_mesh, tp.init_distributed):
        with pytest.raises(RuntimeError, match="cpu"):
            call()
    with pytest.raises(ValueError, match="cuda"):
        tp.make_mesh(devices="tpu")


def test_split_matches_jax():
    from cfftpack_tpu.parallel.fourstep import _split as j_split
    for n in (512, 960, 1024, 4096, 1 << 16, 1 << 20):
        for d in (1, 2, 4):
            assert _split(n, d) == j_split(n, d)


def test_batch_forms_match_jax_and_are_local(ranks):
    from cfftpack_tpu.parallel import pdct, pfft, prfft
    d, res = ranks
    m = _jax_mesh(d)
    x = _inputs()
    assert rel_err(_cat(_outs(res, "pfft"), 0),
                   pfft(x["batch"], m)) < F64
    assert rel_err(_cat(_outs(res, "pifft"), 0), x["batch"]) < F64
    assert rel_err(_cat(_outs(res, "prfft"), 0),
                   prfft(x["batch_real"], m)) < F64
    assert rel_err(_cat(_outs(res, "pirfft"), 0), x["batch_real"]) < F64
    assert rel_err(_cat(_outs(res, "pdct"), 0),
                   pdct(x["batch_real"], 2, m)) < F64
    for name in ("pfft", "pifft", "prfft", "pirfft", "pdct"):
        assert _a2a_only(res, name, 0), name
    assert all(rk["shard_batch_error"] for rk in res)


@pytest.mark.parametrize("name", list(FOURSTEP))
def test_fourstep_matches_jax(ranks, name):
    """Both output layouts and both inverses at n = 512, 1024 (batched)
    and 4096 (batched), complex128: one all-to-all a direction, one more
    for the natural order."""
    from cfftpack_tpu.parallel import fft_fourstep, ifft_fourstep
    d, res = ranks
    m = _jax_mesh(d)
    x, n = _inputs()[name], _n(name)
    want = np.asarray(fft_fourstep(x, m, reorder=False))
    assert rel_err(_cat(_outs(res, f"fwd_{name}"), -2), want) < F64
    assert rel_err(_cat(_outs(res, f"fwd_nat_{name}"), -1),
                   fft_fourstep(x, m)) < F64
    assert rel_err(_join_slabs(_outs(res, f"inv_{name}"), n, d),
                   ifft_fourstep(want, m, reordered=False)) < F64
    assert rel_err(_join_slabs(_outs(res, f"inv_nat_{name}"), n, d),
                   x) < F64
    assert _a2a_only(res, f"fwd_{name}", 1)
    assert _a2a_only(res, f"inv_{name}", 1)
    assert _a2a_only(res, f"fwd_nat_{name}", 2)
    assert _a2a_only(res, f"inv_nat_{name}", 2)


def test_fourstep_float32_ortho_matches_jax(ranks):
    from cfftpack_tpu.parallel import fft_fourstep
    d, res = ranks
    got = _cat(_outs(res, "fwd_ortho_f32"), -2)
    assert got.dtype == torch.complex64
    want = fft_fourstep(_inputs()["n4096_f32"], _jax_mesh(d), norm="ortho",
                        reorder=False)
    assert rel_err(got, want) < F32


@pytest.mark.parametrize("chunks", [2, 4])
def test_fourstep_overlap_is_bit_identical(ranks, chunks):
    d, res = ranks
    for rk in res:
        assert torch.equal(rk[f"fwd_chunks{chunks}"][0][0],
                           rk["fwd_n1024"][0][0])
        assert torch.equal(rk[f"inv_chunks{chunks}"][0][0],
                           rk["inv_chunks1"][0][0])
    assert _a2a_only(res, f"fwd_chunks{chunks}", chunks)
    assert _a2a_only(res, f"inv_chunks{chunks}", chunks)
    assert rel_err(_join_slabs(_outs(res, f"inv_chunks{chunks}"), 1024, d),
                   _inputs()["n1024"]) < F64


def test_fourstep_errors(ranks):
    d, res = ranks
    assert all(all(rk["fourstep_errors"]) for rk in res)


def test_fourstep_split_matches_complex(ranks):
    d, res = ranks
    x = _inputs()["n1024"]
    for rk in res:
        yr, yi = rk["split_fwd"][0]
        assert torch.equal(torch.complex(yr, yi), rk["fwd_nat_n1024"][0][0])
        yr, yi = rk["split_fwd_raw"][0]
        assert torch.equal(torch.complex(yr, yi), rk["fwd_n1024"][0][0])
    for name in ("split_inv", "split_inv_raw"):
        back = [torch.complex(*rk[name][0]) for rk in res]
        assert rel_err(_join_slabs(back, 1024, d), x) < F64
    assert _a2a_only(res, "split_fwd", 2)
    assert _a2a_only(res, "split_inv_raw", 1)


@pytest.mark.parametrize("name", ["fft2_64", "fft2_32x48"])
def test_fft2_sharded_matches_jax(ranks, name):
    from cfftpack_tpu.parallel import fft2_sharded
    d, res = ranks
    x = _inputs()[name]
    want = fft2_sharded(x, _jax_mesh(d))
    assert rel_err(_cat(_outs(res, name), -2), want) < F64
    assert rel_err(_cat(_outs(res, f"i{name}"), -2), x) < F64
    split = [torch.complex(*rk[f"{name}_split"][0]) for rk in res]
    assert rel_err(_cat(split, -2), want) < F64
    back = [torch.complex(*rk[f"i{name}_split"][0]) for rk in res]
    assert rel_err(_cat(back, -2), x) < F64
    for k in (name, f"i{name}", f"{name}_split", f"i{name}_split"):
        assert _a2a_only(res, k, 2), k
    assert all(rk["fft2_error"] for rk in res)


@pytest.mark.parametrize("name", ["rfft2_32x15", "rfft2_16x24"])
def test_rfft2_sharded_matches_jax(ranks, name):
    """Odd and even n1 (the ragged bins padded to a multiple of D), the
    inverse, the split forms under ortho."""
    from cfftpack_tpu.parallel import rfft2_sharded_split
    d, res = ranks
    x = _inputs()[name]
    m = _jax_mesh(d)
    wr, wi = rfft2_sharded_split(x, m)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    assert rel_err(_cat(_outs(res, name), -2), want) < F64
    assert rel_err(_cat(_outs(res, f"i{name}"), -2), x) < F64
    wr, wi = rfft2_sharded_split(x, m, norm="ortho")
    assert rel_err(_cat(_outs(res, f"{name}_ortho"), -2), wr) < F64
    assert rel_err(_cat(_outs(res, f"{name}_ortho", 1), -2), wi) < F64
    assert rel_err(_cat(_outs(res, f"i{name}_ortho"), -2), x) < F64
    for k in (name, f"i{name}", f"{name}_ortho", f"i{name}_ortho"):
        assert _a2a_only(res, k, 2), k
    assert all(rk["irfft2_error"] for rk in res)


@pytest.mark.parametrize("kind", ["dctn2_sharded", "dstn2_sharded"])
def test_trig2_sharded_matches_jax(ranks, kind):
    """Types 1-4 forward against the JAX function, and the inverses."""
    import cfftpack_tpu.parallel as jp
    d, res = ranks
    x = _inputs()["trig"]
    m = _jax_mesh(d)
    for t in (1, 2, 3, 4):
        key = f"{kind}_{t}"
        assert rel_err(_cat(_outs(res, key), -2),
                       getattr(jp, kind)(x, m, type=t)) < F64, key
        assert rel_err(_cat(_outs(res, f"i{key}"), -2), x) < F64, key
        assert _a2a_only(res, key, 2) and _a2a_only(res, f"i{key}", 2)


def test_rowcol_sharded_on_two_axes_matches_jax(ranks):
    """dctn2 on a (2, 2) (data, model) mesh with the batch on "data", and
    a pair of different row and column transforms."""
    import cfftpack_tpu as ct
    from cfftpack_tpu.parallel import dctn2_sharded, rowcol2d_sharded
    d, res = ranks
    x = _inputs()
    if d == 4:
        blocks = [rk["rowcol_mesh2"][0][0] for rk in res]
        # rank = 2*data + model: rows over "model", batch over "data"
        got = torch.cat([torch.cat(blocks[2 * i:2 * i + 2], dim=-2)
                         for i in range(2)], dim=0)
        m2 = _jax_mesh(4, (2, 2), ("data", "model"))
        assert rel_err(got, dctn2_sharded(x["rowcol"], m2,
                                          axis_name="model",
                                          batch_axis_name="data")) < F64
        assert _a2a_only(res, "rowcol_mesh2", 2)
    want = rowcol2d_sharded(x["trig"], _jax_mesh(d), _JAX_DCT2, _JAX_DST2)
    assert rel_err(_cat(_outs(res, "rowcol_pair"), -2), want) < F64
    assert rel_err(want, ct.dst(ct.dct(x["trig"], 2), 2, axis=0)) < F64
    assert _a2a_only(res, "rowcol_pair", 2)


def _jax_trig(name, t):
    def fn(a):
        import cfftpack_tpu as ct
        return getattr(ct, name)(a, t)
    return fn


_JAX_DCT2 = _jax_trig("dct", 2)
_JAX_DST2 = _jax_trig("dst", 2)


def test_hp_batch_forms(ranks):
    """float64 in, each rank's block out, against numpy.fft at the JAX
    test's 1e-13, with no collective; the batch must divide."""
    d, res = ranks
    x = _inputs()
    got = _cat(_outs(res, "pfft_hp"), 0)
    assert got.dtype == torch.complex128
    want = np.fft.fft(x["hp"]) / 24
    assert np.abs(got.numpy() - want).max() < 1e-13
    assert np.abs(_cat(_outs(res, "pifft_hp"), 0).numpy()
                  - x["hp"]).max() < 1e-13
    got = _cat(_outs(res, "prfft_hp"), 0).numpy()
    assert np.abs(got - np.fft.rfft(x["hp_real"]) / 16).max() < 1e-13
    for name in ("pfft_hp", "pifft_hp", "prfft_hp"):
        assert _a2a_only(res, name, 0)
    assert all(rk["hp_error"] for rk in res)


def test_sharded_ladder(ranks):
    """30 strikes padded to 32 over "data": Black-Scholes within 5e-4, the
    mesh=None call within 1e-12, one all_gather_into_tensor."""
    d, res = ranks
    want = black_scholes_option(100.0, STRIKES, 0.15, 1 / 12, 0.03, True)
    for rk in res:
        got = rk["ladder"][0][0].numpy()
        assert got.shape == (30,)
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
        assert rel_err(got, rk["ladder_single"]) < F64
        assert rk["ladder"][1] == {"all_to_all_single": 0, "all_reduce": 0,
                                   "all_gather_into_tensor": 1,
                                   "reduce_scatter_tensor": 0}


@pytest.mark.parametrize("mesh", ["mesh1", "mesh2"])
def test_sharded_mc_pricers(ranks, mesh):
    """The Asian QMC draws the single-device point set (1e-6), the VG
    draws disjoint streams (0.15); one all_reduce each."""
    d, res = ranks
    one = {"all_to_all_single": 0, "all_reduce": 1,
           "all_gather_into_tensor": 0, "reduce_scatter_tensor": 0}
    for rk in res:
        assert abs(float(rk[f"asian_{mesh}"][0][0])
                   - rk["asian_single"]) < 1e-6
        assert abs(float(rk[f"vg_{mesh}"][0][0]) - rk["vg_single"]) < 0.15
        assert rk[f"asian_{mesh}"][1] == one and rk[f"vg_{mesh}"][1] == one
        assert all(rk["mc_errors"])
    # every rank returns the same price
    assert len({float(rk[f"asian_{mesh}"][0][0]) for rk in res}) == 1


def test_count_collectives_nests_and_restores_torch_distributed(
        monkeypatch):
    """Counts reach every open counter, the inner one stops at its exit
    even when its counts equal the outer one's, and torch.distributed's
    functions come back."""
    before = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: None)
    patched = dist.all_reduce
    with count_collectives() as a:
        with count_collectives() as b:
            assert dist.all_reduce is not patched
            dist.all_reduce(None)
        dist.all_reduce(None)
        dist.all_reduce(None)
    assert a["all_reduce"] == 3 and b["all_reduce"] == 1
    assert a["all_to_all_single"] == b["all_to_all_single"] == 0
    assert dist.all_reduce is patched
    monkeypatch.undo()
    assert dist.all_reduce is before


def test_dryrun_multichip_on_gloo():
    """The JAX dry run's legs, bars and collective budgets on 4 gloo
    ranks: a (2, 2) (data, model) mesh."""
    from cfftpack_tpu_torch.dryrun import dryrun_multichip
    res = dryrun_multichip(4, device="cpu")
    assert res["mesh"] == {"data": 2, "model": 2}
    assert res["overlap"] < 5e-6 and res["filtered"] < 1e-5
    assert res["fft2_512"] < 1e-5 and res["fft2_2048"] < 1e-5
    assert res["ladder"] < 5e-3 and res["qmc"] < 1e-6 and res["hp"] < 5e-14
