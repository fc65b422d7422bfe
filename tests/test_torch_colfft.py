"""K6 (the column FFT) and K9 (the column DCT-II/III): the plain
versions against the functions they replace.

``cfftpack_tpu.ops.pallas_colfft`` runs in interpret mode on the CPU, as
tests/test_pallas.py runs it, and the reference's column DCT cores run
over it; the port's wrappers take their plain PyTorch versions on CPU
tensors.  The bar is the reference's own in test_pallas.py: 5e-6 of
max |X|.  The CUDA kernel itself is checked on the card (``-m cuda``
here, and chip_smoke.py).
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import cfftpack_tpu.ops.pallas_colfft as jcol

from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.ops import colfft, stream_fft
from cfftpack_tpu_torch.utils import profiling

from torch_parity import real_input, to_np

jdct = importlib.import_module("cfftpack_tpu.ops.dct")

torch.set_num_threads(1)

TOL = 5e-6


def _err(got, want) -> float:
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(shape, seed):
    return (real_input(shape, np.float32, seed),
            real_input(shape, np.float32, seed + 1000))


# ------------------------------------------------- eligibility

@pytest.mark.parametrize("n0,n1,dtype,ok", [
    (1024, 1024, torch.float32, True),
    (48, 128, torch.float32, True),          # radix-3 stage
    (80, 128, torch.float32, True),          # radix-5 stage
    (4096, 2, torch.float32, True),          # the cap
    (1024, 100, torch.float32, True),        # no lane-tile rule on n1
    (1024, 513, torch.float32, True),        # the packed width of rfft2
    (24, 128, torch.float32, False),         # no stage plan
    (8192, 128, torch.float32, False),       # past the cap
    (112, 128, torch.float32, False),        # 16 * 7
    (1024, 1024, torch.float64, False),
])
def test_colfft_eligible(n0, n1, dtype, ok):
    assert colfft.colfft_eligible(n0, n1, dtype) is ok


def test_eligible_lengths_match_reference():
    """On the transform axis the gate is the reference's."""
    for n0 in range(1, 4200):
        assert (colfft.colfft_eligible(n0, 128, torch.float32)
                == jcol.colfft_eligible(n0, 128, np.float32)), n0


@pytest.mark.parametrize("n0,n1,lanes", [(16, 1024, 32), (128, 1024, 32),
                                         (256, 1024, 16), (512, 1024, 8),
                                         (1024, 1024, 4), (2048, 1024, 2),
                                         (4096, 1024, 2), (64, 5, 8),
                                         (64, 1, 1)])
def test_lanes_fit_shared_memory(n0, n1, lanes):
    assert colfft._col_lanes(n0, n1) == lanes
    assert 16 * n0 * lanes <= stream_fft._SMEM_BUDGET


# ------------------------------------------------- K6 against Pallas

@pytest.mark.parametrize("shape", [(3, 64, 256), (2, 48, 128)])
@pytest.mark.parametrize("inverse,scale", [(False, 1.0), (True, 1.0),
                                           (False, 0.25)])
def test_colfft_matches_pallas(shape, inverse, scale):
    x, y = _pair(shape, seed=shape[1])
    zr, zi = colfft.scolfft(torch.as_tensor(x), torch.as_tensor(y), inverse,
                            scale)
    wr, wi = jcol.scolfft_pallas(jnp.asarray(x), jnp.asarray(y), inverse,
                                 scale)
    got = to_np(zr) + 1j * to_np(zi)
    assert _err(got, np.asarray(wr) + 1j * np.asarray(wi)) < TOL
    z = x.astype(np.float64) + 1j * y
    want = (np.fft.ifft(z, axis=-2) * shape[1] if inverse
            else np.fft.fft(z, axis=-2)) * scale
    assert _err(got, want) < TOL


@pytest.mark.parametrize("shape", [(2, 64, 65),      # ragged n1
                                   (3, 80, 40),      # radix 5
                                   (1, 16, 1),
                                   (2, 3, 48, 24)])  # leading axes
def test_colfft_matches_numpy(shape):
    x, y = _pair(shape, seed=7)
    n0 = shape[-2]
    zr, zi = colfft.scolfft(torch.as_tensor(x), torch.as_tensor(y))
    assert zr.shape == shape and zi.shape == shape
    want = np.fft.fft(x.astype(np.float64) + 1j * y, axis=-2)
    assert _err(to_np(zr) + 1j * to_np(zi), want) < TOL
    br, bi = colfft.scolfft(zr, zi, inverse=True, scale=1.0 / n0)
    assert np.abs(to_np(br) - x).max() < 5e-5
    assert np.abs(to_np(bi) - y).max() < 5e-5


def test_colfft_takes_a_moved_view():
    x, y = _pair((2, 40, 64), seed=9)
    xt = torch.as_tensor(x).transpose(-1, -2)          # (2, 64, 40) view
    yt = torch.as_tensor(y).transpose(-1, -2)
    zr, zi = colfft.scolfft(xt, yt)
    want = np.fft.fft(np.swapaxes(x + 1j * y, -1, -2), axis=-2)
    assert _err(to_np(zr) + 1j * to_np(zi), want) < TOL


# ------------------------------------------------- K9 against the cores

@pytest.mark.parametrize("shape", [(2, 64, 128), (4, 80, 128)])
@pytest.mark.parametrize("t", [2, 3])
def test_coldct_plain_matches_reference_core(shape, t):
    x = real_input(shape, np.float32, seed=shape[1] + t)
    n = shape[1]
    mine = colfft.coldct2_plain if t == 2 else colfft.coldct3_plain
    ref = jdct._coldct2_core if t == 2 else jdct._coldct3_core
    got = to_np(mine(torch.as_tensor(x), n))
    assert _err(got, np.asarray(ref(jnp.asarray(x), n))) < TOL
    # and the last-axis core on the transposed images
    core = jdct._dct2_core if t == 2 else jdct._dct3_core
    want = np.swapaxes(np.asarray(core(
        jnp.asarray(np.swapaxes(x, -1, -2).astype(np.float64)), n)), -1, -2)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("t", [2, 3])
def test_scoldct_weight_and_scale(t):
    """scale * w * dct2(x), scale * dct3(w * x): the contract the kernel
    fuses."""
    x = torch.as_tensor(real_input((2, 3, 48, 33), np.float32, seed=t))
    w = torch.as_tensor(real_input((48,), np.float32, seed=5))
    got = colfft.scoldct(x, t, w, 0.125)
    if t == 2:
        want = 0.125 * w[:, None] * colfft.coldct2_plain(x, 48)
    else:
        want = 0.125 * colfft.coldct3_plain(x * w[:, None], 48)
    assert got.shape == x.shape
    assert _err(to_np(got), to_np(want)) < 1e-6
    assert torch.equal(colfft.scoldct(x, t),
                       (colfft.coldct2_plain if t == 2
                        else colfft.coldct3_plain)(x, 48))


# ------------------------------------------------- the wrappers' contract

def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros((2, 64, 8))
    with pytest.raises(TypeError, match="float32"):
        colfft.scolfft(x.double(), x.double())
    with pytest.raises(TypeError, match="float32"):
        colfft.scoldct(x.double(), 2)
    bad = torch.zeros((2, 24, 8))
    with pytest.raises(ValueError, match="n0=24"):
        colfft.scolfft(bad, bad)
    with pytest.raises(ValueError, match="n0=24"):
        colfft.scoldct(bad, 3)
    with pytest.raises(ValueError, match="even"):
        colfft.scoldct(torch.zeros((3, 64, 8)), 2)
    with pytest.raises(ValueError, match="type 2 or 3"):
        colfft.scoldct(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        colfft._launch("fwd", x, x)                             # CPU tensors
    with pytest.raises(ValueError, match="mode"):
        colfft._launch("bogus", x, x)
    meta = torch.empty((2, 64, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        colfft.scolfft(meta, meta)                              # no fallback
    with pytest.raises(ValueError, match="CUDA"):
        colfft.scoldct(meta, 2)
    assert {k: profiling.launches[k] for k in ("K6", "K9")} == {"K6": 0,
                                                                "K9": 0}


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for b, n0, n1 in ((3, 48, 128), (2, 80, 65), (2, 1024, 513),
                      (2, 4096, 40)):
        x, y = (torch.as_tensor(a, device="cuda")
                for a in _pair((b, n0, n1), seed=n0))
        for inverse in (False, True):
            zr, zi = colfft.scolfft(x, y, inverse, 0.25)
            pr, pi = colfft.colfft_plain(x.cpu(), y.cpu(), inverse, 0.25)
            assert _err(to_np(zr) + 1j * to_np(zi),
                        to_np(pr) + 1j * to_np(pi)) < 1e-5
        x2 = x[:2]
        w = torch.rand(n0, device="cuda") + 0.5
        for t in (2, 3):
            assert _err(to_np(colfft.scoldct(x2, t, w, 0.5)),
                        to_np(colfft.scoldct(x2.cpu(), t, w.cpu(), 0.5))
                        ) < 1e-5, (n0, t)
        torch.cuda.synchronize()


# ------------------------------------------------- the register route

# col_fft.cu's limits: a block's shared memory and threads
SMEM_MAX = 232448
MAX_THREADS = 1024
CPU = torch.device("cpu")


def _compiled_schedules():
    """col_fft.cu's CfRegCol<n0> as {n0: passes}."""
    src = (Path(colfft.__file__).resolve().parent.parent / "csrc"
           / "col_fft.cu").read_text()
    out = {}
    for n0, body in re.findall(r"struct CfRegCol<(\d+)> \{\s*using type = "
                               r"RfList<(.*?)>;", src, flags=re.S):
        out[int(n0)] = tuple(
            tuple(int(q) for q in p.split(","))
            for p in re.findall(r"RfPass<([\d, ]+)>", body))
    return out


def test_compiled_column_schedules_are_the_plans():
    compiled = _compiled_schedules()
    assert sorted(compiled) == list(colfft.REG_N0)
    for n0, passes in compiled.items():
        assert passes == plan.reg_passes(n0), n0


def _reg_index(e, lane, lshift):
    """CFRegBase::sidx: row e of lane `lane`, a pad word every 16 rows."""
    return ((e + (e >> 4)) << lshift) + lane


def _rule_lanes(n0):
    """Every lane count the route rule gives at n0, over all n1."""
    return sorted({colfft._route(n0, n1)[1] for n1 in range(1, 65)})


@pytest.mark.parametrize("n0", colfft.REG_N0)
def test_register_layout_fits_and_does_not_overlap(n0):
    """For each lane count the rule can give: the padded lanes-fastest
    buffer is one-to-one, fits the shared memory the launch asks for
    (8*(n0 + n0/16)*L bytes, both planes), and the block needs at most
    1024 threads (n0/16 a lane)."""
    assert colfft._route(n0, 1024)[0] == "reg"
    for L in _rule_lanes(n0):
        lshift = L.bit_length() - 1
        plane = (n0 + n0 // 16) * L
        e, lane = np.meshgrid(np.arange(n0), np.arange(L), indexing="ij")
        idx = _reg_index(e, lane, lshift).ravel()
        assert len(set(idx)) == idx.size and idx.max() < plane
        assert 2 * 4 * plane <= SMEM_MAX
        assert (n0 // colfft._REG_ELEMS) * L <= MAX_THREADS


def test_stage_loop_route_fits():
    """Every other eligible n0 takes the stage loop within its budget."""
    for n0 in range(16, 4097, 16):
        if not colfft.colfft_eligible(n0, 1024, torch.float32):
            continue
        route, L = colfft._route(n0, 1024)
        assert route == ("reg" if n0 in colfft.REG_N0 else "stage"), n0
        if route == "stage":
            assert L == colfft._col_lanes(n0, 1024)
            assert 16 * n0 * L <= SMEM_MAX
    assert colfft._route(48, 5) == ("stage", 8)
    assert colfft._route(1024, 5)[1] <= 8


def _k9_model(mode, x, w, scale, lanes):
    """The register route's K9 IO (col_fft.cu: CFRegDct2IO and the dct2
    store loop; the dct3 staging loop and CFRegDct3IO) in float64, block
    by block: the padded lanes-fastest buffer, its lane groups masked at
    n1, the FFT of the passes as numpy.fft.  ``scale`` is the wrapper's
    (dct3 folds the core's 1/2 into the kernel's)."""
    B, n0, n1 = x.shape
    lshift = lanes.bit_length() - 1
    phr, phi = (t.double().numpy() for t in colfft._phase(n0, mode, CPU))
    wk = np.ones(n0) if w is None else w
    e = np.arange(n0)
    y = np.full_like(x, np.nan)
    for t in range(B // 2):
        x0, x1 = x[2 * t], x[2 * t + 1]
        for c0 in range(0, n1, lanes):
            lane = np.arange(lanes)
            c = c0 + lane
            on = c < n1
            cc = np.where(on, c, c0)
            if mode == "dct2":
                # gload(j): the Makhoul row of both images
                src = np.where(2 * e < n0, 2 * e, 2 * n0 - 1 - 2 * e)
                v = np.where(on, x0[src][:, cc] + 1j * x1[src][:, cc], 0)
                buf = np.full((n0 + n0 // 16) << lshift, np.nan, complex)
                buf[_reg_index(e[:, None], lane, lshift)] = np.fft.fft(
                    v, axis=0)
                # the store loop: Z[k] and its mirror from the buffer
                km = np.where(e == 0, 0, n0 - e)
                Z = buf[_reg_index(e[:, None], lane, lshift)]
                Zm = buf[_reg_index(km[:, None], lane, lshift)]
                s = scale * wk[:, None]
                ya = s * ((Z.real + Zm.real) * phr[:, None]
                          - (Z.imag - Zm.imag) * phi[:, None])
                yb = s * ((Z.imag + Zm.imag) * phr[:, None]
                          + (Z.real - Zm.real) * phi[:, None])
                y[2 * t][:, c[on]] = ya[:, on]
                y[2 * t + 1][:, c[on]] = yb[:, on]
            else:
                # the staged rows w[k]*(a_k, b_k) in the buffer, masked
                buf = np.full((n0 + n0 // 16) << lshift, np.nan, complex)
                buf[_reg_index(e[:, None], lane, lshift)] = np.where(
                    on, wk[:, None] * (x0[:, cc] + 1j * x1[:, cc]), 0)
                # gload(k): rows k and n0 - k from the buffer, x_{n0} := 0
                km = np.where(e == 0, 0, n0 - e)
                mirror = (e > 0)[:, None]
                own = buf[_reg_index(e[:, None], lane, lshift)]
                mir = np.where(mirror,
                               buf[_reg_index(km[:, None], lane, lshift)], 0)
                pa, pb, pam, pbm = own.real, own.imag, mir.real, mir.imag
                cr, ci = phr[:, None], phi[:, None]
                Z = (cr * pa + ci * pam - (ci * pb - cr * pbm)) + 1j * (
                    ci * pa - cr * pam + (cr * pb + ci * pbm))
                v = np.fft.ifft(Z, axis=0) * n0
                # gstore(j): y[2j] = v[j], y[2j+1] = v[n0-1-j], times scale
                dst = np.where(2 * e < n0, 2 * e, 2 * (n0 - 1 - e) + 1)
                ks = 0.5 * scale
                y[2 * t][dst[:, None], c[on]] = ks * v.real[:, on]
                y[2 * t + 1][dst[:, None], c[on]] = ks * v.imag[:, on]
    return y


@pytest.mark.parametrize("n0,n1,lanes", [(16, 11, 8), (1024, 21, 8),
                                         (1024, 5, 16)])
@pytest.mark.parametrize("t", [2, 3])
def test_k9_register_io_model_matches_plain(n0, n1, lanes, t):
    """The kernel's K9 loads, mirror store and scatter, modelled in
    float64, against coldct2_plain/coldct3_plain (with a row weight and a
    scale) on the same phase tables: 1e-12 of max |y|."""
    x = real_input((4, n0, n1), np.float64, seed=n0 + n1 + t)
    w = 0.5 + np.random.default_rng(t).random(n0)
    got = _k9_model(f"dct{t}", x, w, 0.25, lanes)
    want = to_np(colfft.coldct_plain(torch.as_tensor(x), t,
                                     torch.as_tensor(w), 0.25))
    assert not np.isnan(got).any()
    assert _err(got, want) < 1e-12


def test_launch_plan_is_cached_and_rebuilt():
    """One plan per (mode, n0, n1, device): the register route's pass
    twiddles and schedule at the compiled lengths, the stage loop's
    empty ones elsewhere, the K9 phase in the dct modes; rebuilt after
    plan.clear_device_tables()."""
    a = colfft._launch_plan("dct2", 1024, 513, CPU)
    assert colfft._launch_plan("dct2", 1024, 513, CPU) is a
    assert a.tables[5] is not None          # the register route's
    assert a.tables[6] == len(plan.reg_passes(1024))
    assert list(a.tables[7])[:a.tables[6]] == [2, 2, 1]
    assert a.tables[8] is not None and a.tables[9] is not None
    assert 1 << a.lshift == colfft._route(1024, 513)[1]
    b = colfft._launch_plan("fwd", 48, 128, CPU)
    assert b.tables[5] is None and b.tables[6] == 0       # the stage loop
    assert b.tables[8:] == (None, None)
    assert colfft._launch_plan("fwd", 1024, 513, CPU) is not a
    assert colfft._launch_plan("dct2", 1024, 5, CPU).lshift <= a.lshift
    # clusters of neighbouring lane groups where the rule asks for them,
    # never more blocks than a transform's groups
    for n0 in colfft.REG_N0:
        for n1 in (1, 5, 513, 1024):
            lp = colfft._launch_plan("fwd", n0, n1, CPU)
            groups = -(-n1 // (1 << lp.lshift))
            assert 1 <= lp.csize <= min(8, colfft._REG_CLUSTER[n0])
            assert lp.csize == 1 or lp.csize // 2 < groups
    assert b.csize == 1
    plan.clear_device_tables()
    c = colfft._launch_plan("dct2", 1024, 513, CPU)
    assert c is not a and c.version == plan.VERSION
    assert colfft._launch_plan("dct2", 1024, 513, CPU) is c


@pytest.mark.cuda
@pytest.mark.parametrize("n0", colfft.REG_N0 + (48, 80))
def test_every_compiled_length_matches_plain_on_card(n0):
    """Each compiled register schedule (and two stage-loop lengths), both
    K6 directions with a scale and both K9 types with a row weight, at a
    ragged n1 and an n1 below the lanes, against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for n1 in (513, 5):
        x, y = (torch.as_tensor(a, device="cuda")
                for a in _pair((2, n0, n1), seed=n0 + n1))
        for inverse in (False, True):
            zr, zi = colfft.scolfft(x, y, inverse, 0.25)
            pr, pi = colfft.colfft_plain(x, y, inverse, 0.25)
            torch.cuda.synchronize()
            assert _err(to_np(zr) + 1j * to_np(zi),
                        to_np(pr) + 1j * to_np(pi)) < 1e-5, (n0, n1, inverse)
        w = torch.rand(n0, device="cuda") + 0.5
        for t in (2, 3):
            got = colfft.scoldct(x, t, w, 0.5)
            torch.cuda.synchronize()
            assert _err(to_np(got), to_np(colfft.coldct_plain(x, t, w, 0.5))
                        ) < 1e-5, (n0, n1, t)
