"""The port's reference-shaped plan API (``cfftpack_tpu_torch.compat``)
against the reference C library's golden vectors (tests/golden, made by
tools/make_golden.py from the C library) and against
``cfftpack_tpu.compat`` on the same inputs, ortho on and off, with the
C library's quirks: fft ortho as F/n^1.5 and B*sqrt(n), rfft's
2*conj(X) packing with ortho ignored, dst ortho's index-0 weight, dct7
ortho's half scale, and gdft_inverse as the true inverse."""
import numpy as np
import pytest
import torch

import cfftpack_tpu.compat as jc
import cfftpack_tpu_torch.compat as cc

from torch_parity import rel_err, to_np

torch.set_num_threads(1)

GOLD = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden.npz")
TOL = 1e-12


def _tol(n):
    """tests/test_golden.py's bar: absolute, 1e-12 * max(1, sqrt(n))."""
    return TOL * max(1.0, n ** 0.5)


def _sizes(fam):
    """Every size the golden file holds for ``fam`` (1-D families)."""
    pre = f"{fam}_in_"
    return sorted(int(k[len(pre):]) for k in GOLD.files if k.startswith(pre))


def _t(a):
    return torch.from_numpy(np.asarray(a))


CREATE = {"fft": cc.fft_create, "rfft": cc.rfft_create,
          "dct": cc.dct_create, "dct1": cc.dct1_create,
          "dst": cc.dst_create, "dst1": cc.dst1_create,
          "dct4": cc.dct4_create, "dst4": cc.dst4_create,
          "dct5": cc.dct5_create, "dct6": cc.dct6_create,
          "dct7": cc.dct7_create, "dct8": cc.dct8_create,
          "dst5": cc.dst5_create, "dst6": cc.dst6_create,
          "dst7": cc.dst7_create, "dst8": cc.dst8_create}
# test_golden.py's looser bar for the orthonormal DCT-I forward
FWD_TIMES_N = {("dct1", True)}


@pytest.mark.parametrize("ortho", [False, True])
@pytest.mark.parametrize("fam", sorted(CREATE))
def test_plan_matches_golden(fam, ortho):
    """Every 1-D family at every golden size: the forward (``transform``
    for dct6/dct7/dst6/dst7, which have no inverse key) at _tol(n), the
    inverse at _tol(n) * n as test_golden.py holds them; rfft's inverse
    round-trips the reference's own packed spectrum."""
    sfx = "_ortho" if ortho else ""
    sizes = _sizes(fam)
    assert sizes
    for n in sizes:
        if (fam == "dct1" and n < 2) or (fam in ("dct4", "dst4") and n % 2):
            continue
        f = CREATE[fam](n)
        cc.fft_ortho(f, ortho)
        x = _t(GOLD[f"{fam}_in_{n}"])
        fwd = f.transform if fam in ("dct6", "dct7", "dst6", "dst7") \
            else f.forward
        bar = _tol(n) * (n if (fam, ortho) in FWD_TIMES_N else 1)
        np.testing.assert_allclose(to_np(fwd(x)), GOLD[f"{fam}_fwd_{n}{sfx}"],
                                   atol=bar, err_msg=f"{fam} fwd n={n}")
        if f"{fam}_inv_{n}{sfx}" in GOLD:
            np.testing.assert_allclose(
                to_np(f.inverse(x)), GOLD[f"{fam}_inv_{n}{sfx}"],
                atol=_tol(n) * n, err_msg=f"{fam} inv n={n}")
        if fam == "rfft":
            back = f.inverse(_t(GOLD[f"rfft_fwd_{n}{sfx}"]))
            np.testing.assert_allclose(to_np(back), to_np(x), atol=_tol(n),
                                       err_msg=f"rfft round trip n={n}")


@pytest.mark.parametrize("lm", [(4, 4), (8, 6), (6, 10)])
def test_fft2_plan_matches_golden(lm):
    l, m = lm
    f = cc.fft2_create(l, m)
    x = _t(GOLD[f"fft2_in_{l}x{m}"])
    assert tuple(x.shape) == (m, l)
    np.testing.assert_allclose(to_np(cc.fft2_forward(f, x)),
                               GOLD[f"fft2_fwd_{l}x{m}"], atol=_tol(l * m))
    np.testing.assert_allclose(to_np(cc.fft2_inverse(f, x)),
                               GOLD[f"fft2_inv_{l}x{m}"],
                               atol=_tol(l * m) * l * m)


@pytest.mark.parametrize("mn", [(4, 4), (8, 6), (6, 10), (64, 48)])
def test_dct2d_plan_matches_golden(mn):
    M, N = mn
    f = cc.dct_2d_create(M, N)
    x = _t(GOLD[f"dct2d_in_{M}x{N}"])
    assert tuple(x.shape) == (N, M)
    np.testing.assert_allclose(to_np(cc.dct_2d_forward(f, x)),
                               GOLD[f"dct2d_fwd_{M}x{N}"], atol=_tol(M * N))
    np.testing.assert_allclose(to_np(cc.dct_2d_inverse(f, x)),
                               GOLD[f"dct2d_inv_{M}x{N}"],
                               atol=_tol(M * N) * M * N)


@pytest.mark.parametrize("n", [4, 8, 16, 60, 960])
def test_gdft_plan_matches_golden(n):
    """Forward at _tol(n); the inverse is the fixed one, so it round
    trips (the reference's gdft_inverse does not for a != 0)."""
    for a, b in ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5),
                 (0.25, 0.1)):
        key = f"{n}_{a}_{b}"
        f = cc.gdft_create(n, a, b)
        x = _t(GOLD[f"gdft_in_{key}"])
        y = cc.gdft_forward(f, x)
        np.testing.assert_allclose(to_np(y), GOLD[f"gdft_fwd_{key}"],
                                   atol=_tol(n), err_msg=key)
        np.testing.assert_allclose(to_np(cc.gdft_inverse(f, y)), to_np(x),
                                   atol=_tol(n), err_msg=key)


def test_shifts_and_fast_sizes_match_golden():
    for n in (8, 15):
        x = _t(GOLD[f"shift_in_{n}"])
        assert np.array_equal(to_np(cc.fftshift(x)), GOLD[f"fftshift_{n}"])
        assert np.array_equal(to_np(cc.ifftshift(x)), GOLD[f"ifftshift_{n}"])
    ns = range(1, 2000)
    for name in ("fft_next_fast_size", "fft_next_fast_even_size",
                 "fft_next_fast_size_2nm1", "fft_next_fast_size_2np1"):
        got = [getattr(cc, name)(v) for v in ns]
        assert np.array_equal(got, GOLD[name]), name


# (family, sizes) held against cfftpack_tpu.compat on a (3, n) batch
REF_CASES = [("fft", (8, 60, 101)), ("rfft", (8, 61)), ("dct", (8, 60)),
             ("dct1", (8, 61)), ("dst", (8, 60)), ("dst1", (8, 59)),
             ("dct4", (8, 60)), ("dst4", (8, 60)), ("dct5", (8, 13)),
             ("dct6", (8, 13)), ("dct7", (8, 13)), ("dct8", (8, 13)),
             ("dst5", (8, 13)), ("dst6", (8, 13)), ("dst7", (8, 13)),
             ("dst8", (8, 13))]


@pytest.mark.parametrize("ortho", [False, True])
@pytest.mark.parametrize("fam,sizes", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_plan_matches_reference(fam, sizes, ortho):
    rng = np.random.default_rng(len(fam))
    for n in sizes:
        mine, ref = CREATE[fam](n), getattr(jc, f"{fam}_create")(n)
        cc.fft_ortho(mine, ortho)
        jc.fft_ortho(ref, ortho)
        x = rng.standard_normal((3, n))
        if fam == "fft":
            x = x + 1j * rng.standard_normal((3, n))
        y = mine.forward(_t(x))
        assert rel_err(y, ref.forward(x)) < TOL, (fam, n, "forward")
        # the inverse on the forward's output (rfft: a packed spectrum)
        assert rel_err(mine.inverse(y), ref.inverse(to_np(y))) < TOL, \
            (fam, n, "inverse")
        if fam in ("dct6", "dct7", "dst6", "dst7"):
            assert rel_err(mine.transform(_t(x)), ref.transform(x)) < TOL


@pytest.mark.parametrize("ortho", [False, True])
def test_2d_and_gdft_plans_match_reference(ortho):
    rng = np.random.default_rng(5)
    pairs = [(cc.fft2_create(6, 10), jc.fft2_create(6, 10),
              rng.standard_normal((2, 10, 6))
              + 1j * rng.standard_normal((2, 10, 6))),
             (cc.dct_2d_create(6, 10), jc.dct_2d_create(6, 10),
              rng.standard_normal((2, 10, 6))),
             (cc.gdft_create(60, 0.25, 0.1), jc.gdft_create(60, 0.25, 0.1),
              rng.standard_normal((3, 60)) + 1j * rng.standard_normal((3, 60)))]
    for mine, ref, x in pairs:
        cc.fft_ortho(mine, ortho)
        jc.fft_ortho(ref, ortho)
        y = mine.forward(_t(x))
        assert rel_err(y, ref.forward(x)) < TOL, mine.kind
        assert rel_err(mine.inverse(y), ref.inverse(to_np(y))) < TOL, \
            mine.kind


def test_free_functions_match_plan_methods():
    x = _t(GOLD["fft_in_60"])
    f = cc.fft_create(60)
    assert torch.equal(cc.fft_forward(f, x), f.forward(x))
    assert torch.equal(cc.fft_inverse(f, x), f.inverse(x))
    r = cc.rfft_create(60)
    xr = _t(GOLD["rfft_in_60"])
    assert torch.equal(cc.rfft_forward(r, xr), r.forward(xr))
    spec = r.forward(xr)
    assert torch.equal(cc.rfft_inverse(r, spec), r.inverse(spec))
    for name in cc.__all__:
        assert callable(getattr(cc, name)), name


def test_fft_stride_column_walk():
    """fft_stride's column walk (tests/test_compat.py): the reference's
    naive_real_2d strides the second-axis transform through a flat
    column-major buffer; the composition is fft2, and the JAX package's
    strided plan gives the same buffer."""
    r = np.random.default_rng(81)
    m, n = 8, 6
    x = r.standard_normal((m, n)) + 1j * r.standard_normal((m, n))
    y = torch.from_numpy(x.flatten(order="F").astype(np.complex128))
    fm, fn = cc.fft_create(m), cc.fft_create(n)
    cc.fft_stride(fn, m)
    jn = jc.fft_create(n)
    jc.fft_stride(jn, m)
    for j in range(n):
        y[j * m:(j + 1) * m] = fm.forward(y[j * m:(j + 1) * m])
    for i in range(m):
        seg = y[i: i + (n - 1) * m + 1]
        want = np.asarray(jn.forward(to_np(seg)))
        y[i: i + (n - 1) * m + 1] = fn.forward(seg)
        assert rel_err(y[i: i + (n - 1) * m + 1], want) < TOL
    got = to_np(y).reshape((m, n), order="F")
    assert rel_err(got, np.fft.fft2(x) / (m * n)) < TOL
    # gap elements untouched by a strided call
    f3 = cc.fft_create(3)
    cc.fft_stride(f3, 2)
    buf = torch.arange(6.0, dtype=torch.float64).to(torch.complex128)
    out = f3.forward(buf)
    assert torch.equal(out[1::2], buf[1::2])
    assert torch.allclose(out[0:5:2], cc.fft_create(3).forward(buf[0:5:2]))
    # reset semantics + error on short buffers
    cc.fft_stride(f3, 0)
    assert f3.inc == 1
    cc.fft_stride(f3, 4)
    with pytest.raises(ValueError):
        f3.forward(torch.zeros(5, dtype=torch.complex128))


def test_rfft_plan_stride_raises():
    """An rfft plan is not length-preserving: a stride raises a clear
    ValueError (the reference fails with a shape error inside its
    scatter); stride 1 and resets stay allowed."""
    f = cc.rfft_create(8)
    with pytest.raises(ValueError, match="not length-preserving"):
        cc.fft_stride(f, 2)
    cc.fft_stride(f, 1)
    cc.fft_stride(f, 0)
    assert f.inc == 1
    x = torch.arange(8, dtype=torch.float64)
    assert torch.allclose(f.inverse(f.forward(x)), x)


def test_create_validation():
    with pytest.raises(ValueError):
        cc.fft_create(0)
    with pytest.raises(ValueError):
        cc.dct1_create(1)
    with pytest.raises(ValueError):
        cc.dct4_create(5)   # even only
    with pytest.raises(ValueError):
        cc.gdft_create(8, 1.5, 0.0)
    f = cc.fft_create(8)
    with pytest.raises(ValueError):
        f.forward(torch.ones(9, dtype=torch.complex128))
    with pytest.raises(ValueError):
        cc.fft2_create(4, 6).forward(torch.ones((4, 6), dtype=torch.complex128))
    with pytest.raises(ValueError):
        cc.rfft_create(8).inverse(torch.ones(4, dtype=torch.complex128))
    cc.fft_free(f)  # no-op, must not raise


def test_tables_follow_the_data():
    """The quirk tables are tensors in the data's dtype on its device:
    float32 data stays float32 through rfft's packing and dst's ortho
    weights."""
    x = torch.arange(1.0, 9.0, dtype=torch.float32)
    r = cc.rfft_create(8)
    assert r.forward(x).dtype == torch.complex64
    d = cc.dst_create(8)
    cc.fft_ortho(d, True)
    assert d.forward(x).dtype == torch.float32
    assert d.inverse(x).dtype == torch.float32
