"""K3 and K7 on the thread-block cluster (csrc/cluster_pass.cuh): float64
numpy models of the one-pass decomposition and of K7's cross-block maps,
K3's route rule against the kernels' limits, the norm scale handed down
to the kernel wrappers, and K7's cached launch plan.

The CUDA kernels run on the card only: the ``cuda``-marked tests below
hold them against their plain versions there and skip here.
"""
import numpy as np
import pytest
import torch

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.config import fwd_scale, inv_scale
from cfftpack_tpu_torch.ops import fused_fft, rstream as rs
from cfftpack_tpu_torch.ops import stream_fft as sf

from torch_parity import complex_input, real_input, to_np

torch.set_num_threads(1)

# the kernels' limits (csrc/stream_pass.cuh, cluster_pass.cuh, stream_fft.cu)
SMEM_MAX = 232448
MAX_THREADS = 1024
ROW_STRIDE = 137
# the schedules the kernels compile: cluster_pass.cuh's ClCol<m> and
# ClRow, stream_fft.cu's SfRegCol<m>
COMPILED = {128: ((4, 4), (4, 2)), 256: ((4, 4), (4, 4)),
            512: ((4, 4), (4, 4), (2,)), 1024: ((4, 4), (4, 4), (4,)),
            2048: ((4, 4), (4, 4), (4, 2)), 4096: ((4, 4), (4, 4), (4, 4))}


def _err(got, want) -> float:
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cluster_sizes(m):
    """Every C the cluster entry takes at m (cl_config_ok)."""
    return [C for C in (1, 2, 4, 8, 16)
            if 8 * m // C <= MAX_THREADS and _cluster_smem(m, C) <= SMEM_MAX]


def _cluster_smem(m, C):
    """cl_smem: the larger of the column and the row layout."""
    L = 128 // C
    return 4 * max(2 * (m + m // 16) * L, 2 * (m // C) * ROW_STRIDE)


def _col_index(q, lane, lshift):
    """ClShape::col: the column layout with its pad rows and swizzle."""
    sw = (((q & 3) << 3) if lshift >= 5 else
          (((q >> 1) & 1) << 3) if lshift == 4 else 0)
    return ((q + (q >> 4)) << lshift) + (lane ^ sw)


def _row_index(s, k1):
    """ClShape::row."""
    return s * ROW_STRIDE + k1 + (k1 >> 4)


class Cluster:
    """The blocks of one cluster as numpy buffers, in the kernel's
    layouts: column phase, exchange through the owners' buffers, row
    phase."""

    def __init__(self, m: int, C: int):
        self.m, self.C = m, C
        self.L = 128 // C
        self.lshift = self.L.bit_length() - 1
        self.rows = m // C
        size = _cluster_smem(m, C) // 8           # complex slots
        self.buf = [np.full(size, np.nan, dtype=np.complex128)
                    for _ in range(C)]

    def column_phase(self, load):
        """Block c: the m-point DFT over q of its lanes, left in the
        column layout."""
        m, L = self.m, self.L
        q = np.arange(m)
        for c in range(self.C):
            for lane in range(L):
                r = c * L + lane
                col = np.fft.fft(load(q, r))
                self.buf[c][_col_index(q, lane, self.lshift)] = col

    def exchange_and_rows(self):
        """Block c: rows k2 of its range, lane r read from block r // L,
        times W_n^{r k2}; the 128-point DFT over r into the row layout."""
        m, n = self.m, 128 * self.m
        r = np.arange(128)
        owner, lane = r // self.L, r % self.L
        new = []
        for c in range(self.C):
            out = np.full_like(self.buf[c], np.nan)
            for s in range(self.rows):
                k2 = c * self.rows + s
                v = np.array([self.buf[o][_col_index(k2, ln, self.lshift)]
                              for o, ln in zip(owner, lane)])
                v = v * np.exp(-2j * np.pi * r * k2 / n)
                out[_row_index(s, r)] = np.fft.fft(v)
            new.append(out)
        # every block reads before any block writes (the second barrier)
        self.buf = new

    def bin(self, k2, k1):
        """X[k2 + m*k1] from whichever block owns row k2 (ClTile::any)."""
        o, s = divmod(k2, self.rows)
        return self.buf[o][_row_index(s, k1)]

    def natural(self):
        """K3's store: for each k1 a run of m/C contiguous k2."""
        m = self.m
        X = np.empty(128 * m, dtype=np.complex128)
        for c in range(self.C):
            s = np.arange(self.rows)
            for k1 in range(128):
                X[k1 * m + c * self.rows + s] = self.buf[c][_row_index(s, k1)]
        return X


def _routes():
    return [(m, C) for m in sf._CLUSTER_M for C in _cluster_sizes(m)]


# ------------------------------------------------- the decomposition

@pytest.mark.parametrize("m,C", _routes())
def test_one_pass_model_is_the_fft(m, C):
    """The one-pass decomposition in the kernel's layouts, float64: the
    natural spectrum within 1e-12, both directions (the inverse as the
    conjugated forward)."""
    n = 128 * m
    x = complex_input((n,), np.complex128, seed=m + C)
    for inverse in (False, True):
        xin = np.conj(x) if inverse else x
        cl = Cluster(m, C)
        cl.column_phase(lambda q, r: xin[128 * q + r])
        cl.exchange_and_rows()
        X = cl.natural()
        if inverse:
            X, want = np.conj(X), np.fft.ifft(x) * n
        else:
            want = np.fft.fft(x)
        assert not np.isnan(X).any()
        assert _err(X, want) < 1e-12, (m, C, inverse)


@pytest.mark.parametrize("m", sf._CLUSTER_M)
def test_layouts_fit_and_do_not_overlap(m):
    """Both layouts are one-to-one within the block's buffer; the
    exchange's warp (4 rows x 8 lanes) and a column-phase warp hit 32
    banks."""
    for C in _cluster_sizes(m):
        L = 128 // C
        lshift = L.bit_length() - 1
        slots = _cluster_smem(m, C) // 8
        q, lane = np.meshgrid(np.arange(m), np.arange(L), indexing="ij")
        col = _col_index(q, lane, lshift).ravel()
        assert len(set(col)) == col.size and col.max() < slots
        s, k1 = np.meshgrid(np.arange(m // C), np.arange(128), indexing="ij")
        row = _row_index(s, k1).ravel()
        assert len(set(row)) == row.size and row.max() < slots
        # exchange: rows 4w..4w+3 of a block, lanes j + 8t (j < 8)
        for k0 in range(0, m // C, 4):
            for t in range(L // 8):
                banks = {_col_index(k0 + i, 8 * t + j, lshift) % 32
                         for i in range(4) for j in range(8)}
                assert len(banks) == 32, (m, C, k0, t)
        if L >= 32:    # a column-phase warp: 32 lanes of one row
            for qq in range(m):
                assert len({_col_index(qq, ln, lshift) % 32
                            for ln in range(32)}) == 32


def test_compiled_schedules_are_the_plans():
    for m, passes in COMPILED.items():
        assert plan.reg_passes(m) == passes, m
    assert plan.reg_passes(128) == COMPILED[128]        # the row phase
    for m in COMPILED:
        assert plan.reg_twiddles(m).shape[1] == 2


def test_k3_route_fits_the_entry():
    """Every eligible m <= 4096 gets a route whose shared memory and
    thread count the kernels take."""
    seen = set()
    for m in range(16, 4097, 16):
        if not sf.stream_eligible(128 * m, torch.float32):
            continue
        route, arg = sf._k3_route(m)
        seen.add(route)
        if route == "cluster":
            assert m in (128, 256, 512, 1024) and arg in _cluster_sizes(m)
        elif route == "reg":
            assert m in (2048, 4096)
            assert (m // 16) * arg == MAX_THREADS
            assert 8 * (m + m // 16) * arg <= SMEM_MAX
        else:
            assert m not in COMPILED and arg == sf._col_lanes(m)
            assert 16 * m * arg <= SMEM_MAX
    assert seen == {"cluster", "reg", "stage"}
    assert [sf._k3_route(m)[1] for m in sf._CLUSTER_M] == [8, 16, 16, 16]


# ------------------------------------------------- K7's cross-block maps

def _k7_cluster(z, m, C):
    cl = Cluster(m, C)
    cl.column_phase(lambda q, r: z[128 * q + r])
    cl.exchange_and_rows()
    return cl


@pytest.mark.parametrize("m", [128, 512])
def test_rfft_mirror_map_matches_plain(m):
    """ClRsMode<rfft>'s store: each block merges its bins k1 < 64 with
    mirrors read from the owner of row (m - k2) % m, lane (128 - k1) % 128
    on row 0 and 127 - k1 elsewhere."""
    n = 128 * m
    C = sf._cluster_size(m)
    x = real_input((2, n), np.float32, seed=m)
    cl = _k7_cluster(x[0].astype(np.float64) + 1j * x[1], m, C)
    h1 = n // 2 + 1
    U = np.empty(h1, dtype=np.complex128)
    V = np.empty(h1, dtype=np.complex128)
    for k2 in range(m):
        for k1 in range(64):
            Z = cl.bin(k2, k1)
            Zm = cl.bin((m - k2) % m, (128 - k1) % 128 if k2 == 0
                        else 127 - k1)
            U[k2 + m * k1] = 0.5 * (Z + np.conj(Zm))
            V[k2 + m * k1] = -0.5j * (Z - np.conj(Zm))
    ny = cl.bin(0, 64)
    U[-1], V[-1] = ny.real, ny.imag
    pr, pi = rs._rfft_plain(torch.as_tensor(x), n, 0.5)
    assert _err(0.5 * np.stack([U, V]), to_np(pr) + 1j * to_np(pi)) < 1e-5
    assert U[0].imag == 0.0


@pytest.mark.parametrize("m", [128, 512])
def test_dct3_pair_map_matches_plain(m):
    """ClRsMode<dct3>: the load's DCT-III assembly on the natural index
    (y_0 times w0), the conjugated forward, and the store's pairs
    (2t, 2t+1) from t and its partner N-1-t at row m-1-k2, lane 127-k1."""
    n = 128 * m
    C = sf._cluster_size(m)
    scale, w0 = 0.5, 1.25
    y = real_input((2, n), np.float32, seed=m + 1).astype(np.float64)
    k = np.arange(n)
    ph = np.exp(-1j * np.pi * k / (2 * n))

    def U(t):
        u = np.conj(ph) * (t - 1j * t[(n - k) % n])
        u[0] = w0 * t[0]
        u[n // 2] = np.sqrt(2.0) * t[n // 2]
        return u

    Z = U(y[0]) + 1j * U(y[1])
    cl = _k7_cluster(np.conj(Z), m, C)
    out = np.empty((2, n))
    f = 0.5 * scale
    for k2 in range(m):
        for k1 in range(64):
            X = cl.bin(k2, k1)
            P = cl.bin(m - 1 - k2, 127 - k1)
            t = k2 + m * k1
            out[0, 2 * t:2 * t + 2] = f * X.real, f * P.real
            out[1, 2 * t:2 * t + 2] = -f * X.imag, -f * P.imag
    want = rs._dct3_plain(torch.as_tensor(y, dtype=torch.float32), n, scale,
                          w0)
    assert _err(out, to_np(want)) < 1e-5


# ------------------------------------------------- the norm's scale

def test_scaled_wrappers_are_the_unscaled_times_the_scale():
    n = 16384                                    # m = 128: the cluster route
    xr, xi = (torch.as_tensor(v) for v in
              (lambda c: (c.real.copy(), c.imag.copy()))(
                  complex_input((2, n), np.complex64, seed=3)))
    for inverse in (False, True):
        ur, ui = sf.sfft_stream(xr, xi, n, inverse)
        yr, yi = sf.sfft_stream(xr, xi, n, inverse, 0.25)
        assert torch.allclose(yr, ur * 0.25, rtol=1e-6, atol=1e-6)
        assert torch.allclose(yi, ui * 0.25, rtol=1e-6, atol=1e-6)
    x = torch.as_tensor(real_input((2, n), np.float32, seed=4))
    ur, ui = rs.srfft_stream(x, n)
    yr, yi = rs.srfft_stream(x, n, 0.5)
    assert torch.allclose(yr, ur * 0.5) and torch.allclose(yi, ui * 0.5)
    back = rs.sirfft_stream(ur, ui, n)
    assert torch.allclose(rs.sirfft_stream(ur, ui, n, 0.5), back * 0.5)
    for fn in (rs.sdct2_stream, rs.sdct3_stream):
        u = fn(x, n)
        assert torch.allclose(fn(x, n, 0.5), u * 0.5)
    w = rs.sdct2_stream(x, n, 0.5, 3.0)
    u = rs.sdct2_stream(x, n)
    assert torch.allclose(w[:, 1:], u[:, 1:] * 0.5)
    assert torch.allclose(w[:, 0], u[:, 0] * 1.5)
    x0 = x.clone()
    x0[:, 0] *= 3.0
    assert torch.allclose(rs.sdct3_stream(x, n, 0.5, 3.0),
                          rs.sdct3_stream(x0, n) * 0.5, rtol=1e-5, atol=1e-5)


def _spy(monkeypatch, mod, name):
    """Record the scale arguments of each call of ``mod.<name>``."""
    got = []
    real = getattr(mod, name)

    def spy(*args, **kwargs):
        skip = {"sfft_stream": 4, "sirfft_stream": 3}.get(name, 2)
        got.append(args[skip:])
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, name, spy)
    return got


@pytest.mark.parametrize("norm", ["ortho", "forward", "backward"])
def test_fft_split_hands_its_norm_to_k3(monkeypatch, norm):
    got = _spy(monkeypatch, sf, "sfft_stream")
    n = 16384
    c = complex_input((2, n), np.complex64, seed=5)
    xr, xi = torch.as_tensor(c.real.copy()), torch.as_tensor(c.imag.copy())
    yr, yi = pt.fft_split(xr, xi, norm=norm)
    zr, zi = pt.ifft_split(yr, yi, norm=norm)
    assert got == [(fwd_scale(norm, n),), (inv_scale(norm, n),)]
    assert _err(to_np(zr) + 1j * to_np(zi), c) < 1e-5


@pytest.fixture
def k1_small(monkeypatch):
    """K1 held to n <= 512, so the K7 gates open at test sizes."""
    monkeypatch.setattr(fused_fft, "_SMEM_BUDGET", 8192)


@pytest.mark.parametrize("norm", ["ortho", "forward", "backward"])
def test_rfft_split_hands_its_norm_to_k7(monkeypatch, k1_small, norm):
    fwd = _spy(monkeypatch, rs, "srfft_stream")
    inv = _spy(monkeypatch, rs, "sirfft_stream")
    n = 2048
    x = real_input((2, n), np.float32, seed=6)
    yr, yi = pt.rfft_split(torch.as_tensor(x), norm=norm)
    back = pt.irfft_split(yr, yi, n, norm=norm)
    assert fwd == [(fwd_scale(norm, n),)] and inv == [(inv_scale(norm, n),)]
    assert np.abs(to_np(back) - x).max() < 5e-5
    want = np.fft.rfft(x.astype(np.float64)) * fwd_scale(norm, n)
    assert _err(to_np(yr) + 1j * to_np(yi), want) < 1e-5


@pytest.mark.parametrize("fn,t,name", [
    ("dct", 2, "sdct2_stream"), ("dct", 3, "sdct3_stream"),
    ("idct", 2, "sdct3_stream"), ("idct", 3, "sdct2_stream"),
    ("dst", 2, "sdct2_stream"), ("dst", 3, "sdct3_stream")])
@pytest.mark.parametrize("norm", ["ortho", "fftpack"])
def test_dct_hands_its_norm_to_k7(monkeypatch, k1_small, fn, t, name, norm):
    """dct/idct/dst types 2-3 on the K7 route: one wrapper call with the
    norm's (scale, w0), no multiply after it, the reference's values."""
    import scipy.fft
    got = _spy(monkeypatch, rs, name)
    n = 2048
    x = real_input((2, n), np.float32, seed=7 + t)
    y = getattr(pt, fn)(torch.as_tensor(x), t, norm=norm)
    assert len(got) == 1
    scale, w0 = got[0]
    kind = name[4]                                   # the core's type
    if norm == "ortho":
        assert scale == pytest.approx(np.sqrt(2.0 / n))
        assert w0 == pytest.approx(np.sqrt(0.5) if kind == "2"
                                   else np.sqrt(2.0))
    else:
        assert w0 == 1.0 and scale in (1.0, pytest.approx(2.0 / n))
    if norm == "ortho":
        sp = getattr(scipy.fft, fn)(x.astype(np.float64), t, norm="ortho")
        assert _err(to_np(y), sp) < 1e-5


# ------------------------------------------------- K7's launch plan

def test_k7_launch_plan_is_cached_and_rebuilt():
    dev = torch.device("cpu")
    n = 65536
    a = rs._launch_plan("dct2", n, dev)
    assert rs._launch_plan("dct2", n, dev) is a
    assert a.cluster == sf._cluster_size(512) and a.reg[0] is not None
    b = rs._launch_plan("dct4", 2 * n, dev)
    assert b.cluster == 0 and b.reg == (None, None)
    plan.clear_device_tables()
    c = rs._launch_plan("dct2", n, dev)
    assert c is not a and c.version == plan.VERSION
    assert rs._launch_plan("dct2", n, dev) is c
    # the stage-loop route keeps the permuted phase table
    assert rs._launch_plan("dct2", 6144, dev).cluster == 0


# ------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256, 512, 1024, 2048, 4096, 768])
def test_k3_routes_match_plain_on_card(m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n = 128 * m
    for inverse, scale in ((False, 1.0), (True, 0.5), (False, 0.25)):
        mode = "inv_nat" if inverse else "fwd_nat"
        b = 3
        shape = (b, 128, m) if inverse else (b, m, 128)
        c = complex_input(shape, np.complex64, seed=m)
        xr = torch.as_tensor(c.real.copy(), device="cuda")
        xi = torch.as_tensor(c.imag.copy(), device="cuda")
        before = sf.launches["K3"]
        yr, yi = sf._launch(xr, xi, n, mode, scale=scale)
        assert sf.launches["K3"] == before + 1
        pr, pi = sf.stream_plain(xr, xi, n, mode, scale=scale)
        torch.cuda.synchronize()
        assert _err(to_np(yr) + 1j * to_np(yi),
                    to_np(pr) + 1j * to_np(pi)) < 1e-5, (m, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 512, 1024, 48])
def test_k7_modes_match_plain_on_card(m):
    """K7's four modes with a scale and w0: the cluster route at m = 128,
    512, 1024; the stage loop, the wrapper applying them, at m = 48."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n = 128 * m
    x = torch.as_tensor(real_input((6, n), np.float32, seed=m),
                        device="cuda")
    yr, yi = rs.launch("rfft", n, x, scale=0.5)
    pr, pi = rs._rfft_plain(x, n, 0.5)
    assert _err(to_np(yr) + 1j * to_np(yi), to_np(pr) + 1j * to_np(pi)
                ) < 1e-5
    assert not to_np(yi)[:, 0].any() and not to_np(yi)[:, -1].any()
    assert _err(to_np(rs.launch("irfft", n, pr, pi, scale=0.5)),
                to_np(rs._irfft_plain(pr, pi, n, 0.5))) < 1e-5
    for mode, plain in (("dct2", rs._dct2_plain), ("dct3", rs._dct3_plain)):
        assert _err(to_np(rs.launch(mode, n, x, scale=0.5, w0=1.5)),
                    to_np(plain(x, n, 0.5, 1.5))) < 1e-5, (m, mode)
    torch.cuda.synchronize()
