"""K2, K3, K4, K7 and K8 on the thread-block cluster
(csrc/cluster_pass.cuh): float64 numpy models of the one-pass
decomposition in both orders (columns first for K3, K7, K8 and K2's
forward, rows first for K4 and K2's inverse), of K2's permuted stores
and of the cross-block maps of K7 and K8, the layouts' bank checks, the
route rules against the kernels' limits, what the wrappers hand the C
entry (the norm scale, K2's strided pair rows), and K7's and K8's
cached launch plan.

The CUDA kernels run on the card only: the ``cuda``-marked tests below
hold them against their plain versions there and skip here.  The JAX
package's K2 (``_stream_pallas_2d``) and K4 (``_stream_filter_inv_2d``)
run in interpret mode.
"""
import functools
import importlib
import sys
import types

import numpy as np
import pytest
import scipy.fft
import torch
import jax.numpy as jnp

import cfftpack_tpu.ops.pallas_stream as ps

import cfftpack_tpu_torch as pt
from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.config import VALID_NORMS, fwd_scale, inv_scale
from cfftpack_tpu_torch.ops import fused_fft, rstream as rs
from cfftpack_tpu_torch.ops import stream_fft as sf
from cfftpack_tpu_torch.utils import profiling

from torch_parity import complex_input, real_input, to_np

pdct = importlib.import_module("cfftpack_tpu_torch.ops.dct")

torch.set_num_threads(1)

# the kernels' limits (csrc/stream_pass.cuh, cluster_pass.cuh, stream_fft.cu)
SMEM_MAX = 232448
MAX_THREADS = 1024
ROW_STRIDE = 137
RF_ROW_STRIDE = 152                      # the rows-first order's (CL_RF_RS)
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


# ------------------------------------------------- the rows-first order

def _rf_smem(m, C):
    """cl_smem(m, C, CL_RF_RS)."""
    L = 128 // C
    return 4 * max(2 * (m + m // 16) * L, 2 * (m // C) * RF_ROW_STRIDE)


def _rf_cluster_sizes(m):
    """Every C the rows-first entry takes at m (cl_config_ok with
    CL_RF_RS)."""
    return [C for C in (1, 2, 4, 8, 16)
            if 8 * m // C <= MAX_THREADS and _rf_smem(m, C) <= SMEM_MAX]


def _rf_row_index(s, k1, stride=RF_ROW_STRIDE):
    """cl_rf_row: a pad word after every 8 lanes."""
    return s * stride + k1 + (k1 >> 3)


class RowsFirst:
    """The blocks of one cluster in the rows-first order, as numpy
    buffers in the kernel's layouts: each block's rows k2 through the
    128-point DFT into the row layout, then each block's lanes r read
    from the owners of every row, times W_n^{r k2}, through the m-point
    DFT to the natural output x[128 q + r]."""

    def __init__(self, m: int, C: int):
        self.m, self.C = m, C
        self.L = 128 // C
        self.rows = m // C
        size = _rf_smem(m, C) // 8                # complex slots
        self.buf = [np.full(size, np.nan, dtype=np.complex128)
                    for _ in range(C)]

    def row_phase(self, load):
        k1 = np.arange(128)
        for c in range(self.C):
            for s in range(self.rows):
                row = np.fft.fft(load(c * self.rows + s, k1))
                self.buf[c][_rf_row_index(s, k1)] = row

    def column_phase(self):
        """Every block's column store, as the natural (n,) output."""
        m, n = self.m, 128 * self.m
        k2 = np.arange(m)
        owner, slot = k2 // self.rows, k2 % self.rows
        x = np.full(n, np.nan, dtype=np.complex128)
        for c in range(self.C):
            for lane in range(self.L):
                r = c * self.L + lane
                v = np.array([self.buf[o][_rf_row_index(s, r)]
                              for o, s in zip(owner, slot)])
                v = v * np.exp(-2j * np.pi * r * k2 / n)
                x[128 * k2 + r] = np.fft.fft(v)        # output q = k2
        return x


def _rf_filter(X, F, m, C, scale):
    """K4's model on each row of the permuted spectrum X (b, m, 128):
    the load conj(X F), the conjugated forward, the store conj() times
    scale."""
    out = []
    for p in range(X.shape[0]):
        Y = X[p] * F[p % F.shape[0]]
        cl = RowsFirst(m, C)
        cl.row_phase(lambda k2, k1: np.conj(Y[k2, k1]))
        out.append(scale * np.conj(cl.column_phase()))
    return np.stack(out)


def _rf_routes():
    return [(m, C) for m in sf._CLUSTER_M for C in _rf_cluster_sizes(m)]


@pytest.mark.parametrize("m,C", _rf_routes())
def test_rows_first_model_is_the_filter(m, C):
    """The rows-first decomposition in the kernel's layouts, float64,
    for every (m, C) the entry takes: n times the inverse FFT of the
    filtered spectrum, times the scale, within 1e-12, at s = 1 and 2."""
    n = 128 * m
    X = complex_input((3, m, 128), np.complex128, seed=m + C)
    for s in (1, 2):
        F = complex_input((s, m, 128), np.complex128, seed=m + s)
        got = _rf_filter(X, F, m, C, 0.5)
        assert not np.isnan(got).any()
        # natural bin k = k2 + m*k1 is the (128, m) transpose of [k2, k1]
        Y = X * F[np.arange(3) % s]
        want = np.fft.ifft(Y.transpose(0, 2, 1).reshape(3, n)) * n * 0.5
        assert _err(got, want) < 1e-12, (m, C, s)


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("m", sf._CLUSTER_M)
def test_rows_first_model_matches_plain_and_pallas(m, s):
    """K4's model at the route's C on float32 inputs, against the plain
    version (``stream_plain(..., "filter")``) and the JAX package's K4
    (``_stream_filter_inv_2d``, interpret mode) within 1e-6."""
    n = 128 * m
    C = sf._filter_cluster_size(m)
    xr, xi = (complex_input((2, m, 128), np.complex64, seed=m + 3 * s)
              .view(np.float32).reshape(2, m, 128, 2).transpose(3, 0, 1, 2))
    fr, fi = (complex_input((s, m, 128), np.complex64, seed=m + s + 9)
              .view(np.float32).reshape(s, m, 128, 2).transpose(3, 0, 1, 2))
    xr, xi, fr, fi = (np.ascontiguousarray(v) for v in (xr, xi, fr, fi))
    got = _rf_filter(xr + 1j * xi.astype(np.float64), fr + 1j * fi.astype(
        np.float64), m, C, 1.0).reshape(2, m, 128)
    pr, pi = sf.stream_plain(*(torch.as_tensor(v) for v in (xr, xi)), n,
                             "filter", torch.as_tensor(fr),
                             torch.as_tensor(fi))
    assert _err(got, to_np(pr) + 1j * to_np(pi)) < 1e-6
    wr, wi = ps._stream_filter_inv_2d(*(jnp.asarray(v)
                                        for v in (xr, xi, fr, fi)), n)
    assert _err(got, np.asarray(wr) + 1j * np.asarray(wi)) < 1e-6


def _row_phase_accesses():
    """The shared-memory accesses of the row phase's passes after the
    first load, as ClRow runs them on 8 threads a row (regfft.cuh's
    rf_pass): for each (pass, butterfly round, register) the 8 threads'
    in-row indices."""
    acc, L = [], 1
    for i, qs in enumerate(plan.reg_passes(128)):
        R = int(np.prod(qs))
        MN = 128 // (L * R)
        nb = -(-(128 // R) // 8)
        for b in range(nb):
            beta = np.arange(8) + 8 * b
            l, j = beta // MN, beta % MN
            for t in range(R):
                if i > 0:                                  # reads
                    acc.append((l * R + t) * MN + j)
                acc.append((t * L + l) * MN + j)           # writes
        L *= R
    return acc


def _bank_counts(index, L=None):
    """The most threads of a warp on one bank in the row layout
    ``index(s, k1)``: the row phase (4 rows of 8 threads a warp), or with
    L the column phase's first loads at L lanes a block (32/L consecutive
    rows k2 of L consecutive lanes r; one row of 32 lanes past L = 32)."""
    worst = 1
    if L is None:
        for e in _row_phase_accesses():
            at = [index(s, k) for s in range(4) for k in e]
            worst = max(worst, np.bincount(np.array(at) % 32).max())
        return worst
    w = min(L, 32)
    for r0 in range(0, 128, w):
        at = [index(s, r0 + k) for s in range(max(1, 32 // L))
              for k in range(w)]
        worst = max(worst, np.bincount(np.array(at) % 32).max())
    return worst


def test_rows_first_layout_fits_and_hits_32_banks():
    """The row layout is one-to-one within every block's buffer; every
    warp of the row phase hits 32 banks, and so does every column-phase
    read of the row layout at L = 8 lanes a block (the route's C = 16 at
    m = 512, 1024), where the columns-first row layout (stride 137, a pad
    word after every 16) puts two or more threads on a bank; at the
    route's L = 64 (C = 2 at m = 128, 256) two threads share a bank."""
    for m in sf._CLUSTER_M:
        C = sf._filter_cluster_size(m)
        assert C in _rf_cluster_sizes(m)
        assert _bank_counts(_rf_row_index, 128 // C) == (1 if m >= 512
                                                         else 2)
        for C in _rf_cluster_sizes(m):
            slots = _rf_smem(m, C) // 8
            s, k1 = np.meshgrid(np.arange(m // C), np.arange(128),
                                indexing="ij")
            row = _rf_row_index(s, k1).ravel()
            assert len(set(row)) == row.size and row.max() < slots
            L = 128 // C
            q, lane = np.meshgrid(np.arange(m), np.arange(L), indexing="ij")
            col = _col_index(q, lane, L.bit_length() - 1).ravel()
            assert col.max() < slots
    assert _bank_counts(_rf_row_index) == 1
    assert _bank_counts(_rf_row_index, 8) == 1
    assert _bank_counts(_row_index) >= 2 and _bank_counts(_row_index, 8) >= 2


# ------------------------------------------------- K2 on the cluster

@functools.lru_cache(maxsize=None)
def _k2_reference(m: int, inverse: bool):
    """A seeded (2, m, 128) float32 pair, its plain K2
    (``stream_plain(..., "fwd"/"inv")``) and the JAX package's K2
    (``_stream_pallas_2d``, interpret mode), once per (m, direction)."""
    n = 128 * m
    c = complex_input((2, m, 128), np.complex64, seed=m + 5 * inverse)
    xr, xi = np.ascontiguousarray(c.real), np.ascontiguousarray(c.imag)
    pr, pi = sf.stream_plain(torch.as_tensor(xr), torch.as_tensor(xi), n,
                             "inv" if inverse else "fwd")
    wr, wi = ps._stream_pallas_2d(jnp.asarray(xr), jnp.asarray(xi), n,
                                  inverse)
    return (xr + 1j * xi.astype(np.float64), to_np(pr) + 1j * to_np(pi),
            np.asarray(wr) + 1j * np.asarray(wi))


def _perm_store(cl):
    """ClPermMode's store: block c writes its rows as they lie, element e
    of its run at [c*m/C + e // 128, e % 128], from slot e >> 7, lane
    e & 127 of its row layout."""
    X = np.full(cl.m * 128, np.nan, dtype=np.complex128)
    e = np.arange(cl.rows * 128)
    for c in range(cl.C):
        X[c * cl.rows * 128 + e] = cl.buf[c][_row_index(e >> 7, e & 127)]
    return X.reshape(cl.m, 128)


@pytest.mark.parametrize("m,C", _routes())
def test_permuted_store_model_is_k2(m, C):
    """K2's forward on the columns-first cluster in the kernel's layouts,
    float64, for every (m, C) the entry takes, each transform read
    through a row stride of 2n (ClPermMode::col_load on sfilter_stream's
    paired rows): X[k2 + m*k1] at [k2, k1] within 1e-12 of numpy.fft,
    and within 1e-6 of the plain version and of the JAX K2 (interpret
    mode) on the same float32 inputs."""
    n = 128 * m
    x, plain, pallas = _k2_reference(m, False)
    rows = np.zeros((2, 2, n), dtype=np.complex128)
    rows[:, 0] = x.reshape(2, n)                  # the other plane's rows
    flat = rows.reshape(-1)
    for p in range(2):
        cl = Cluster(m, C)
        cl.column_phase(lambda q, r: flat[p * 2 * n + 128 * q + r])
        cl.exchange_and_rows()
        got = _perm_store(cl)
        want = np.fft.fft(x[p].reshape(n)).reshape(128, m).T
        assert not np.isnan(got).any()
        assert _err(got, want) < 1e-12, (m, C)
        assert _err(got, plain[p]) < 1e-6 and _err(got, pallas[p]) < 1e-6


@pytest.mark.parametrize("m,C", _rf_routes())
def test_rows_first_model_is_k2_inverse(m, C):
    """K2's inverse on the rows-first cluster, K4's kernel without the
    filter (the load conj(X), the conjugated forward, the store conj()),
    float64, for every (m, C) the entry takes: n times the inverse FFT of
    the permuted spectrum within 1e-12, and within 1e-6 the plain version
    and the JAX K2 (interpret mode)."""
    n = 128 * m
    X, plain, pallas = _k2_reference(m, True)
    got = _rf_filter(X, np.ones((1, m, 128)), m, C, 1.0).reshape(2, m, 128)
    want = np.fft.ifft(X.transpose(0, 2, 1).reshape(2, n)) * n
    assert _err(got, want.reshape(2, m, 128)) < 1e-12
    assert _err(got, plain) < 1e-6 and _err(got, pallas) < 1e-6


def test_register_route_permuted_store_matches_plain():
    """K2's forward at m = 2048 on K5's register kernels at s = 1, float64:
    the column pass (the m-point DFT of each lane r, times W_n^{r k2})
    into the scratch row k2, the row pass's 128-point DFT of 16 rows a
    block into its slot layout (137 words a slot, a pad word after every
    16 lanes), and SFSplitRowIO's permuted store, element e of block g at
    g*2048 + e from slot e >> 7, lane e & 127: numpy.fft within 1e-12,
    the plain version within 1e-6."""
    m, rs = 2048, 137
    n = 128 * m
    c = complex_input((1, m, 128), np.complex64, seed=2048)
    xr, xi = np.ascontiguousarray(c.real), np.ascontiguousarray(c.imag)
    x = (xr + 1j * xi.astype(np.float64))[0]
    k2, r = np.arange(m)[:, None], np.arange(128)[None, :]
    scratch = np.fft.fft(x, axis=0) * np.exp(-2j * np.pi * k2 * r / n)
    slot, lane = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    tiles = np.full((m // 16, 16 * rs), np.nan, dtype=np.complex128)
    tiles[:, slot * rs + lane + (lane >> 4)] = np.fft.fft(
        scratch.reshape(m // 16, 16, 128), axis=2)
    e = np.arange(16 * 128)
    y = np.full((m // 16, 16 * 128), np.nan, dtype=np.complex128)
    y[:, e] = tiles[:, (e >> 7) * rs + (e & 127) + ((e & 127) >> 4)]
    got = y.reshape(m, 128)                        # block g's run at g*2048
    assert _err(got, np.fft.fft(x.reshape(n)).reshape(128, m).T) < 1e-12
    pr, pi = sf.stream_plain(torch.as_tensor(xr), torch.as_tensor(xi), n,
                             "fwd")
    assert _err(got, (to_np(pr) + 1j * to_np(pi))[0]) < 1e-6


@pytest.fixture
def entry(monkeypatch):
    """``stream_fft_f32`` as a recorder of its arguments (no card here):
    the wrappers run on CPU tensors up to the C entry, which launches
    nothing; the launch counts are restored after."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(sf, "_check_device", lambda *a: None)
    monkeypatch.setattr(profiling, "launches", dict(profiling.launches))
    monkeypatch.setattr(sf._build, "load",
                        lambda: types.SimpleNamespace(stream_fft_f32=record))
    monkeypatch.setattr(sf._build, "_enter",
                        lambda fn, dev, args: fn(*args, None))
    return calls


def test_sfilter_stream_hands_k2_the_paired_rows(monkeypatch, entry):
    """At m = 512 sfilter_stream hands K2's forward the strided views of
    the paired rows (row stride 2n), and _launch passes them to the C
    entry as they lie, in_rs = 2n: no ``.contiguous()`` copy; K4 then
    writes the paired rows (ys = 2n).  Arguments end ..., mode, csize,
    lshift, in_rs, ys, scale, stream."""
    got = []
    launch = sf._launch

    def run(xr, xi, n, mode, *args, **kwargs):
        got.append((mode, xr.data_ptr(), xi.data_ptr(), xr.stride()))
        return launch(xr, xi, n, mode, *args, **kwargs)

    monkeypatch.setattr(sf, "_run", run)
    n = 65536
    x = torch.as_tensor(real_input((4, n), np.float32, seed=12))
    F = complex_input((n,), np.complex64, seed=13)
    sf.sfilter_stream(x, torch.as_tensor(F.real.copy()),
                      torch.as_tensor(F.imag.copy()), n, 0.5)
    (mode, pr, pi, stride), (mode4, *_) = got
    assert (mode, mode4) == ("fwd", "filter")
    assert stride == (2 * n, 128, 1)
    assert (pr, pi) == (x.data_ptr(), x.data_ptr() + 4 * n)
    fwd, filt = entry
    assert fwd[:2] == (pr, pi) and fwd[-7] == sf._MODES.index("fwd")
    assert fwd[-6] == sf._cluster_size(512) and fwd[-4] == 2 * n
    assert filt[-7] == sf._MODES.index("filter") and filt[-3] == 2 * n
    assert profiling.launches["K2"] == profiling.launches["K4"] == 1


def test_sfilter_stream_copies_only_rows_k2_cannot_read(monkeypatch, entry):
    """rfilter_split along axis 0 of a (n, 4) x hands sfilter_stream
    rows with element stride 4: they are copied once into rows that K2's
    forward reads (in_rs = n) and it launches, where _launch refuses them
    as they lie; K4 still writes the paired rows of the output (ys =
    2n)."""
    monkeypatch.setattr(sf, "_run", sf._launch)
    n = 65536
    x = torch.as_tensor(real_input((n, 4), np.float32, seed=14))
    xp = x.movedim(0, -1).reshape(2, 2, n)
    with pytest.raises(ValueError, match="row stride"):
        sf._launch(xp[:, 0].reshape(2, 512, 128),
                   xp[:, 1].reshape(2, 512, 128), n, "fwd")
    F = complex_input((n // 2 + 1,), np.complex64, seed=15)
    F.imag[[0, -1]] = 0.0
    pt.rfilter_split(x, torch.as_tensor(F.real.copy()),
                     torch.as_tensor(F.imag.copy()), axis=0)
    fwd, filt = entry
    assert fwd[-7] == sf._MODES.index("fwd") and fwd[-4] == n
    assert fwd[0] != x.data_ptr()
    assert filt[-7] == sf._MODES.index("filter") and filt[-3] == 2 * n
    assert profiling.launches["K2"] == profiling.launches["K4"] == 1


@pytest.mark.parametrize("inverse", [False, True])
def test_k2_routes_take_their_tables(entry, inverse):
    """What _launch hands the C entry on each of K2's routes: the cluster
    and register routes the forward outer twiddle (the inverse runs as
    the conjugated forward) and the register pass twiddles of m
    (plan.reg_twiddles, the compiled schedules' tables), no scratch on
    the cluster and a (b, n) pair of scratch planes on the register
    route; the stage loop the direction's own twiddle and no pass
    twiddles.  Arguments: x, y, s (2 each), t1r, t1i, the 10 plan
    arguments, cptw, rptw, ..."""
    dev = torch.device("cpu")
    for m in (128, 512, 2048, 48):
        n = 128 * m
        route, arg = sf._k2_route(m, inverse)
        x = torch.zeros((3, m, 128))
        sf._launch(x, x, n, "inv" if inverse else "fwd")
        args = entry.pop()
        lp = sf._launch_plan(n, inverse, 1, dev)
        held = {t.data_ptr(): t for t in lp.keep
                if isinstance(t, torch.Tensor)}
        t1r = held[args[6]]
        forward = route != "stage" or not inverse
        assert np.array_equal(t1r.numpy(), sf._tables(n, not forward)[0])
        assert (args[4] is None) == (route == "cluster")
        assert args[-6] == (arg if route == "cluster" else 0)
        if route == "stage":
            assert args[18] is None and args[19] is None
        else:
            want = plan.reg_twiddles(m).astype(np.float32)
            assert np.array_equal(held[args[18]].numpy(), want)


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


# the routes by m of K3 and of K2 in each direction
_ROUTE_OF = {"K3": sf._k3_route,
             "K2 fwd": lambda m: sf._k2_route(m, False),
             "K2 inv": lambda m: sf._k2_route(m, True)}


def _eligible_m():
    return [m for m in range(16, 4097, 16)
            if sf.stream_eligible(128 * m, torch.float32)]


@pytest.mark.parametrize("kernel", list(_ROUTE_OF))
def test_compiled_schedules_are_the_plans(kernel):
    """The compiled schedules are the plan's, and the kernel's routes run
    register passes (on the cluster or K5's register kernels) at exactly
    the m compiled for them: every compiled m for K3 and K2's forward,
    the cluster's four for K2's inverse."""
    for m, passes in COMPILED.items():
        assert plan.reg_passes(m) == passes, m
    assert plan.reg_passes(128) == COMPILED[128]        # the row phase
    for m in COMPILED:
        assert plan.reg_twiddles(m).shape[1] == 2
    reg = {m for m in _eligible_m() if _ROUTE_OF[kernel](m)[0] != "stage"}
    assert reg == (set(sf._CLUSTER_M) if kernel == "K2 inv"
                   else set(COMPILED))


@pytest.mark.parametrize("kernel", list(_ROUTE_OF))
def test_k3_route_fits_the_entry(kernel):
    """Every eligible m <= 4096 gets a route of K3, or of K2 in either
    direction, whose shared memory and thread count the kernels take: the
    cluster at m = 128 .. 1024, at a C the entry takes columns first (K3,
    K2's forward) or rows first (K2's inverse); K5's register kernels at
    2048 and 4096, for all but K2's inverse; the stage loop elsewhere."""
    inverse = kernel == "K2 inv"
    seen = set()
    for m in _eligible_m():
        route, arg = _ROUTE_OF[kernel](m)
        seen.add(route)
        if route == "cluster":
            assert m in (128, 256, 512, 1024)
            assert arg in (_rf_cluster_sizes(m) if inverse
                           else _cluster_sizes(m))
        elif route == "reg":
            assert m in (2048, 4096) and not inverse
            assert (route, arg) == sf._k3_route(m)
            assert (m // 16) * arg == MAX_THREADS
            assert 8 * (m + m // 16) * arg <= SMEM_MAX
        else:
            assert arg == sf._col_lanes(m)
            assert 16 * m * arg <= SMEM_MAX
            assert m not in COMPILED or (inverse and m in (2048, 4096))
    assert seen == {"cluster", "stage"} | (set() if inverse else {"reg"})
    rule = [_ROUTE_OF[kernel](m)[1] for m in sf._CLUSTER_M]
    assert rule == ([sf._filter_cluster_size(m) for m in sf._CLUSTER_M]
                    if inverse else [8, 16, 16, 16])


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


@pytest.mark.parametrize("dst", [False, True])
@pytest.mark.parametrize("m", sf._CLUSTER_M)
def test_dct4_pair_maps_match_plain(m, dst):
    """ClRsMode<dct4> on the columns-first cluster, float64: the pair
    load c[j] = x[2j] + i*x[n-1-2j] (the two reads swapped for DST-IV)
    times the pre-rotation, then the store's pairs (2t, 2t+1) from bin t
    and its partner N-1-t at row m-1-k2, lane 127-k1 of another block,
    times the natural post-phase, the odd sign -1 (DST-IV +1) and the
    scale: scipy's type-4 DCT or DST within 1e-12, the plain version
    (float32 tables) within 1e-6."""
    N = 128 * m
    n = 2 * N
    C = sf._cluster_size(m)
    x = real_input((n,), np.float32, seed=m + dst).astype(np.float64)
    pre, post = rs._dct4_phases(n)
    j = np.arange(N)
    a, c = x[2 * j], x[n - 1 - 2 * j]
    v = ((c + 1j * a) if dst else (a + 1j * c)) * pre
    cl = _k7_cluster(v, m, C)
    k2, k1 = np.meshgrid(np.arange(m), np.arange(128), indexing="ij")
    Z = np.vectorize(cl.bin)(k2, k1)
    P = np.vectorize(cl.bin)(m - 1 - k2, 127 - k1)
    tt = (k2 + m * k1).ravel()
    scale = 0.25
    y = np.empty(n)
    y[2 * tt] = scale * (Z.ravel() * post[tt]).real
    y[2 * tt + 1] = ((1.0 if dst else -1.0) * scale
                     * (P.ravel() * post[N - 1 - tt]).imag)
    want = (scipy.fft.dst if dst else scipy.fft.dct)(x, 4) / 2 * scale
    assert _err(y, want) < 1e-12
    plain = pdct._dct4_stream_plain(
        torch.as_tensor(x[None].astype(np.float32)), n, scale, dst)
    assert _err(y, to_np(plain)[0]) < 1e-6


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


@pytest.mark.parametrize("norm", VALID_NORMS)
def test_rfilter_split_hands_its_norm_to_k4(monkeypatch, norm):
    """rfilter_split on the streaming route: one sfilter_stream call with
    the norm's fwd_scale * inv_scale, its result returned as it is (no
    multiply after), the reference's values."""
    got = []
    real = sf.sfilter_stream

    def spy(x, ffr, ffi, n, scale=1.0):
        out = real(x, ffr, ffi, n, scale)
        got.append((scale, out))
        return out

    monkeypatch.setattr(sf, "sfilter_stream", spy)
    n = 32768                        # m = 256: K1 does not take n/2
    x = real_input((2, n), np.float32, seed=8)
    F = complex_input((n // 2 + 1,), np.complex128, seed=9)
    fr, fi = F.real.astype(np.float32), F.imag.astype(np.float32)
    fi[0] = fi[-1] = 0.0
    y = pt.rfilter_split(torch.as_tensor(x), torch.as_tensor(fr),
                         torch.as_tensor(fi), norm=norm)
    assert len(got) == 1
    scale, out = got[0]
    assert scale == pytest.approx(fwd_scale(norm, n) * inv_scale(norm, n))
    assert torch.equal(y, out)
    want = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * (fr + 1j * fi),
                        n)
    assert _err(to_np(y), want) < 1e-5


def test_sfilter_stream_stacks_nothing(monkeypatch):
    """At a length K4's cluster takes, sfilter_stream hands K4 the paired
    rows as its output planes and stacks no planes itself."""
    callers = []
    real = torch.stack

    def spy(*args, **kwargs):
        callers.append(sys._getframe(1).f_code.co_name)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "stack", spy)
    n = 65536                                    # m = 512
    x = real_input((2, n), np.float32, seed=10)
    F = complex_input((n,), np.complex64, seed=11)
    got = sf.sfilter_stream(torch.as_tensor(x), torch.as_tensor(F.real.copy()),
                            torch.as_tensor(F.imag.copy()), n, 0.5)
    assert "sfilter_stream" not in callers
    want = ps.sfilter_stream_pallas(jnp.asarray(x), jnp.asarray(F.real),
                                    jnp.asarray(F.imag), n)
    assert _err(to_np(got), 0.5 * np.asarray(want)) < 5e-6


# ------------------------------------------------- K7's launch plan

def test_k7_launch_plan_is_cached_and_rebuilt():
    dev = torch.device("cpu")
    n = 65536
    a = rs._launch_plan("dct2", n, dev)
    assert rs._launch_plan("dct2", n, dev) is a
    assert a.cluster == sf._cluster_size(512) and a.reg[0] is not None
    # K8 at n = 2*65536 runs m = 512 on the cluster, with the natural
    # post-phase; at m = 48 it keeps the stage loop and the permuted one
    def post(lp):
        return next(t for t in lp.keep if isinstance(t, torch.Tensor)
                    and t.data_ptr() == lp.pb[0])

    b = rs._launch_plan("dct4", 2 * n, dev)
    assert b.cluster == sf._cluster_size(512) and b.reg[0] is not None
    assert post(b).shape == (n,)
    s = rs._launch_plan("dct4", 2 * 6144, dev)
    assert s.cluster == 0 and s.reg == (None, None)
    assert post(s).shape == (48, 128)
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
        before = profiling.launches["K3"]
        yr, yi = sf._launch(xr, xi, n, mode, scale=scale)
        assert profiling.launches["K3"] == before + 1
        pr, pi = sf.stream_plain(xr, xi, n, mode, scale=scale)
        torch.cuda.synchronize()
        assert _err(to_np(yr) + 1j * to_np(yi),
                    to_np(pr) + 1j * to_np(pi)) < 1e-5, (m, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256, 512, 1024, 2048, 4096, 48, 768])
def test_k2_routes_match_plain_on_card(m):
    """K2 forward and inverse on every route (the cluster at m = 128 ..
    1024, the forward's register kernels at 2048 and 4096, the stage
    loop), one count a call, the forward also from the strided views of
    paired rows (row stride 2n)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n = 128 * m
    b = 3
    c = complex_input((b, m, 128), np.complex64, seed=m)
    rows = torch.as_tensor(np.stack([c.real, c.imag], axis=1).reshape(
        b, 2, n).copy(), device="cuda")
    pairs = (rows[:, 0].reshape(b, m, 128), rows[:, 1].reshape(b, m, 128))
    flat = tuple(v.contiguous() for v in pairs)
    for mode, (xr, xi) in (("fwd", flat), ("fwd", pairs), ("inv", flat)):
        before = profiling.launches["K2"]
        yr, yi = sf._launch(xr, xi, n, mode)
        assert profiling.launches["K2"] == before + 1
        pr, pi = sf.stream_plain(xr, xi, n, mode)
        torch.cuda.synchronize()
        assert _err(to_np(yr) + 1j * to_np(yi),
                    to_np(pr) + 1j * to_np(pi)) < 1e-5, (m, mode)


@pytest.mark.cuda
def test_rfilter_split_along_axis_0_on_card():
    """rfilter_split along axis 0 of a (65536, 64) float32 x (its paired
    rows with element stride 64, copied for K2) runs one K2 and one K4
    launch and matches the plain versions' composition on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n = 65536
    x = torch.as_tensor(real_input((n, 64), np.float32, seed=16))
    F = complex_input((n // 2 + 1,), np.complex64, seed=17)
    F.imag[[0, -1]] = 0.0
    fr, fi = torch.as_tensor(F.real.copy()), torch.as_tensor(F.imag.copy())
    before = (profiling.launches["K2"], profiling.launches["K4"])
    got = pt.rfilter_split(x.cuda(), fr.cuda(), fi.cuda(), axis=0)
    torch.cuda.synchronize()
    assert (profiling.launches["K2"], profiling.launches["K4"]) == (
        before[0] + 1, before[1] + 1)
    want = pt.rfilter_split(x, fr, fi, axis=0)
    assert tuple(got.shape) == (n, 64)
    assert _err(to_np(got), to_np(want)) < 1e-5


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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [128, 256, 512, 1024, 48])
def test_k4_matches_plain_on_card(m):
    """K4 on the rows-first cluster at every m it takes (the stage loop at
    m = 48), s = 1 and 2, with a scale, into the strided planes of paired
    rows and into fresh planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n = 128 * m
    b = 3
    for s in (1, 2):
        c = complex_input((b, m, 128), np.complex64, seed=m + s)
        f = complex_input((s, m, 128), np.complex64, seed=m + s + 1)
        xr, xi, fr, fi = (torch.as_tensor(v.copy(), device="cuda") for v in
                          (c.real, c.imag, f.real, f.imag))
        before = profiling.launches["K4"]
        out = torch.full((b, 2, n), float("nan"), device="cuda")
        sf._launch(xr, xi, n, "filter", fr, fi, scale=0.5,
                   out=(out[:, 0], out[:, 1]))
        yr, yi = sf._launch(xr, xi, n, "filter", fr, fi)
        assert profiling.launches["K4"] == before + 2
        pr, pi = sf.stream_plain(xr, xi, n, "filter", fr, fi)
        torch.cuda.synchronize()
        want = to_np(pr) + 1j * to_np(pi)
        assert _err(to_np(yr) + 1j * to_np(yi), want) < 1e-5, (m, s)
        got = to_np(out[:, 0]) + 1j * to_np(out[:, 1])
        assert _err(got, 0.5 * want.reshape(b, n)) < 1e-5, (m, s)

