"""The arithmetic of the dense complex product under K10 and K11
(``csrc/cgemm.cuh``), emulated on the CPU, and the wrappers' pure-Python
choices around it.

The kernels cut every float32 operand into two TF32 halves (10 explicit
mantissa bits) and sum ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` in float32
(3xTF32).  Here the halves are made with integer arithmetic on the
float32 bit pattern and the products are float32 matmuls of them: a
product of two TF32 values is exact in float32.  What is not emulated is
the tensor cores' own accumulation (its order, and its truncating adder,
which the kernels sidestep by adding each 8-step's sum on the CUDA
cores); the check of the kernels on the card against their plain
versions and ``torch.fft`` in complex128 holds that.
"""
import numpy as np
import pytest
import torch

from cfftpack_tpu_torch.ops import fourstep_fft, stream_fft

torch.set_num_threads(1)


def tf32_round(a):
    """float32 -> nearest TF32 value, ties away from zero
    (``cvt.rna.tf32.f32``): add half of the 13 dropped bits' unit to the
    magnitude and clear them."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_trunc(a):
    """float32 -> TF32 by clearing the 13 dropped bits, as the kernels cut
    the lo half."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    """The kernels' split (``cg_split``): hi rounded, lo the rest cut to
    TF32."""
    hi = tf32_round(a)
    return hi, tf32_trunc(a - hi)


@pytest.mark.parametrize("x, want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10),      # representable: unchanged
    (1.0 + 2.0 ** -12, 1.0),                   # below half: down
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),      # tie: away from zero
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),  # above half: up
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (2.0 - 2.0 ** -12, 2.0),                   # the carry reaches the exponent
    (0.0, 0.0),
    (3.0e-30, None),                           # small normal: 11 bits kept
])
def test_tf32_round_on_known_patterns(x, want):
    got = tf32_round(np.array([x], np.float32))[0]
    assert got.view(np.uint32) & np.uint32(0x1FFF) == 0
    if want is None:
        assert abs(float(got) - x) <= abs(x) * 2.0 ** -11
    else:
        assert float(got) == want


def test_split_halves_are_tf32_and_sum_to_the_operand():
    a = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi, lo = split(a)
    for h in (hi, lo):
        assert not (h.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.all(np.abs(a - hi) <= np.abs(a) * 2.0 ** -11)
    err = np.abs(a.astype(np.float64) - hi - lo)
    assert np.all(err <= np.abs(a) * 2.0 ** -21)
    # the wrapper's table split rounds lo as well
    whi, wlo = fourstep_fft._tf32_split(a)
    assert np.array_equal(whi, hi)
    assert np.array_equal(wlo, tf32_round(a - hi))
    assert np.all(np.abs(a.astype(np.float64) - whi - wlo)
                  <= np.abs(a) * 2.0 ** -22)


def _dft_operands(K, N=96, seed=0):
    k = np.arange(K)
    D = np.exp(-2j * np.pi * np.outer(k, k) / K)
    rng = np.random.default_rng(seed + K)
    x = rng.standard_normal((K, N)) + 1j * rng.standard_normal((K, N))
    f32 = np.float32
    return (D.real.astype(f32), D.imag.astype(f32),
            x.real.astype(f32), x.imag.astype(f32))


def _mm(a, b):
    return torch.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _product_3xtf32(ar, ai, br, bi):
    """Four real products, each the two small terms then the large one."""
    def real(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        return (_mm(al, bh) + _mm(ah, bl)) + _mm(ah, bh)
    return real(ar, br) - real(ai, bi), real(ar, bi) + real(ai, br)


def _product_tf32(ar, ai, br, bi):
    ar, ai, br, bi = (tf32_round(v) for v in (ar, ai, br, bi))
    return _mm(ar, br) - _mm(ai, bi), _mm(ar, bi) + _mm(ai, br)


def _err(got, ar, ai, br, bi):
    want = ((ar.astype(np.float64) + 1j * ai) @ (br.astype(np.float64)
                                                 + 1j * bi))
    return np.abs(got[0] + 1j * got[1] - want).max() / np.abs(want).max()


@pytest.mark.parametrize("K", [64, 128, 256])
def test_3xtf32_dft_product_is_float32_accurate(K):
    ops = _dft_operands(K)
    e3 = _err(_product_3xtf32(*ops), *ops)
    e32 = _err((_mm(ops[0], ops[2]) - _mm(ops[1], ops[3]),
                _mm(ops[0], ops[3]) + _mm(ops[1], ops[2])), *ops)
    assert e3 <= 2e-6
    assert e3 <= 4 * e32          # as good as a float32 matmul


def test_one_tf32_product_misses_the_bar():
    """Why three terms: a single TF32 product of the 256-point DFT is off
    by more than the kernels' 1e-5 bar."""
    ops = _dft_operands(256)
    assert _err(_product_tf32(*ops), *ops) > 1e-5


def test_split_dft_table_of_k10_sums_to_its_matrix():
    for inverse in (False, True):
        d4 = fourstep_fft._device_split_dft(inverse, "cpu").numpy()
        Dr, Di = fourstep_fft._tables(1024, inverse)[:2]
        assert d4.shape == (4, 64, 64) and d4.dtype == np.float32
        assert not (d4.view(np.uint32) & np.uint32(0x1FFF)).any()
        for hi, lo, want in ((d4[0], d4[2], Dr), (d4[1], d4[3], Di)):
            assert np.abs(hi.astype(np.float64) + lo - want).max() <= 2.0 ** -22


@pytest.mark.parametrize("m, one_pass", [(2, True), (16, True), (64, True),
                                         (65, False), (128, False),
                                         (256, False)])
def test_k11_one_pass_rule(m, one_pass):
    """One kernel and no scratch up to the cap; two passes past it."""
    cap = stream_fft._MM2_ONE_PASS_MAX_M
    assert cap == 64
    assert stream_fft._mm2_one_pass(m) is one_pass
    assert stream_fft._mm2_one_pass(cap) and not stream_fft._mm2_one_pass(
        cap + 1)
    assert stream_fft.mm2_eligible(128 * m, torch.float32)


@pytest.mark.parametrize("n2, b, want", [
    (16, 1, (8, 1)), (16, 5, (8, 1)), (16, 9, (8, 2)), (16, 4096, (8, 512)),
    (64, 1, (2, 1)), (64, 5, (2, 3)), (64, 1024, (2, 512)),
    (256, 3, (1, 6)), (1024, 64, (1, 512)), (4096, 16, (1, 512)),
])
def test_k10_column_groups(n2, b, want):
    """Stage A's 128-column tiles: below n2 = 128 a tile spans several
    transforms (the last group ragged), from there on a transform spans
    n2 / 128 tiles; every column of the batch is in exactly one tile."""
    group, tiles = fourstep_fft._column_groups(n2, b)
    assert (group, tiles) == want
    assert fourstep_fft.fourstep_eligible(64 * n2, torch.float32)
    if group > 1:
        assert group * n2 == 128 and (tiles - 1) * group < b <= tiles * group
    else:
        assert tiles * 128 == b * n2
