"""Port's host plan against the JAX package's: the tables are equal,
and a device plan built from the JAX package's own tables gives
bitwise the output of the port's own."""
import importlib

import numpy as np
import pytest
import torch

from cfftpack_tpu import plan as jplan
from cfftpack_tpu.ops import core as jcore
from cfftpack_tpu.ops.pallas_fft import _flat_twiddles as j_flat_twiddles

from cfftpack_tpu_torch import plan
from cfftpack_tpu_torch.ops import core
from cfftpack_tpu_torch.ops.rfft import rfilter_split

from torch_parity import complex_input, real_input

# the ops packages export functions named like their modules
jrfft = importlib.import_module("cfftpack_tpu.ops.rfft")

torch.set_num_threads(1)

TABLE_SIZES = [4, 8, 60, 64, 101, 243, 899, 960, 1009, 1024, 1798, 4096]


def test_factor_matches_reference():
    for n in range(1, 4097):
        assert plan.factor(n) == tuple(jplan.factor(n)), n


def test_fast_sizes_match_reference():
    for n in range(1, 600):
        assert plan.fft_next_fast_size(n) == jplan.fft_next_fast_size(n)
        assert (plan.fft_next_fast_even_size(n)
                == jplan.fft_next_fast_even_size(n))
        assert (plan.fft_next_fast_size_2nm1(n)
                == jplan.fft_next_fast_size_2nm1(n))
        assert (plan.fft_next_fast_size_2np1(n)
                == jplan.fft_next_fast_size_2np1(n))
        assert plan.needs_bluestein(n) == jplan.needs_bluestein(n)
    for x in (1, 1000, 20000, 128 * 4096, 128 * 4096 + 1):
        assert plan.next_stream_size(x) == jplan.next_stream_size(x)


@pytest.mark.parametrize("n", TABLE_SIZES)
def test_twiddles_equal_reference(n):
    mine, ref = plan.stage_twiddles(n), jplan.stage_twiddles(n)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert np.array_equal(a, b)
    offs, re, im = plan._flat_twiddles(mine)
    joffs, jre, jim = j_flat_twiddles(n)
    assert offs == tuple(joffs)
    assert np.array_equal(re, jre) and np.array_equal(im, jim)


def _reference_tables(n: int) -> dict:
    """The JAX package's own numpy tables, in host_tables' layout."""
    facs = tuple(jplan.factor(n))
    even = n > 1 and n % 2 == 0
    return {
        "factors": facs,
        "twiddles": jplan.stage_twiddles(n),
        "dense": {p: jplan.dft_matrix(p) for p in set(facs)
                  if 5 < p <= jplan.MAX_DIRECT_RADIX},
        "bluestein": (jplan.bluestein_tables(n)
                      if jplan.needs_bluestein(n) else None),
        "rfft_merge": jcore._rfft_merge_tables(n) if even else None,
        "irfft_merge": jcore._irfft_merge_tables(n) if even else None,
        "rfilter": jrfft._rfilter_tables(n) if even else None,
    }


def _tables_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _tables_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(
            _tables_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n", TABLE_SIZES)
def test_host_tables_equal_reference(n):
    assert _tables_equal(plan.host_tables(n), _reference_tables(n))


def _lengths(n: int) -> set:
    """Every length whose tables a real filter / complex FFT of n reads."""
    out = {n, n // 2}
    for k in (n, n // 2):
        if plan.needs_bluestein(k):
            out.add(plan.bluestein_tables(k)[0])
    return out


@pytest.mark.parametrize("n", [101, 960, 1798])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reference_tables_give_bitwise_output(n, dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    x = torch.as_tensor(real_input((4, n), dtype, seed=n))
    z = complex_input((4, n), np.complex128, seed=n + 1)
    zr = torch.as_tensor(z.real.astype(dtype))
    zi = torch.as_tensor(z.imag.astype(dtype))
    f = real_input((2, n // 2 + 1), dtype, seed=n + 2)
    fr, fi = torch.as_tensor(f[0]), torch.as_tensor(f[1])
    fi[0] = 0.0
    fi[-1] = 0.0

    def run():
        return (*core.sfft(zr, zi, n, False), *core.srfft(x, n),
                rfilter_split(x, fr, fi))

    plan.clear_device_tables()
    try:
        mine = run()
        for k in _lengths(n):
            plan.device_tables(k, tdt, "cpu", source=_reference_tables(k))
        theirs = run()
    finally:
        plan.clear_device_tables()
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)


def test_device_tables_are_cached():
    plan.clear_device_tables()
    a = plan.device_tables(960, torch.float32, "cpu")
    assert plan.device_tables(960, torch.float32, "cpu") is a
    assert plan.device_tables(960, torch.float64, "cpu") is not a
    assert a.twr.dtype == torch.float32 and a.rfilter[0].shape == (480,)
