"""The ideal-byte functions of counts/ against counts by hand."""
from portbench import spec


def _count(config, traffic):
    cell = next(spec.resolve(n) for n in spec.every_cell()
                if spec.resolve(n).config == config)
    mod = spec.load_module(cell.counts, "counts")
    return mod.ideal_bytes(cell.sizes, traffic)


def test_conv960_forward():
    # 4 rows of 960 float32 in and out, the 481-bin filter's two planes in
    assert _count("conv960", {"call": "forward", "rows": 4}) == \
        4 * 960 * 4 + 4 * 960 * 4 + 2 * 481 * 4


def test_conv960_grad():
    # v, cotangent in; out, grad v out; the filter in, its gradient out
    assert _count("conv960", {"call": "grad", "rows": 3}) == \
        4 * 3 * 960 * 4 + 2 * (2 * 481 * 4)


def test_c2c1024():
    # 2 rows of 1024 complex128: input, spectrum, reconstruction
    assert _count("c2c1024", {"rows": 2}) == \
        3 * 2 * 1024 * 16
