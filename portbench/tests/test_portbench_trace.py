"""The reduction of a profiler trace, on a trace written by hand, and
the readers on it."""
import json

import pytest

from portbench import harness, readers, spec, trace


def _trace(tmp_path, drop=False):
    """Two calls of two kernels each, a 10 us gap between the calls."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.call",
           "ts": 1, "dur": 5},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.call",
           "ts": 46, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 40,
           "dur": 10}]
    kernels = [("void k1_reg_kernel<float, 480>(float*)", 2, 10, 20),
               ("void at::native::elementwise_kernel<128>()", 3, 30, 10),
               ("void k1_reg_kernel<float, 480>(float*)", 46, 50, 20),
               ("void at::native::elementwise_kernel<128>()", 47, 70, 10)]
    for corr, (name, launch, start, dur) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "args": {"correlation": corr}})
        if not (drop and corr == 3):
            ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start,
                       "dur": dur, "args": {"correlation": corr}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.parse(path)


def test_parse(tmp_path):
    tr = _trace(tmp_path)
    assert trace.complete(tr) and tr.ncalls == 2
    assert tr.per_call_us() == 30
    assert tr.busy_us() == 60 and tr.window_us() == 100
    gaps = dict((label, us) for us, label in tr.gaps())
    assert gaps["aten::mul"] == 10          # 40..50, the host in aten::mul


def test_dropped_kernel_is_incomplete(tmp_path):
    assert not trace.complete(_trace(tmp_path, drop=True))


def test_readers(tmp_path):
    tr = _trace(tmp_path)
    cell = spec.resolve("conv960.book")
    win = harness.Window(0.0, 2.0, 4, [0.1, 0.2, 0.3, 0.4], [1e-4] * 4,
                         [0.5, 0.9, 1.3, 1.9])
    run = harness.Run(cell, 5.0, win, tr, 3350, 3.35e12,
                      frozenset({"k1_reg_kernel"}))
    assert readers.rows_per_s(run) == cell.traffic["rows"] * 2
    assert win.tenths() == pytest.approx([0, 0, 5, 0, 5, 0, 5, 0, 0, 5])
    assert win.longest_gap() == pytest.approx([600.0, 3])
    assert readers.call_p95_ms(run) == pytest.approx(400.0)
    assert readers.kernel_us(run, ("k1_reg_kernel",)) == 20
    assert readers.glue_us(run) == 10
    assert readers.roofline_pct(run) == pytest.approx(100 * 1e-9 / 30e-6)
    assert readers.idle_pct(run) == pytest.approx(40.0)
    untraced = harness.Run(cell, 5.0, win, None, 1, 1.0, frozenset())
    assert readers.kernel_us(untraced, ("k1_reg_kernel",)) is None
    assert readers.roofline_pct(untraced) is None
