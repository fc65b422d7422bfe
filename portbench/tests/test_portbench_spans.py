"""The readers of the program's spans, on a trace written by hand with
nested spans, as the port's ``utils/profiling.py`` records them."""
import json

import pytest

from portbench import harness, readers, spans, spec, trace

NEW = ("pack_device_us.c2c", "filter_device_us.conv",
       "unpack_device_us.c2c", "adjoint_device_us.greeks",
       "launch_host_us.conv", "launch_host_us.c2c")


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _trace(tmp_path, program_spans=True):
    """Two calls at 10 and 110, each: step > rfft_split > (pack, K1,
    merge, scale), filter, unpack, and an adjoint with its own K1 on
    another thread.  A K1 span before the window (a warm call) lies in no
    call."""
    ev = [_span("portbench.window", 0, 300)]
    kernels = []
    for t in (10, 110):
        ev.append(_span("portbench.call", t, 80))
        if program_spans:
            ev += [_span("cfftpack.step", t + 1, 50),
                   _span("cfftpack.rfft_split", t + 2, 30),
                   _span("cfftpack.pack", t + 3, 4),
                   _span("cfftpack.K1", t + 8, 6),
                   _span("cfftpack.merge", t + 20, 10),
                   _span("cfftpack.scale", t + 31, 1),
                   _span("cfftpack.filter", t + 40, 5),
                   _span("cfftpack.unpack", t + 50, 2),
                   dict(_span("cfftpack.adjoint", t + 60, 15), tid=2),
                   dict(_span("cfftpack.K1", t + 62, 3), tid=2)]
        # (name, launch, dur): a copy, K1, a merge multiply, the scale,
        # the filter's multiply, the interleave, the adjoint's K1
        kernels += [("void at::native::elementwise_kernel<4>()", t + 4, 7),
                    ("void k1_reg_kernel<float, 480>(float*)", t + 9, 20),
                    ("void at::native::vectorized_elementwise_kernel<4>()",
                     t + 21, 11),
                    ("void at::native::vectorized_elementwise_kernel<4>()",
                     t + 31.5, 5),
                    ("void at::native::vectorized_elementwise_kernel<4>()",
                     t + 41, 13),
                    ("void at::native::elementwise_kernel<4>()", t + 51, 19),
                    ("void k1_reg_kernel<float, 480>(float*)", t + 63, 17)]
    if program_spans:
        ev.append(_span("cfftpack.K1", 1, 2))
    for corr, (name, launch, dur) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name,
                   "ts": 200 + corr, "dur": dur,
                   "args": {"correlation": corr}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.parse(path)


def _run(tr):
    cell = spec.resolve("conv960.greeks")
    win = harness.Window(0.0, 1.0, 2, [0.1, 0.1], [1e-4] * 2, [0.5, 1.0])
    return harness.Run(cell, 5.0, win, tr, 1, 1.0,
                       frozenset({"k1_reg_kernel"}))


def _reader(name):
    cell = spec.resolve("conv960.greeks")
    return spec.load_module(cell.reader(name), "metric").read


def test_leaf_spans_split_the_glue(tmp_path):
    run = _run(_trace(tmp_path))
    assert trace.complete(run.trace)
    leaves = ("pack", "merge", "scale", "filter", "unpack")
    got = {s: readers.span_us(run, "cfftpack." + s)
           for s in leaves + ("adjoint", "K1")}
    assert got == {"pack": 7, "merge": 11, "scale": 5, "filter": 13,
                   "unpack": 19, "adjoint": 17, "K1": 37}
    # the leaf steps make up the glue; the K1 spans hold K1's kernels
    assert sum(got[s] for s in leaves) == readers.glue_us(run)
    assert got["K1"] == readers.kernel_us(run, ("k1_reg_kernel",))
    assert readers.span_us(run, "cfftpack.plan") is None


def test_kernel_host_time_counts_only_spans_inside_calls(tmp_path):
    run = _run(_trace(tmp_path))
    assert spans.kernel_host_us(run) == 6 + 3      # not the warm call's 2
    assert spans.KERNEL_SPAN.fullmatch("cfftpack.K11")
    assert not spans.KERNEL_SPAN.fullmatch("cfftpack.plan")


@pytest.mark.parametrize("name", NEW)
def test_new_metric_reads_nothing_from_a_program_without_spans(tmp_path,
                                                               name):
    """On the parent's program (no spans) and on an untraced run every new
    reader returns None: the harness leaves the metric out."""
    assert _reader(name)(_run(_trace(tmp_path, program_spans=False))) is None
    assert _reader(name)(_run(None)) is None


@pytest.mark.parametrize("name", NEW)
def test_new_metric_reads_the_spans(tmp_path, name):
    want = {"pack": 7, "merge": 11, "scale": 5, "filter": 13, "unpack": 19,
            "adjoint": 17, "launch": 9}
    got = _reader(name)(_run(_trace(tmp_path)))
    step = name.split("_")[0]
    assert got == want.get(step)
