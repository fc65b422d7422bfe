"""The reduction of a run to metric values, shared by the readers in
``metrics/``.  A reader returns None where its run has nothing to read,
and the harness then leaves the metric out of the line."""
from __future__ import annotations

import math
import re
import statistics


def rows_per_s(run):
    """Every row of the window's calls over the window's time."""
    w = run.window
    return run.rows * w.calls / w.seconds if w.calls else None


def images_per_s(run):
    """Every image of the window's calls over the window's time."""
    w = run.window
    return run.cell.sizes["images"] * w.calls / w.seconds if w.calls else None


def call_p95_ms(run):
    """The 95th percentile (nearest rank) of every call's time."""
    lat = sorted(run.window.latency_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3


def setup_s(run):
    return run.setup_s


def host_us_per_call(run):
    """The median time on the host to submit a call, from the window,
    which runs without the profiler."""
    enq = run.window.enqueue_s
    return statistics.median(enq) * 1e6 if enq else None


def _named(names):
    pat = re.compile(r"\b(?:" + "|".join(map(re.escape, sorted(names)))
                     + r")\b")
    return lambda k: pat.search(k.name) is not None


def kernel_us(run, names):
    """Device time a call of the kernels with these function names."""
    if run.trace is None:
        return None
    t = run.trace.per_call_us(_named(names))
    return t if t > 0 else None


_NCCL = re.compile(r"(?:void\s+)?nccl")


def is_nccl(k) -> bool:
    """Whether the kernel is NCCL's (its function name starts ``nccl``)."""
    return _NCCL.match(k.name) is not None


def glue_us(run):
    """Device time a call of every kernel that is neither one of the
    port's hand-written ``csrc`` kernels nor NCCL's."""
    if run.trace is None:
        return None
    port = _named(run.port_kernels)
    return run.trace.per_call_us(lambda k: not port(k) and not is_nccl(k))


def nccl_us(run):
    """Device time a call of NCCL's kernels: the exchanges between ranks."""
    if run.trace is None:
        return None
    t = run.trace.per_call_us(is_nccl)
    return t if t > 0 else None


def exchange_pct(run):
    """The call's bytes sent over the links at the card's peak a direction
    over NCCL's kernel time a call, in percent; None without the peak or
    without NCCL's kernels."""
    us = nccl_us(run)
    if us is None or not run.link_bytes or not run.link_bytes_per_s:
        return None
    return 100.0 * run.link_bytes / run.link_bytes_per_s / (us * 1e-6)


def span_us(run, span):
    """Device time a call of the kernels launched inside ``span``."""
    if run.trace is None or span not in run.trace.spans:
        return None
    return run.trace.launched_in(span)


def roofline_pct(run):
    """The call's ideal bytes at the card's peak bandwidth over the call's
    summed kernel time, in percent; None on a card the table of peaks
    does not hold."""
    if run.trace is None or not run.peak_bytes_per_s:
        return None
    us = run.trace.per_call_us()
    return 100.0 * run.ideal_bytes / run.peak_bytes_per_s / (us * 1e-6)


def idle_pct(run):
    """1 - the union of device-op intervals over the traced window."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.window_us())
