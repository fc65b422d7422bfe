"""Run one cell once: set-up, the measured window, the traced stretch and
the check against the plain reference.

The generator is general: a traffic file gives the rows a call, the ring
of input blocks the calls go round, how many calls may be in flight
(1 is a closed loop, each call waited for before the next is sent), the
kind of call, and how many calls the traced stretch holds.  Each call's
time runs from its submission on the host until the host observes its
completion event; a rate is every row of the window's calls over the
window's time, from the first submission to the last completion.  Over
several ranks (a ``team``) each rank runs this with the others, agreeing
as ``run.py``'s docstring says.
"""
from __future__ import annotations

import collections
import contextlib
import math
import os
import random
import statistics
import tempfile
import time
from dataclasses import dataclass

import torch

from . import program as prog, spec, trace as tracing
from .ranks import Team

SAMPLED_FROM = 32              # the sampled call is one of the window's first
TRACE_TRIES = 4                # traced stretches tried before giving up
_PEAKS = spec.load_json(spec.REPO / "portbench" / "peaks.json")


def clock() -> float:
    return time.perf_counter()


@dataclass
class Window:
    start: float
    end: float
    calls: int
    latency_s: list
    enqueue_s: list
    done_s: list               # each call's completion, on the clock
    failed: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def tenths(self) -> list:
        """Calls completed in each tenth of the window, a second: shows
        whether the window's start runs slower than its end."""
        if not self.done_s or self.seconds <= 0:
            return []
        tenth = self.seconds / 10
        n = [0] * 10
        for t in self.done_s:
            n[min(int((t - self.start) / tenth), 9)] += 1
        return [c / tenth for c in n]

    def longest_gap(self) -> list:
        """[ms, index]: the longest wait between two completions in the
        window, and the index in the window of the call that ended it."""
        if not self.done_s:
            return []
        ends = [self.start] + self.done_s
        gap, i = max((b - a, i) for i, (a, b) in
                     enumerate(zip(ends, self.done_s)))
        return [gap * 1e3, i]


@dataclass
class Run:
    """What the readers in ``metrics/`` read."""
    cell: spec.Cell
    setup_s: float
    window: Window
    trace: tracing.Trace | None
    ideal_bytes: int
    peak_bytes_per_s: float | None
    port_kernels: frozenset
    link_bytes: int | None = None          # sent over the links a call
    link_bytes_per_s: float | None = None  # the card's peak, a direction

    @property
    def rows(self) -> int:
        return self.cell.traffic["rows"]


class Loop:
    """Calls round the ring with at most ``depth`` in flight on the
    current stream, keeping the outputs of the last call on each slot
    and of one sampled call for the check."""

    def __init__(self, call, inputs, ring: int, depth: int, device,
                 sample: int, strict: bool = False):
        self.call, self.inputs = call, inputs
        self.strict = strict             # a failed call raises
        self.ring, self.depth = ring, depth
        self.sample = sample
        self.index = 0                   # calls made so far
        self.first = None                # index of the window's first call
        self.last = {}                   # slot -> (index, outputs)
        self.sampled = None              # (index, slot, outputs)
        self._events = ([torch.cuda.Event() for _ in range(depth)]
                        if device.type == "cuda" else None)

    def kept(self) -> dict:
        """{index: (slot, outputs)} of the window's calls that were kept."""
        out = {i: (s, o) for s, (i, o) in self.last.items()
               if i >= self.first}
        if self.sampled is not None:
            i, s, o = self.sampled
            out[i] = (s, o)
        return out

    def run(self, seconds=None, count=None, spans=False) -> Window:
        inflight = collections.deque()
        lat, enq, done = [], [], []
        failed = 0
        start = clock()

        def finish():
            ts, ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()
            done.append(clock())
            lat.append(done[-1] - ts)

        n = 0
        while not ((count is not None and n >= count) or
                   (seconds is not None and clock() - start >= seconds)):
            slot = self.index % self.ring
            span = (torch.profiler.record_function("portbench.call")
                    if spans else contextlib.nullcontext())
            ts = clock()
            try:
                with span:
                    outs = self.call(self.inputs, slot)
            except RuntimeError:
                if self.strict:
                    raise
                failed += 1
                break
            enq.append(clock() - ts)
            ev = None
            if self._events is not None:
                ev = self._events[self.index % self.depth]
                ev.record()
            inflight.append((ts, ev))
            self.last[slot] = (self.index, outs)
            if self.first is not None and self.index == self.first + \
                    self.sample:
                self.sampled = (self.index, slot, outs)
            del outs
            while len(inflight) >= self.depth:
                finish()
            self.index += 1
            n += 1
        while inflight:
            finish()
        return Window(start, clock(), n, lat, enq, done, failed)


def _traced(loop: Loop, calls: int, device, team: Team) -> tracing.Trace:
    """One profiled stretch of ``calls`` calls after two unrecorded ones,
    parsed; taken again where the trace lost kernels (on any rank of the
    ``team``: every rank takes it again)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loop.run(count=2)
            with record_function("portbench.window"):
                loop.run(count=calls, spans=True)
                torch.cuda.synchronize(device)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = tracing.parse(path)
        finally:
            os.unlink(path)
        if all(team.gather(tracing.complete(tr))):
            return tr
        time.sleep(0.5)
    raise RuntimeError(f"no complete trace in {TRACE_TRIES} tries")


def _agreed_window(loop: Loop, seconds: float, warm: Window,
                   team) -> Window:
    """The window of a run over several ranks: every rank makes as many
    calls as fit into ``seconds`` at rank 0's warm seconds a call, and no
    other collective meanwhile.  A call's time is the largest of its
    times on the ranks, the window's the largest of the ranks' windows."""
    calls = team.bcast(max(1, math.ceil(seconds * warm.calls / warm.seconds)))
    team.barrier()
    team.note("window")
    win = loop.run(count=calls)
    every = team.gather((win.seconds, win.latency_s))
    lat = [max(c) for c in zip(*(w for _, w in every))]
    return Window(win.start, win.start + max(t for t, _ in every),
                  win.calls, lat, win.enqueue_s, win.done_s)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_allocs(device) -> int:
    """Memory the caching allocator has asked the driver for so far."""
    return (torch.cuda.memory_stats(device).get("num_device_alloc", 0)
            if device.type == "cuda" else 0)


def _memory_peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _breakdown(tr: tracing.Trace) -> dict:
    per = collections.Counter()
    for k in tr.kernels:
        per[k.name[:160]] += k.dur * 1e-6 / tr.ncalls
    gaps = sorted(tr.gaps(), reverse=True)[:10]
    return {"device_ops": [[k, s] for k, s in per.most_common(10)],
            "idle_gaps": [[label, us * 1e-6] for us, label in gaps]}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, program=None,
             team: Team | None = None) -> dict | None:
    """One run of ``cell``: the result line as a dict, the checks last.
    ``program`` replaces the call the configuration makes (the control,
    or a fault in a test); ``t0`` is when the process started (the
    launcher, over several ranks).  Over several ranks (a ``team`` of
    more than one) this is one rank's part of the run: rank 0 returns
    the result, the others None."""
    team = team or Team()
    over = team.size > 1
    parts = {"imports": clock() - t0}
    builder = spec.load_module(cell.builder, "config")
    sizes, traffic = cell.sizes, cell.traffic
    build_s = None
    if device.type == "cuda":
        t = clock()
        torch.cuda.set_device(device)
        torch.cuda.init()
        parts["card"] = clock() - t
        t = clock()
        build_s = team.first(prog.load_library)
        parts["library"] = clock() - t
        torch.cuda.reset_peak_memory_stats(device)
    t = clock()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    inputs = builder.make_inputs(sizes, traffic, gen, device)
    _sync(device)
    parts["inputs"] = clock() - t
    call = program or builder.program(sizes, traffic)
    ring, depth = traffic["ring"], traffic["inflight"]
    # over several ranks a failed call ends its rank: the others would
    # wait for it in the next collective
    loop = Loop(call, inputs, ring, depth, device,
                random.Random(seed).randrange(SAMPLED_FROM),
                strict=over)
    first = loop.run(count=1)                      # plans and tables
    # Every shape, warm, with one call's outputs held past the ring as
    # the window holds its sampled call's: else the allocator asks the
    # driver for that memory inside the window, a stall of up to 130 ms.
    sample = loop.sample
    loop.first, loop.sample = loop.index, 0
    warm = loop.run(count=2 * ring)
    loop.sampled, loop.sample = None, sample
    parts["first_call"] = first.seconds
    setup_s = clock() - t0
    parts["warm"] = setup_s - sum(parts.values())
    loop.first = loop.index
    allocs = _device_allocs(device)
    win = (_agreed_window(loop, seconds, warm, team) if over
           else loop.run(seconds=seconds))
    allocs = _device_allocs(device) - allocs
    if trace:
        team.note("trace")
    tr = (_traced(loop, traffic["profile_calls"], device, team) if trace
          else None)
    peak = _memory_peak(device)
    busy = (tr.busy_us() * 1e-6, tr.window_us() * 1e-6) if tr else None
    every = team.gather((setup_s, peak, busy, win.calls))
    setup_s = max(e[0] for e in every)
    peak = max(e[1] for e in every)
    if busy is not None:             # averaged over the ranks
        busy = tuple(sum(e[2][i] for e in every) / team.size
                     for i in (0, 1))
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    counts = spec.load_module(cell.counts, "counts")
    link = getattr(counts, "link_bytes", None)
    peaks = _PEAKS.get(kind, {})
    run = Run(cell, setup_s, win, tr, counts.ideal_bytes(sizes, traffic),
              peaks.get("hbm_bytes_per_s"), prog.kernel_names(),
              link(sizes, traffic) if link else None,
              peaks.get("nvlink_bytes_per_s_per_direction"))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module(cell.reader(m["name"]), "metric").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    kept = loop.kept()
    del loop, call
    team.note("check")
    t = clock()
    ref = spec.load_module(cell.reference, "reference")
    errs = ref.compare(sizes, traffic, inputs, kept) if kept else {}
    _sync(device)
    check_s = clock() - t
    ranks = team.gather((errs, bool(kept)))  # each the largest over ranks
    errs = {k: max(e.get(k, math.inf) for e, _ in ranks)
            for k in cell.limits}
    kept_all = all(k for _, k in ranks)
    if team.rank:
        return None
    checks = {k: {"value": errs.get(k, float("inf")), "limit": v["limit"]}
              for k, v in cell.limits.items()}
    correct = (win.failed == 0 and kept_all and
               all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": team.size,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win.calls,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = busy
        result["breakdown"] = _breakdown(tr)
    result["info"] = {"seed": seed, "setup_s": setup_s, "setup_parts": parts,
                      "build_s": build_s, "check_s": check_s,
                      "window_s": win.seconds, "compared": sorted(kept),
                      "calls_per_s_by_tenth": win.tenths(),
                      "longest_gap_ms_at_call": win.longest_gap(),
                      "device_allocs_in_window": allocs,
                      "enqueue_us_median":
                          statistics.median(win.enqueue_s) * 1e6
                          if win.enqueue_s else None}
    if over:
        result["info"].update(ranks=team.size,
                              calls_by_rank=[e[3] for e in every])
    result["checks"] = checks
    return result
