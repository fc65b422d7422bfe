"""The reduction of one profiler trace to what the readers need.

The traced stretch is a run of calls under ``torch.profiler``, each call
inside a ``portbench.call`` span and the whole inside a
``portbench.window`` span, exported as a Chrome trace.  A kernel belongs
to the call whose span holds its launch on the host (the backward's
launches come from autograd's device thread while the caller waits in
``autograd.grad``, inside the span).  Times in the trace are in
microseconds on one clock for host and device.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Kernel:
    name: str
    start: float
    dur: float
    call: int                  # index of the call that launched it
    launch: float              # host time of its launch


@dataclass
class Trace:
    window: tuple              # (start, end) of portbench.window
    calls: list                # (start, end) of each portbench.call
    kernels: list              # Kernel, launched inside a call
    device_ops: list           # (start, end) of every device op
    host: list                 # (name, start, end) of host events
    spans: dict = field(default_factory=dict)   # name -> [(start, end)]
    lost: int = 0              # launches in a call with no kernel traced

    @property
    def ncalls(self) -> int:
        return len(self.calls)

    def per_call_us(self, pick=lambda k: True) -> float:
        return sum(k.dur for k in self.kernels if pick(k)) / self.ncalls

    def launched_in(self, span: str, pick=lambda k: True) -> float:
        """Kernel time a call of kernels launched inside ``span``."""
        ranges = self.spans.get(span, [])
        return sum(k.dur for k in self.kernels if pick(k) and any(
            a <= k.launch <= b for a, b in ranges)) / self.ncalls

    def busy(self) -> list:
        """The union of device-op intervals inside the window."""
        w0, w1 = self.window
        out = []
        for a, b in sorted(self.device_ops):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def gaps(self) -> list:
        """(length, label) of each idle stretch of the device inside the
        window, labelled by the innermost host event at its middle."""
        w0, w1 = self.window
        edges = [w0] + [t for iv in self.busy() for t in iv] + [w1]
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid = (a + b) / 2
                inside = [(e - s, name) for name, s, e in self.host
                          if s <= mid <= e and name != "portbench.window"]
                out.append((b - a, min(inside)[1] if inside
                            else "host outside any traced op"))
        return out


def parse(path, window_span: str = "portbench.window",
          call_span: str = "portbench.call") -> Trace:
    events = json.loads(open(path).read())["traceEvents"]
    launch_at, kernels, ops, host, spans = {}, [], [], [], {}
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X":
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat in _HOST:
            host.append((e["name"], start, end))
            if cat == "user_annotation":
                spans.setdefault(e["name"], []).append((start, end))
            corr = e.get("args", {}).get("correlation")
            if corr is not None and "LaunchKernel" in e["name"]:
                launch_at[corr] = start
        if cat in _DEVICE_OPS:
            ops.append((start, end))
        if cat == "kernel":
            kernels.append((e["name"], start, end - start,
                            e.get("args", {}).get("correlation")))
    if len(spans.get(window_span, [])) != 1:
        raise ValueError(f"trace has no single {window_span} span")
    w0, w1 = spans[window_span][0]
    calls = sorted(c for c in spans.get(call_span, [])
                   if w0 <= c[0] and c[1] <= w1)

    def call_of(t):
        return next((i for i, (a, b) in enumerate(calls) if a <= t <= b),
                    None)

    out, traced = [], set()
    for name, start, dur, corr in kernels:
        t = launch_at.get(corr)
        idx = call_of(t) if t is not None else None
        if idx is not None:
            out.append(Kernel(name, start, dur, idx, t))
            traced.add(corr)
    lost = sum(1 for c, t in launch_at.items()
               if c not in traced and call_of(t) is not None)
    return Trace(spans[window_span][0], calls, out, ops, host, spans, lost)


def complete(tr: Trace) -> bool:
    """Whether the trace holds every call's kernels: each call launched
    the same number of kernels, at least one, and no launch inside a
    call lacks its kernel (the profiler on the card has been seen to drop
    parts of a trace)."""
    if not tr.calls:
        return False
    counts = [0] * tr.ncalls
    for k in tr.kernels:
        counts[k.call] += 1
    return tr.lost == 0 and min(counts) > 0 and len(set(counts)) == 1
