"""The benchmark's reading of a device trace.

``traced(fn)`` runs ``fn()`` once under ``torch.profiler`` (host and CUDA
activity), from a primed and synchronised start to a synchronised end, and
returns a ``Trace``: every device operation launched inside the
``pb.window`` span, with its device interval and the host time of its
launch, and the host intervals of every ``pb.*`` span (``record_function``
ranges that the benchmark's own files place around calls into the
program's layers). From these:

- ``busy_s``: the union of the device intervals, in seconds; ``window_s``:
  the traced window's host length;
- ``in_span(name)``: the device operations launched while a span of that
  name was open on the host (a kernel belongs to the layer that launched
  it, whenever it ran);
- ``breakdown()``: the ten device operations that took most time, by name,
  and the idle gaps of the device summed by the innermost ``pb.*`` span
  open on the host when each gap began.

The profiler drops a session's first records (usually a few, at times
hundreds), so every session starts with 256 one-cycle spin kernels, waited
for, and counts none of them; a session that kept none of them is traced
again, up to three times.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

PRIMING_KERNELS = 256
PRIMING_NAME = "spin_kernel"  # torch.cuda._sleep's kernel
SESSIONS = 3
WINDOW = "pb.window"
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset", "cudaGraphLaunch")


@dataclass
class DeviceOp:
    name: str
    start: int  # ns, device
    end: int
    launch: int  # ns, host; the device start where no launch was recorded


@dataclass
class Trace:
    ops: list
    spans: dict  # name -> sorted [(start_ns, end_ns)]
    window: tuple  # (start_ns, end_ns)
    calls: dict = field(default_factory=dict)  # span name -> number of intervals

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self):
        """The union of the device intervals, as sorted disjoint (start, end)."""
        merged = []
        for op in sorted(self.ops, key=lambda o: o.start):
            s, e = max(op.start, self.window[0]), min(op.end, self.window[1])
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def in_span(self, name: str) -> list:
        """The device operations launched while a ``name`` span was open."""
        ivs = self.spans.get(name, [])
        starts = [s for s, _ in ivs]
        out = []
        for op in self.ops:
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= ivs[i][1]:
                out.append(op)
        return out

    def open_span(self, t: int) -> str:
        """The innermost ``pb.*`` span open on the host at ``t`` (the latest
        started of those that contain it)."""
        best, best_start = WINDOW, self.window[0]
        for name, ivs in self.spans.items():
            starts = [s for s, _ in ivs]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivs[i][1] and ivs[i][0] >= best_start:
                best, best_start = name, ivs[i][0]
        return best

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for op in self.ops:
            by_name[op.name[:120]] += (op.end - op.start) * 1e-9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = defaultdict(float)
        t = self.window[0]
        for s, e in self.busy_intervals() + [[self.window[1], self.window[1]]]:
            if s > t:
                gaps[self.open_span(t)] += (s - t) * 1e-9
            t = max(t, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def prime() -> None:
    for _ in range(PRIMING_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _read(events):
    """(Trace, whether a priming kernel survived) from the profiler's events."""
    from torch.autograd import DeviceType

    spans = defaultdict(list)
    launches = {}
    device = []
    primed = False
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if PRIMING_NAME in name:
                primed = True
            elif not name.startswith("pb."):  # the spans' device-side shadows
                device.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.correlation_id()))
        elif name.startswith("pb."):
            spans[name].append((e.start_ns(), e.end_ns()))
        elif any(w in name for w in LAUNCH_WORDS) and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    for ivs in spans.values():
        ivs.sort()
    if not spans.get(WINDOW):
        raise RuntimeError("the traced session recorded no pb.window span")
    window = spans[WINDOW][0]
    ops = []
    for name, s, e, corr in device:
        launch = launches.get(corr, s)
        if window[0] <= launch <= window[1]:
            ops.append(DeviceOp(name, s, e, launch))
    trace = Trace(ops=ops, spans=dict(spans), window=window,
                  calls={k: len(v) for k, v in spans.items()})
    return trace, primed


def traced(fn):
    """(fn's result, Trace) of one ``fn()`` call under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prime()
            with record_function(WINDOW):
                out = fn()
                torch.cuda.synchronize()
        trace, primed = _read(prof.profiler.kineto_results.events())
        if primed:
            break
    else:
        raise RuntimeError(f"no priming kernel left in {SESSIONS} profiler sessions")
    if not trace.ops:
        raise RuntimeError("the profiler recorded no device operation in the traced window")
    return out, trace


def spanned(name: str, fn):
    """``fn`` with every call inside a ``record_function(name)`` range."""
    from torch.profiler import record_function

    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapper
