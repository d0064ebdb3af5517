"""Profiling and timing utilities.

The port of ``fugue_tpu/utils/profiling.py``: a ``torch.profiler`` context
that writes a device trace (Chrome/Perfetto JSON), and a timing helper that
reports the first call apart from the steady state. Beyond the JAX
package, the program's own spans and counts:

- ``span(name, **attrs)`` around a layer's work (``potential``,
  ``hmc.transition``, ``nuts.iteration``, ``chees.transition``, the
  service's ``serve.*``), ``count(name, n, **attrs)``, and
  ``host_read(site)`` at each deliberate device-to-host read;
- recorded while a ``torch.profiler`` session runs anywhere in the process
  (the profiler's process-wide flag, so threads started inside the session
  record too), in one bounded in-memory buffer; off, a span or a count
  costs one attribute read;
- on ``time.time_ns()``, the clock of the profiler's host events, so a
  kernel's launch falls inside the program span that made it;
- read back with ``records(t0_ns, t1_ns)``; ``device_trace`` writes them
  into its Chrome trace beside the kernels.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler


# ---------------------------------------------------------------------------
# Program spans and counts
# ---------------------------------------------------------------------------

# The buffer's bound: a traced benchmark call of eight-schools HMC records
# about 70 spans and counts, three seconds of service about 15 per request
# (330 in all); overflow drops the oldest records.
RECORDS = 1 << 18


class Span(NamedTuple):
    name: str
    start: int  # ns, time.time_ns()
    end: int
    id: int
    parent: Optional[int]  # the span open on this thread when it started
    request: Optional[int]  # its own or its parent's request id
    thread: int  # threading.get_native_id(): the profiler's thread id
    attrs: dict


class Count(NamedTuple):
    name: str
    time: int  # ns, time.time_ns()
    n: int
    thread: int
    attrs: dict


class _Off:
    """The span of a recorder that is off: one shared object, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("recorder", "name", "request", "attrs", "id", "parent", "thread", "start")

    def __init__(self, recorder, name, request, attrs):
        self.recorder, self.name, self.request, self.attrs = recorder, name, request, attrs

    def __enter__(self):
        stack, self.thread = self.recorder._thread()
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        if self.request is None and top is not None:
            self.request = top.request
        self.id = next(self.recorder._ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.recorder._thread()[0].remove(self)
        self.recorder._append(Span(self.name, self.start, end, self.id, self.parent,
                                   self.request, self.thread, self.attrs))
        return False


class Recorder:
    """Spans and counts of every thread, kept while a profiler session runs
    (``torch.autograd.profiler._is_profiler_enabled``, set for the whole
    process by ``torch.profiler.profile``; the per-thread
    ``_profiler_enabled()`` reads False in a thread started inside the
    session). The buffer holds the newest ``capacity`` records; ``dropped``
    counts the ones that overflow pushed out."""

    def __init__(self, capacity: int = RECORDS):
        self._buf = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self.dropped = 0

    def _thread(self):
        """(this thread's stack of open spans, its native id), the id read
        once per thread."""
        local = self._local
        try:
            return local.stack, local.tid
        except AttributeError:
            local.stack, local.tid = [], threading.get_native_id()
            return local.stack, local.tid

    def _append(self, record) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(record)

    def span(self, name: str, request: Optional[int] = None, **attrs):
        """A context manager recording ``name`` from entry to exit, with the
        span open on this thread as its parent. ``request`` sets the
        request id of this span and the spans inside it; None inherits the
        parent's."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Open(self, name, request, attrs)

    def count(self, name: str, n: int = 1, **attrs) -> None:
        if not _profiler._is_profiler_enabled:
            return
        self._append(Count(name, time.time_ns(), n, self._thread()[1], attrs))

    def host_read(self, site: str, n: int = 1) -> None:
        """``n`` deliberate device-to-host reads in one statement at
        ``site``: ``count("host_read", n, site=site)``."""
        if _profiler._is_profiler_enabled:
            self.count("host_read", n, site=site)

    def request_id(self) -> Optional[int]:
        """The request id of the innermost span open on this thread, if any."""
        stack = self._thread()[0]
        return stack[-1].request if stack else None

    def new_request_id(self) -> int:
        return next(self._requests)

    def records(self, t0_ns: int, t1_ns: int) -> list:
        """The spans that started and the counts made in [t0_ns, t1_ns], in
        the order they were recorded (a span when it ended)."""
        with self._lock:
            buf = list(self._buf)
        return [r for r in buf
                if t0_ns <= (r.start if isinstance(r, Span) else r.time) <= t1_ns]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
host_read = RECORDER.host_read
request_id = RECORDER.request_id
new_request_id = RECORDER.new_request_id
records = RECORDER.records
clear = RECORDER.clear


# torch.profiler (PyTorch 2.11 on an H100) drops the first kernel records
# of a session: usually 4 or 5, now and then a few hundred or all of them
# (PERF.md, section 6). A session therefore starts with this many one-cycle
# ``torch.cuda._sleep`` kernels and waits for them, so that the loss falls
# on them; while one of them is in the trace, the block's kernels are whole.
PRIMING_KERNELS = 256
PRIMING_KERNEL_NAME = "spin_kernel"  # torch.cuda._sleep's kernel


def prime_session(device="cuda") -> None:
    """Launch ``PRIMING_KERNELS`` one-cycle kernels on ``device`` and wait
    for them: the first thing a profiler session does on the card."""
    with torch.cuda.device(device):
        for _ in range(PRIMING_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()


def is_priming_kernel(name: str) -> bool:
    return PRIMING_KERNEL_NAME in name


@contextlib.contextmanager
def device_trace(logdir: str, *, device="cuda"):
    """Trace the enclosed block with ``torch.profiler`` (host operators, and
    the CUDA kernels when ``device`` is a CUDA device) and write it into
    ``logdir`` as a Chrome/Perfetto trace, ``trace_<pid>_<ns>.json``. The
    device is synchronised before the trace stops, so every kernel the
    block launched ran inside it. The program's spans and counts recorded
    during the session (``records``) are in the trace too, category
    ``program``, on the threads that made them.

    On a CUDA device the trace starts with up to ``PRIMING_KERNELS``
    ``spin_kernel`` records (``prime_session``). When none of them is in
    it, the profiler lost records past them, perhaps some of the block's,
    and a ``RuntimeWarning`` says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        if cuda:
            prime_session(device)
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            t1 = time.time_ns()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_program_events(path, records(t0, t1))
    if cuda and not any(e.device_type == DeviceType.CUDA and is_priming_kernel(e.name)
                        for e in prof.events()):
        warnings.warn("torch.profiler lost every priming kernel record of this session: "
                      "the trace may lack kernels of the block", RuntimeWarning, stacklevel=3)


def _add_program_events(path: str, recs) -> None:
    """Append the program's records to the Chrome trace at ``path``: a span
    as a complete ("X") event, a count as an instant ("i") one, category
    ``program``, on the thread that made it, on the trace's time base (the
    profiler writes ``ts`` in µs after the trace's ``baseTimeNanoseconds``,
    since the epoch where it has none)."""
    with open(path) as f:
        trace = json.load(f)
    base, pid = int(trace.get("baseTimeNanoseconds", 0)), os.getpid()
    for r in recs:
        if isinstance(r, Span):
            trace["traceEvents"].append(
                {"ph": "X", "cat": "program", "name": r.name, "pid": pid, "tid": r.thread,
                 "ts": (r.start - base) / 1e3, "dur": (r.end - r.start) / 1e3,
                 "args": dict(r.attrs, id=r.id, parent=r.parent, request=r.request)})
        else:
            trace["traceEvents"].append(
                {"ph": "i", "s": "t", "cat": "program", "name": r.name, "pid": pid,
                 "tid": r.thread, "ts": (r.time - base) / 1e3, "args": dict(r.attrs, n=r.n)})
    with open(path, "w") as f:
        json.dump(trace, f)


@dataclass
class Timing:
    compile_s: float  # the first call: lazy builds, allocator warm-up
    mean_s: float
    std_s: float
    reps: int

    def __repr__(self):
        return (
            f"Timing(compile={self.compile_s*1e3:.1f}ms, "
            f"run={self.mean_s*1e3:.3f}±{self.std_s*1e3:.3f}ms x{self.reps})"
        )


def _synchronize(out) -> None:
    """Wait for the CUDA devices that hold tensors of ``out``."""
    stack, devices = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


def time_jit(fn: Callable, *args, reps: int = 10, **kwargs) -> Timing:
    """Time a callable: the first call separately from the steady-state
    mean over ``reps`` calls, each ended by a synchronisation of the CUDA
    devices its output lives on."""
    t0 = time.perf_counter()
    _synchronize(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return Timing(
        compile_s=compile_s,
        mean_s=float(np.mean(times)),
        std_s=float(np.std(times)),
        reps=reps,
    )
