"""The share of the traced window's device-idle time during which no
``serve.method`` span of the program was open, in %: the device waiting on
the service itself (HTTP, JSON, the lock, the reply) rather than on a
method's host work. None where the program records no spans."""


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap(a, b):
    """The total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, e - s)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    w0, w1 = run.trace.window
    methods = _union([max(r.start, w0), min(r.end, w1)] for r in records(w0, w1)
                     if isinstance(r, Span) and r.name == "serve.method")
    if not methods:
        return None
    idle, t = [], w0
    for s, e in run.trace.busy_intervals() + [[w1, w1]]:
        if s > t:
            idle.append([t, s])
        t = max(t, e)
    idle_ns = sum(e - s for s, e in idle)
    if idle_ns <= 0:
        return None
    return 100.0 * (idle_ns - _overlap(idle, methods)) / idle_ns
