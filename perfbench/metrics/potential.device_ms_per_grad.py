"""Device time of the operations launched inside the potential span per
batched value-and-gradient, in ms, in the traced call."""


def read(run):
    t = run.counters.get("trace") or {}
    if run.trace is None or not t.get("grads"):
        return None
    ops = run.trace.in_span("pb.potential")
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) * 1e-6 / t["grads"]
