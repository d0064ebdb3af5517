"""Device operations launched inside the potential span (one batched
value-and-gradient of the staged model under vmap) per such call, in the
traced call."""


def read(run):
    t = run.counters.get("trace") or {}
    if run.trace is None or not t.get("grads"):
        return None
    return len(run.trace.in_span("pb.potential")) / t["grads"]
