"""Device operations launched outside the potential span per iteration of
the async NUTS drive, in the traced call."""


def read(run):
    t = run.counters.get("trace") or {}
    if run.trace is None or run.workload["traffic"] != "nuts" or not t.get("iterations"):
        return None
    outside = len(run.trace.ops) - len(run.trace.in_span("pb.potential"))
    return outside / t["iterations"]
