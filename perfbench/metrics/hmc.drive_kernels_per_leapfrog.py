"""Device operations launched outside the potential span per leapfrog of
the HMC drive, in the traced call."""


def read(run):
    t = run.counters.get("trace") or {}
    if run.trace is None or run.workload["traffic"] != "hmc" or not t.get("leapfrogs"):
        return None
    outside = len(run.trace.ops) - len(run.trace.in_span("pb.potential"))
    return outside / t["leapfrogs"]
