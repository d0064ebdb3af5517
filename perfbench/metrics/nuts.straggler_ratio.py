"""The async NUTS drive's iterations per transition over the chains' mean
leapfrogs per transition, over the window's calls (``NUTSResult``
``lockstep_leaves`` and ``n_leapfrogs``): 1 when no chain waits."""


def read(run):
    c = run.counters
    if not c.get("chain_grads") or run.workload["traffic"] != "nuts":
        return None
    return c["batched_grads"] * c["chains"] / c["chain_grads"]
