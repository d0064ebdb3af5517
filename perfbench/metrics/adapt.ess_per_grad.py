"""The window's smallest ESS over the constrained parameters per gradient
evaluation summed over chains (NUTS: ``NUTSResult.n_leapfrogs``; HMC:
chains × L per transition): what the warmup's step size and mass buy."""


def read(run):
    c = run.counters
    if not c.get("chain_grads"):
        return None
    return c["min_ess"] / c["chain_grads"]
