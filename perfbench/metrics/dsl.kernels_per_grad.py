"""Device operations of one batched value-and-gradient of the DSL-compiled
model at the sessions' positions, traced on its own."""


def read(run):
    return run.counters.get("dsl_kernels_per_grad")
