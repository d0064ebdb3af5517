"""The bf16 products' share of their roofline in the traced call: the
least time of one batched gradient's products (the configuration's
``product_cost``: max(bytes / HBM rate, operations / bf16 peak)) times the
batched gradients, over the device time of the GEMM kernels launched in the
potential span."""

from perfbench.peaks import BF16_FLOPS, GEMM_WORDS, HBM_BYTES_PER_S


def read(run):
    t = run.counters.get("trace") or {}
    cost = getattr(run.config, "product_cost", None)
    if run.trace is None or cost is None or not t.get("grads"):
        return None
    gemms = [o for o in run.trace.in_span("pb.potential")
             if any(w in o.name.lower() for w in GEMM_WORDS)]
    if not gemms:
        return None
    c = cost(run.cell["chains"], **run.cell.get("config_args", {}))
    least = max(c["bytes"] / HBM_BYTES_PER_S, c["flops"] / BF16_FLOPS) * t["grads"]
    return 100.0 * least / (sum(o.end - o.start for o in gemms) * 1e-9)
