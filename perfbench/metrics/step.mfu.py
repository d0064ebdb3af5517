"""The whole step's share of the chip's peak over the window: the
configuration's operations per batched gradient (``flops_per_grad``; bf16
products at the bf16 peak, the rest at float32's) at peak, times the
batched gradients of the window, over the window."""

from perfbench.peaks import BF16_FLOPS, FP32_FLOPS


def read(run):
    c = run.counters
    if not c.get("batched_grads") or not run.window_s:
        return None
    f = run.config.flops_per_grad(run.cell["chains"], **run.cell.get("config_args", {}))
    at_peak = f["bf16"] / BF16_FLOPS + f["fp32"] / FP32_FLOPS
    return 100.0 * at_peak * c["batched_grads"] / run.window_s
