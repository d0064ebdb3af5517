"""The SMC kernels' least bytes and their share of the roofline in a
traced run (``metrics/smc.logsumexp_roofline.py``,
``metrics/smc.resample_roofline.py``).

Each call of ``ops.kernels.plogsumexp`` launches ``lse_partial`` and then
``lse_finish``; each call of ``ops.kernels.psystematic_resample`` launches
``lse_parts`` and then ``emit`` (``fugue_tpu_torch/csrc/``). A call's least
time is its bytes over the HBM rate, each input byte read once and each
output byte written once: the log-sum-exp reads the (N,) float32 vector
and writes one value; the resample reads the (N,) float32 log-weights
and writes (N,) int64 ancestors. Every such vector of an SMC run has the
run's N particles.
"""

import re

from perfbench.peaks import HBM_BYTES_PER_S

LOGSUMEXP = (re.compile(r"\blse_partial<"), re.compile(r"\blse_finish<"))
RESAMPLE = (re.compile(r"\blse_parts<"), re.compile(r"\bemit<"))


def logsumexp_bytes(n: int, itemsize: int = 4) -> int:
    return n * itemsize + itemsize


def resample_bytes(n: int, itemsize: int = 4) -> int:
    return n * itemsize + 8 * n


def roofline_share(run, kernels, bytes_per_call):
    """100 × (calls × least time of a call) / the device time of the
    kernels, in the traced run; a call is one launch of the last kernel.
    None where the trace holds none of them."""
    if run.trace is None:
        return None
    ops = [o for o in run.trace.ops if any(k.search(o.name) for k in kernels)]
    calls = sum(1 for o in ops if kernels[-1].search(o.name))
    if not calls:
        return None
    least_s = calls * bytes_per_call(run.cell["chains"]) / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(o.end - o.start for o in ops) * 1e-9)
