"""The mean length of the program's ``potential`` spans (one batched
value-and-gradient, ``hmc.batched_force``) in the traced call, in ms: the
host's time to launch a gradient's kernels. None where the program records
no spans."""


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    spans = [r for r in records(*run.trace.window)
             if isinstance(r, Span) and r.name == "potential"]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) * 1e-6 / len(spans)
