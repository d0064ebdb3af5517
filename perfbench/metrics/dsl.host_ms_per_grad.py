"""The mean length of the program's ``potential`` spans in the traced
stretch of requests, in ms: one batched value-and-gradient of the
DSL-compiled model inside ``chees.step``, in the service's handler
threads. None where the program records no spans."""


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
