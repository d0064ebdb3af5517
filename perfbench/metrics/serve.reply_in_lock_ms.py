"""The mean length of the program's ``serve.reply`` spans (a method's
result made JSON values, ``_jsonable``, with the lock held) in the traced
stretch of requests, in ms. None where the program records no spans."""


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    spans = [r for r in records(*run.trace.window)
             if isinstance(r, Span) and r.name == "serve.reply"]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) * 1e-6 / len(spans)
