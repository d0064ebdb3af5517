"""The program's named device-to-host reads (``host_read`` counts) made
inside its ``smc.stage`` spans in the traced run, per stage. None where the
program records no spans."""


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Count, Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    recs = records(*run.trace.window)
    stages = [r for r in recs if isinstance(r, Span) and r.name == "smc.stage"]
    if not stages:
        return None
    reads = sum(c.n for c in recs if isinstance(c, Count) and c.name == "host_read"
                and any(s.thread == c.thread and s.start <= c.time <= s.end for s in stages))
    return reads / len(stages)
