"""The program's ``smc.stage`` spans in the traced run, each less the
``potential`` spans inside it, per stage, in ms: the ladder's own host time
(the β search and its read, the resample, the moves' bookkeeping), waits
on the device at the read included. None where the program records no
spans."""


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    spans = {r.id: r for r in records(*run.trace.window) if isinstance(r, Span)}
    stages = {i: s.end - s.start for i, s in spans.items() if s.name == "smc.stage"}
    if not stages:
        return None
    for s in spans.values():
        if s.name != "potential":
            continue
        p = s.parent
        while p is not None and p in spans and p not in stages:
            p = spans[p].parent
        if p in stages:
            stages[p] -= s.end - s.start
    return sum(stages.values()) * 1e-6 / len(stages)
