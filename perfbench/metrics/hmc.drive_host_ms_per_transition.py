"""The program's ``hmc.transition`` spans in the traced call (one step of
``make_hmc_drive``: its draws, ``hmc_transition`` and the draw's record),
each less its ``potential`` children, per transition, in ms: the drive's
own host time. None where the program records no spans."""


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    spans = [r for r in records(*run.trace.window) if isinstance(r, Span)]
    steps = {s.id: s.end - s.start for s in spans if s.name == "hmc.transition"}
    if not steps:
        return None
    for s in spans:
        if s.name == "potential" and s.parent in steps:
            steps[s.parent] -= s.end - s.start
    return sum(steps.values()) * 1e-6 / len(steps)
