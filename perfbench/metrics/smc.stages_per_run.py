"""The program's ``smc.stage`` counts per ``smc.run`` span in the traced
run: the β ladder's length. None where the program records nothing."""


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Count, Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    recs = records(*run.trace.window)
    runs = sum(1 for r in recs if isinstance(r, Span) and r.name == "smc.run")
    if not runs:
        return None
    return sum(r.n for r in recs if isinstance(r, Count) and r.name == "smc.stage") / runs
