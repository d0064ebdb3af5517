"""The share of the traced stretch's ChEES transitions (the program's
``chees.transition`` spans) that replayed the model's CUDA graphs (its
``chees.graph_replay`` counts), in %. None where the program records
nothing or has no such graphs."""


def read(run):
    try:
        from fugue_tpu_torch.inference import chees
        from fugue_tpu_torch.utils.profiling import Count, Span, records
    except ImportError:
        return None
    if run.trace is None or not hasattr(chees, "ChEESGraphs"):
        return None
    recs = records(*run.trace.window)
    transitions = sum(1 for r in recs if isinstance(r, Span) and r.name == "chees.transition")
    if not transitions:
        return None
    replays = sum(r.n for r in recs if isinstance(r, Count) and r.name == "chees.graph_replay")
    return 100.0 * replays / transitions
