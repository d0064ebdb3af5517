"""The share of the traced call's HMC transitions that replayed the drive's
CUDA graph (the program's ``hmc.graph_replay`` counts), in %. None where
the program records nothing or has no such graph."""


def read(run):
    try:
        from fugue_tpu_torch.inference import hmc
        from fugue_tpu_torch.utils.profiling import Count, records
    except ImportError:
        return None
    t = run.counters.get("trace") or {}
    if run.trace is None or not t.get("transitions") or not hasattr(hmc, "TransitionGraphs"):
        return None
    recs = records(*run.trace.window)
    if not recs:
        return None
    replays = sum(r.n for r in recs if isinstance(r, Count) and r.name == "hmc.graph_replay")
    return 100.0 * replays / t["transitions"]
