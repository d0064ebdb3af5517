"""The program's named device-to-host reads (``host_read`` counts) in the
traced call, per transition. None where the program records nothing."""


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Count, records
    except ImportError:
        return None
    t = run.counters.get("trace") or {}
    if run.trace is None or not t.get("transitions"):
        return None
    recs = records(*run.trace.window)
    if not recs:
        return None
    reads = sum(r.n for r in recs if isinstance(r, Count) and r.name == "host_read")
    return reads / t["transitions"]
