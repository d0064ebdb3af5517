"""The program's ``density.normal_plane`` counts (one per batched call of
the Normal log-density kernel of shared data) made inside the program's
``potential`` spans that lie inside an ``smc.move`` span, per such span, in
the traced run. None where the program records no such span or no such
count."""

import bisect


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Count, Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    recs = records(*run.trace.window)
    spans = {r.id: r for r in recs if isinstance(r, Span)}
    calls = [r for r in recs if isinstance(r, Count) and r.name == "density.normal_plane"]

    def in_move(s):
        p = s.parent
        while p is not None and p in spans:
            if spans[p].name == "smc.move":
                return True
            p = spans[p].parent
        return False

    grads = sorted((s.start, s.end, s.thread) for s in spans.values()
                   if s.name == "potential" and in_move(s))
    if not grads or not calls:
        return None
    starts = [a for a, _, _ in grads]
    inside = 0
    for c in calls:
        i = bisect.bisect_right(starts, c.time) - 1
        if i >= 0 and c.time <= grads[i][1] and c.thread == grads[i][2]:
            inside += c.n
    return inside / len(grads)
