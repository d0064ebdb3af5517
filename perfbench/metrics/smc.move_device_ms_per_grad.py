"""Device time of the operations launched inside the program's
``potential`` spans that lie inside an ``smc.move`` span (one batched
value-and-gradient of an HMC move), per such span, in ms, in the traced
run. None where the program records no spans."""

import bisect


def read(run):
    try:
        from fugue_tpu_torch.utils.profiling import Span, records
    except ImportError:
        return None
    if run.trace is None:
        return None
    spans = {r.id: r for r in records(*run.trace.window) if isinstance(r, Span)}

    def in_move(s):
        p = s.parent
        while p is not None and p in spans:
            if spans[p].name == "smc.move":
                return True
            p = spans[p].parent
        return False

    grads = sorted((s.start, s.end) for s in spans.values()
                   if s.name == "potential" and in_move(s))
    if not grads:
        return None
    starts = [a for a, _ in grads]
    busy = 0
    for op in run.trace.ops:
        i = bisect.bisect_right(starts, op.launch) - 1
        if i >= 0 and op.launch <= grads[i][1]:
            busy += op.end - op.start
    return busy * 1e-6 / len(grads)
