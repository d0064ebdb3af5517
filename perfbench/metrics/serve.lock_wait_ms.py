"""The mean of (time in ``FugueService.handle``) - (time in the method) over
the window's requests, in ms: the wait for the service's one lock and the
reply's conversion to JSON values. The benchmark wraps its own service
instance's ``handle`` and method table."""


def read(run):
    waits = run.counters.get("lock_waits_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
