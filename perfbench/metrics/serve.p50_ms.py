"""The median client-side latency of the window's requests, in ms."""

import statistics


def read(run):
    lat = run.counters.get("latencies_s")
    if not lat:
        return None
    return 1e3 * statistics.median(lat)
