"""Synchronizing CUDA calls (device-to-host reads) per transition of the
traced call, counted by PyTorch's sync debugging in its warning mode."""


def read(run):
    t = run.counters.get("trace") or {}
    if t.get("host_syncs") is None or not t.get("transitions"):
        return None
    return t["host_syncs"] / t["transitions"]
