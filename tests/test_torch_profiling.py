"""The PyTorch port's profiling helpers (``fugue_tpu_torch/utils/profiling.py``)
on the CPU, as ``tests/test_profiling.py`` holds the JAX package's: the
first call timed apart from the steady state, and a trace file written by
``device_trace`` (the program's spans in it: ``tests/test_torch_tracing.py``).
The same calls on the card (a CUDA trace naming the SMC kernels) are in
``chip_smoke.py``'s ``serve_pf`` phase."""

import json

import torch

from fugue_tpu_torch.utils.profiling import Timing, device_trace, time_jit


def test_time_jit_separates_first_call_from_steady_state():
    calls = []

    def f(x):
        calls.append(1)
        return torch.sum(x * x)

    t = time_jit(f, torch.arange(64.0), reps=5)
    assert isinstance(t, Timing) and t.reps == 5 and len(calls) == 6
    assert t.compile_s > 0 and t.mean_s >= 0 and t.std_s >= 0
    assert "Timing(" in repr(t)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace"), device="cpu"):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)

