"""Profiling and timing utilities.

The port of ``fugue_tpu/utils/profiling.py``: a ``torch.profiler`` context
that writes a device trace (Chrome/Perfetto JSON), a timing helper that
reports the first call apart from the steady state, and a FLOP count of a
callable.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch


# torch.profiler (PyTorch 2.11 on an H100) drops the first kernel records
# of a session: usually 4 or 5, now and then a few hundred or all of them
# (PERF.md, section 6). A session therefore starts with this many one-cycle
# ``torch.cuda._sleep`` kernels and waits for them, so that the loss falls
# on them; while one of them is in the trace, the block's kernels are whole.
PRIMING_KERNELS = 256
PRIMING_KERNEL_NAME = "spin_kernel"  # torch.cuda._sleep's kernel


def prime_session(device="cuda") -> None:
    """Launch ``PRIMING_KERNELS`` one-cycle kernels on ``device`` and wait
    for them: the first thing a profiler session does on the card."""
    with torch.cuda.device(device):
        for _ in range(PRIMING_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()


def is_priming_kernel(name: str) -> bool:
    return PRIMING_KERNEL_NAME in name


@contextlib.contextmanager
def device_trace(logdir: str, *, device="cuda"):
    """Trace the enclosed block with ``torch.profiler`` (host operators, and
    the CUDA kernels when ``device`` is a CUDA device) and write it into
    ``logdir`` as a Chrome/Perfetto trace, ``trace_<pid>_<ns>.json``. The
    device is synchronised before the trace stops, so every kernel the
    block launched ran inside it.

    On a CUDA device the trace starts with up to ``PRIMING_KERNELS``
    ``spin_kernel`` records (``prime_session``). When none of them is in
    it, the profiler lost records past them, perhaps some of the block's,
    and a ``RuntimeWarning`` says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            prime_session(device)
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    if cuda and not any(e.device_type == DeviceType.CUDA and is_priming_kernel(e.name)
                        for e in prof.events()):
        warnings.warn("torch.profiler lost every priming kernel record of this session: "
                      "the trace may lack kernels of the block", RuntimeWarning, stacklevel=3)


@dataclass
class Timing:
    compile_s: float  # the first call: lazy builds, allocator warm-up
    mean_s: float
    std_s: float
    reps: int

    def __repr__(self):
        return (
            f"Timing(compile={self.compile_s*1e3:.1f}ms, "
            f"run={self.mean_s*1e3:.3f}±{self.std_s*1e3:.3f}ms x{self.reps})"
        )


def _synchronize(out) -> None:
    """Wait for the CUDA devices that hold tensors of ``out``."""
    stack, devices = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


def time_jit(fn: Callable, *args, reps: int = 10, **kwargs) -> Timing:
    """Time a callable: the first call separately from the steady-state
    mean over ``reps`` calls, each ended by a synchronisation of the CUDA
    devices its output lives on."""
    t0 = time.perf_counter()
    _synchronize(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return Timing(
        compile_s=compile_s,
        mean_s=float(np.mean(times)),
        std_s=float(np.std(times)),
        reps=reps,
    )


def cost_summary(fn: Callable, *args) -> Dict[str, Any]:
    """The floating-point operations of one ``fn(*args)`` call, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them per operator
    (a matmul is 2·M·N·K): ``{"flops": n}``. Bytes accessed are not counted
    (the JAX package's XLA cost analysis also reports them)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}
