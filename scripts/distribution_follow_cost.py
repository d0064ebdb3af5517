#!/usr/bin/env python3
"""The host cost of the distributions' device follow-up, on a GPU.

    python3 scripts/distribution_follow_cost.py [--rounds 8] [--grads 100]

Every distribution's ``sample`` and ``log_prob`` are wrapped
(``Distribution.__init_subclass__``) so that a parameter left on the CPU
(a numpy array, say) moves to the device of the value or generator first
(``Distribution._follow``). This times chip_smoke.py's eight-schools
batched gradient (1024 chains, one model run under ``vmap``) with the
wrappers in place and with them taken off (the wrapped functions put
back), in alternating rounds in one process, and prints one JSON line:
the median ms per batched gradient of each, their difference, and the
wrapped calls per gradient, beside the card's name and power limit.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fugue_tpu_torch as ftt  # noqa: E402
from chip_smoke import card_line, eight_schools_model  # noqa: E402
from fugue_tpu_torch.core.distributions import Distribution  # noqa: E402
from fugue_tpu_torch.inference import hmc  # noqa: E402


def _classes(cls=Distribution):
    for sub in cls.__subclasses__():
        yield sub
        yield from _classes(sub)


def _wrapped():
    """(class, name, wrapper) for every wrapped ``sample`` and ``log_prob``."""
    return [(cls, name, cls.__dict__[name]) for cls in _classes()
            for name in ("sample", "log_prob")
            if getattr(cls.__dict__.get(name), "_follows", False)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8, help="rounds of each kind, alternating")
    ap.add_argument("--grads", type=int, default=100, help="batched gradients per round")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("distribution_follow_cost: no CUDA device")
    staged = ftt.stage(eight_schools_model("cuda"), device="cuda")
    force = hmc.batched_force(staged.potential)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1024, staged.dim), generator=g, device="cuda")
    wrappers = _wrapped()

    calls = [0]

    def counting(fn):
        def count(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return count

    for cls, name, w in wrappers:
        setattr(cls, name, counting(w))
    force(q)
    for cls, name, w in wrappers:
        setattr(cls, name, w)

    def timed(on: bool) -> float:
        for cls, name, w in wrappers:
            setattr(cls, name, w if on else w.__wrapped__)
        force(q)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.grads):
            force(q)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / args.grads

    on, off = [], []
    for _ in range(args.rounds):
        on.append(timed(True))
        off.append(timed(False))
    for cls, name, w in wrappers:
        setattr(cls, name, w)
    m_on, m_off = statistics.median(on), statistics.median(off)
    print(json.dumps({
        "card": card_line(), "model": "eight_schools", "chains": 1024,
        "wrapped_methods": len(wrappers), "wrapped_calls_per_gradient": calls[0],
        "ms_per_gradient_wrapped": on, "ms_per_gradient_unwrapped": off,
        "median_ms_wrapped": m_on, "median_ms_unwrapped": m_off,
        "median_difference_ms": m_on - m_off,
        "difference_share": (m_on - m_off) / m_off}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
