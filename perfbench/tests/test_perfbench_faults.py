"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: a step that returns its state unchanged,
the same for half of the chains only, half of the batch of observations
left out with the rest counted double, and an answer altered where it is
produced (one chip: no exchange between chips to leave
out). The control, the reference computed in bfloat16 in the program's
place, fails the cell's limits too. On the CPU at a small size; the card's
version runs the cell's own size."""

import pytest
import torch

from perfbench import checks, harness

SMALL = {
    "eight_schools_nc.hmc": {"chains": 64, "warmup": 40, "call_samples": 10, "n_leapfrog": 8},
    "eight_schools_nc.serve": {"chains": 64, "warmup": 40},
}
CATCHES = {"frozen": "stuck_share", "half_chains": "stuck_share", "half_batch": "u_gap",
           "altered": "mean_z"}


def _run(workload, seed=2**33 + 17, seconds=2.0, plant=None, device="cpu"):
    """A whole run; ``plant`` breaks the program once set-up has run, so the
    fault sits in the timed path."""
    overrides = SMALL[workload] if device == "cpu" else None
    run = harness.new_run(workload, seed, seconds, False, device=device, overrides=overrides)
    if plant is not None:
        setup = run.traffic.setup

        def setup_then_plant(r):
            setup(r)
            plant()

        run.traffic.setup = setup_then_plant
    return run, harness.run_cell(run)


def _plant(monkeypatch, workload, fault):
    if fault == "half_batch":
        _plant_half_batch(monkeypatch)
    elif workload.endswith(".serve"):
        _plant_session(monkeypatch, fault)
    else:
        _plant_drive(monkeypatch, fault)


def _freeze_half(new, old):
    """``new`` with every second chain (dim 0 of ``old``) kept at ``old``."""
    new = new.clone()
    new[1::2] = old[1::2]
    return new


def _alter(q):
    """The first coordinate of every draw moved by its spread."""
    q = q.clone()
    q[..., 0] += q[..., 0].std()
    return q


def _plant_drive(monkeypatch, fault):
    """Break the drives' output: frozen draws or altered ones."""
    from fugue_tpu_torch.inference import hmc, nuts

    def wrap(make):
        def make_broken(*args, **kwargs):
            drive = make(*args, **kwargs)

            def broken(q0, *a, **k):
                out = list(drive(q0, *a, **k))
                if fault == "frozen":
                    out[0], out[1] = q0.clone(), q0[None].expand_as(out[1]).clone()
                elif fault == "half_chains":
                    out[0] = _freeze_half(out[0], q0)
                    out[1] = out[1].clone()
                    out[1][:, 1::2] = q0[None, 1::2]
                else:
                    out[0], out[1] = _alter(out[0]), _alter(out[1])
                return tuple(out)
            return broken
        return make_broken

    monkeypatch.setattr(nuts, "make_nuts_drive", wrap(nuts.make_nuts_drive))
    monkeypatch.setattr(hmc, "make_hmc_drive", wrap(hmc.make_hmc_drive))


def _plant_session(monkeypatch, fault):
    from fugue_tpu_torch.inference import chees

    real = chees.chees_transition

    def broken(potential, Q, *args, **kwargs):
        out = list(real(potential, Q, *args, **kwargs))
        if fault == "frozen":
            out[0] = Q.clone()
        elif fault == "half_chains":
            out[0] = _freeze_half(out[0], Q)
        else:
            out[0] = _alter(out[0])
        return tuple(out)

    monkeypatch.setattr(chees, "chees_transition", broken)


class _Half:
    """An observed site's distribution whose log-density keeps half of the
    batch, counted double: the even elements of a vector observation, or
    every second scalar observation of a model run (``keep``)."""

    def __init__(self, dist, keep):
        self.dist, self.keep, self.support = dist, keep, dist.support

    def log_prob(self, value):
        lp = self.dist.log_prob(value)
        if lp.dim() and lp.shape[-1] > 1:
            even = (torch.arange(lp.shape[-1], device=lp.device) % 2 == 0).to(lp.dtype)
            return lp * even * 2.0
        return lp * (2.0 if self.keep else 0.0)


def _plant_half_batch(monkeypatch):
    """Every observation's log-density over half of the batch, doubled."""
    from fugue_tpu_torch.runtime import interpreters

    real = interpreters._RecordingHandler._score_site

    def half(self, addr, dist, value, observed):
        if observed:
            n = getattr(self, "_half_seen", 0)
            self._half_seen = n + 1
            dist = _Half(dist, n % 2 == 1)
        return real(self, addr, dist, value, observed)

    monkeypatch.setattr(interpreters._RecordingHandler, "_score_site", half)


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", sorted(CATCHES))
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    _, out = _run(workload, plant=lambda: _plant(monkeypatch, workload, fault))
    assert out["correct"] is False
    c = out["checks"][CATCHES[fault]]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_fails_the_limits(workload):
    run, out = _run(workload)
    ref, data, states = run.check_inputs
    control = checks.control_numbers(ref, data, states)
    limits = run.cell["limits"]
    failed = [k for k, v in control.items() if k in limits and v > limits[k]]
    assert failed, (control, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_fails_at_the_cells_size_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.readings import readings

    rows = list(readings(workload, [2**32 + 1, 2**32 + 2, 2**32 + 3], 10.0))
    limits = harness.cell(workload)["limits"]
    for row in rows:
        assert row["correct"], row
        assert any(v > limits[k] for k, v in row["control"].items() if k in limits), row


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", sorted(CATCHES))
def test_the_faults_at_the_cells_size_on_the_card(workload, fault):
    """The faults' readings at the cell's own size, on three seeds, a short
    window each (printed, one JSON line per seed); each seed's program is
    whole again before its set-up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    for seed in (2**32 + 11, 2**32 + 12, 2**32 + 13):
        with pytest.MonkeyPatch.context() as mp:
            run, out = _run(workload, seed, 10.0, lambda: _plant(mp, workload, fault),
                            device="cuda")
        print(json.dumps({"workload": workload, "fault": fault, "seed": seed,
                          "checks": {k: v["value"] for k, v in out["checks"].items()}}))
        assert out["correct"] is False
        del run, out
        torch.cuda.empty_cache()
