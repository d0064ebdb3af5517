"""The benchmark's ``gmm_mixture`` configuration (posteriordb's
low_dim_gauss_mix) on the CPU: its staged potential and gradient against
the plain reference (``perfbench/reference/gmm_mixture.py``) in float64,
and the ``gmm_mixture.smc`` cell run whole at a small size, in a fresh
process: ``adaptive_smc``'s posterior means and log Z over four runs of
512 particles (N = 100 from the same generator) within 5 standard errors
of the reference's importance sampler, and no module of JAX or the JAX
package loaded."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import fugue_tpu_torch as ftt
from fugue_tpu_torch import settings
from fugue_tpu_torch.inference.hmc import batched_force
from perfbench import harness

CONFIG = harness.config("gmm_mixture")
REF = harness.reference("gmm_mixture")


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _staged(n=CONFIG.N):
    problem = CONFIG.build(0, "cpu", n=n, dtype=torch.float64)
    return problem, ftt.stage(problem.model_fn, device="cpu")


def _points(seed, s=24):
    """Seeded points around and away from the posterior."""
    rng = np.random.default_rng(seed)
    q = rng.normal([-2.7, 1.7, 0.0, 0.0, 0.3], [0.6, 0.5, 0.5, 0.5, 1.0], (s, 5))
    return torch.as_tensor(q)


def test_posteriordbs_parametrisation_ordered_means_and_no_guard():
    problem, staged = _staged()
    assert [(s.address, s.shape, s.support.kind) for s in staged.sites] == [
        ("mu", (2,), "ordered"), ("sigma", (2,), "positive"), ("theta", (), "unit")]
    assert staged.dim == CONFIG.DIM == 5 and len(problem.data["y"]) == CONFIG.N == 1000
    assert CONFIG.REDUCED == [] and "DATA_SEED" in CONFIG.ASSUMED
    # a guard would score −inf somewhere; the ordered transform never leaves the support
    g, u = batched_force(staged.potential)(torch.as_tensor(
        [[0.0, -20.0, 0.0, 0.0, 0.0], [5.0, 3.0, 1.0, -1.0, 4.0]], dtype=torch.float64))
    assert torch.all(torch.isfinite(u)) and torch.all(torch.isfinite(g))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_staged_potential_and_gradient_equal_the_reference(seed):
    problem, staged = _staged()
    q = _points(seed)
    g, u = batched_force(staged.potential)(q)
    u_ref, g_ref = REF.potential_and_grad(problem.data, q)
    torch.testing.assert_close(u, u_ref, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(g, g_ref, rtol=1e-10, atol=1e-8)


def test_constrain_equals_the_references():
    problem, staged = _staged()
    q = _points(4, s=8)
    for row, want in zip(q, REF.constrain(q)):
        cont, _ = staged.constrain(row)
        got = torch.cat([cont["mu"], cont["sigma"], cont["theta"].reshape(1)])
        torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13)


def test_reference_potential_in_bfloat16_is_far_from_float64():
    """The control the cell's limits are set against: the reference computed
    in bfloat16 misses U by nats and the gradient by tens of percent."""
    problem, _ = _staged()
    q = _points(5)
    u64, g64 = REF.potential_and_grad(problem.data, q)
    u16, g16 = REF.potential_and_grad(problem.data, q, torch.bfloat16)
    assert float(torch.max(torch.abs(u16.double() - u64))) > 1.0
    rel = torch.linalg.norm(g16.double() - g64, dim=1) / torch.linalg.norm(g64, dim=1)
    assert float(torch.max(rel)) > 0.01


def test_flops_per_grad_scale_with_particles_and_observations():
    one = CONFIG.flops_per_grad(1)["fp32"]
    assert CONFIG.flops_per_grad(8)["fp32"] == 8 * one
    assert CONFIG.flops_per_grad(1, n=2000)["fp32"] > 1.9 * one


def test_the_cell_runs_whole_on_the_cpu_within_five_standard_errors():
    code = f"""
import json, sys
sys.path.insert(0, {str(harness.ROOT)!r})
import torch
torch.set_num_threads(2)
from perfbench import harness
run = harness.new_run("gmm_mixture.smc", 2**33 + 7, 0.0, False, device="cpu",
                      overrides={{"chains": 512, "min_runs": 4, "config_args": {{"n": 100}},
                                  "reference_draws": 1 << 16}})
out = harness.run_cell(run)
print(json.dumps({{"out": out, "runs": run.counters["runs"],
                  "forbidden": harness.forbidden_modules()}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    checks = {k: v["value"] for k, v in got["out"]["checks"].items()}
    assert got["forbidden"] == []
    assert got["runs"] == 4 and got["out"]["attempted"] == 4 and got["out"]["failed"] == 0
    assert got["out"]["correct"], checks
    assert checks["mean_z"] <= 5.0 and checks["logz_z"] <= 5.0
    assert checks["unconverged_share"] == 0.0
