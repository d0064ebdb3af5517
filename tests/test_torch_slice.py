"""The PyTorch port's slices as a whole, on the CPU.

- The ``__graft_entry__.entry()`` analog: 32 eight-schools chains from the
  same q0, with the JAX step's own momenta and accept uniforms handed to
  the port, take one batched transition equal to the JAX step (float64,
  tolerance 1e-10).
- The port imports no JAX: a static walk over its sources with ``ast``.
- The flat API is the slices' subset of fugue_tpu's.
- Every entry point runs on the card unless the caller names a device; the
  batched ``simulate_batch``/``replay_partial_batch`` run on their staged
  model's device, which is the card unless the caller names another.
"""

import ast
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu_torch import interop, settings
from fugue_tpu_torch.interop import hmc_state_from_numpy, tensor_from_numpy

import torch_parity_models as models

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "fugue_tpu")
FLAT_API = ("sample", "observe", "factor", "guard", "Normal", "LogNormal", "stage",
            "HMCConfig", "HMCResult", "HmcSession", "hmc_chain", "hmc_transition",
            "NUTSConfig", "NUTSResult", "NutsSession", "nuts_chain", "nuts_transition",
            "print_diagnostics", "summarize_samples", "ParameterSummary",
            "ess", "ess_multichain", "geweke", "r_hat", "rank_normalized_split_r_hat",
            "split_r_hat", "SMCConfig", "SMCResult", "adaptive_smc", "importance_reweight",
            "ChEESConfig", "ChEESResult", "CheesSession", "chees_chain", "MHResult",
            "adaptive_mcmc_chain", "Choice", "Trace", "ReplayHandler", "PredictiveHandler",
            "ScoreGivenTrace", "SafeScoreGivenTrace", "SafeReplayHandler",
            "StrictScoreGivenTrace", "ReconcileReport", "ReconcilingScoreGivenTrace",
            "score_given_trace", "score_given_trace_safe", "score_given_trace_strict",
            "score_given_trace_reconciled", "predictive", "posterior_predictive",
            "VIConfig", "VIResult", "MeanFieldGuide", "FullRankGuide", "GuideError", "elbo",
            "estimate_elbo", "optimize_meanfield_vi", "optimize_fullrank_vi", "ABCError",
            "ABCResult", "ABCSMCConfig", "SummaryStatsDistance", "abc_rejection",
            "abc_smc_weighted", "abc_smc", "abc_scalar_summary", "euclidean_distance",
            "manhattan_distance", "MAPConfig", "MAPResult", "map_estimate", "LaplaceResult",
            "laplace_approximation", "MarginalizedModel", "marginalize", "GibbsResult",
            "gibbs_chain", "ESSConfig", "ESSResult", "ess_chain", "PTConfig", "PTResult",
            "geometric_ladder", "pt_chain", "ELPDResult", "pointwise_log_likelihood", "waic",
            "psis_loo", "compare", "ValidationResult", "ConjugateNormalConfig",
            "ConjugateBetaBernoulliConfig", "ks_two_sample", "validate_conjugate_normal",
            "validate_beta_bernoulli", "SBCResult", "sbc", "DynamicMHResult",
            "adaptive_mcmc_chain_dynamic")
ENTRY_POINTS = (ftt.stage, ftt.StagedModel, ftt.hmc_chain, ftt.HmcSession, ftt.nuts_chain,
                ftt.NutsSession, ftt.adaptive_smc, ftt.importance_reweight, ftt.chees_chain,
                ftt.CheesSession, ftt.adaptive_mcmc_chain, interop.tensor_from_numpy,
                interop.hmc_state_from_numpy, interop.chees_state_from_numpy,
                interop.mh_state_from_numpy, interop.smc_state_from_numpy,
                interop.vi_params_from_numpy, ftt.predictive, ftt.optimize_meanfield_vi,
                ftt.optimize_fullrank_vi, ftt.estimate_elbo, ftt.abc_rejection,
                ftt.abc_smc_weighted, ftt.abc_smc, ftt.abc_scalar_summary, ftt.ReplayHandler,
                ftt.PredictiveHandler, ftt.SafeScoreGivenTrace, ftt.ReconcilingScoreGivenTrace,
                ftt.score_given_trace_safe, ftt.score_given_trace_reconciled,
                ftt.map_estimate, ftt.marginalize, ftt.gibbs_chain, ftt.ess_chain, ftt.pt_chain,
                ftt.pointwise_log_likelihood, ftt.validate_conjugate_normal,
                ftt.validate_beta_bernoulli, ftt.sbc, ftt.adaptive_mcmc_chain_dynamic,
                interop.gibbs_state_from_numpy, interop.pt_state_from_numpy)


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def test_entry_step_matches_jax():
    fn, (q0, keys) = __graft_entry__.entry()
    q0 = np.asarray(q0, np.float64)
    jq, jacc = fn(jnp.asarray(q0), keys)

    def noise(key):
        k_mom, k_acc = jax.random.split(key)
        p = jax.random.normal(k_mom, (q0.shape[1],), jnp.float64)  # inv_mass = 1
        return p, jnp.log(jax.random.uniform(k_acc, (), jnp.float64, 1e-38, 1.0))

    p, log_u = jax.vmap(noise)(keys)
    ts = ftt.stage(models.torch_eight_schools(), device="cpu")
    tq, info = ftt.hmc_transition(
        ts.potential, torch.as_tensor(q0), torch.as_tensor(np.array(p)),
        torch.as_tensor(np.array(log_u)), 0.1, 8, torch.ones(ts.dim, dtype=torch.float64),
    )
    assert tq.shape == (32, 10)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(info.accept_prob.numpy(), np.asarray(jacc),
                               rtol=1e-10, atol=1e-10)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted((REPO / "fugue_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_flat_api_is_a_subset_of_fugue_tpu():
    for name in FLAT_API:
        assert hasattr(ftt, name), name
        assert hasattr(ft, name), name


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_interop_carries_numpy_state():
    rng = np.random.default_rng(0)
    q, im = rng.normal(size=(4, 3)), rng.uniform(0.5, 2.0, 3)
    st = hmc_state_from_numpy(q, np.float32(0.25), im, device="cpu", dtype=torch.float64)
    assert st.positions.shape == (4, 3) and st.step_size.dim() == 0
    np.testing.assert_array_equal(st.positions.numpy(), q)
    assert st.step_size.item() == 0.25
    with pytest.raises(ValueError):
        hmc_state_from_numpy(q, 0.1, im[:2], device="cpu")
    t = tensor_from_numpy(np.arange(6).reshape(2, 3)[:, ::2], device="cpu")
    assert t.dtype == torch.int64 and t.is_contiguous() and t.tolist() == [[0, 2], [3, 5]]
    assert tensor_from_numpy([1.0, 2.0], device="cpu", dtype=torch.float32).dtype == torch.float32


def test_plate_slice_end_to_end():
    """The plate model through the public API: stage, a short hmc_chain
    from a warm start, and the posterior of mu near the data mean."""
    y = torch.as_tensor(models.plate_data(1024))

    def plate():
        mu = ftt.sample("mu", ftt.Normal(0.0, 10.0))
        sigma = ftt.sample("sigma", ftt.LogNormal(0.0, 1.0))
        ftt.factor(ftt.pnormal_loglik_sum(y, mu, sigma))

    res = ftt.hmc_chain(2, plate, n_samples=60, n_warmup=60, n_chains=8, device="cpu",
                        config=ftt.HMCConfig(n_leapfrog=8, jitter=0.5),
                        init_position=torch.stack([y.mean(), y.std().log()]),
                        init_jitter=0.01)
    mu = res.samples["mu"]
    se = y.std().item() / np.sqrt(y.numel())
    assert abs(mu.mean().item() - y.mean().item()) < 5 * se
    assert bool(torch.isfinite(res.log_joint).all())
