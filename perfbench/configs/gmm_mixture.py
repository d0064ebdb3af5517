"""gmm_mixture: posteriordb's low_dim_gauss_mix-low_dim_gauss_mix.

Betancourt's case study "Identifying Bayesian Mixture Models": two normal
components with ordered means and unknown scales, the memberships summed
out. As posteriordb's Stan program has it:

    parameters { ordered[2] mu; array[2] real<lower=0> sigma;
                 real<lower=0, upper=1> theta; }
    model { sigma ~ normal(0, 2); mu ~ normal(0, 2); theta ~ beta(5, 5);
            for (n in 1:N) target += log_mix(theta,
                normal_lpdf(y[n] | mu[1], sigma[1]), normal_lpdf(y[n] | mu[2], sigma[2])); }

N = 1,000, float32, d = 5 unconstrained coordinates in the staged order
(sites sorted by address): mu_1, log(mu_2 - mu_1) (the ``Ordered``
transform, Stan's own), log sigma_1, log sigma_2, logit theta.

Departures, each written down:

- the densities keep every normalising constant (``HalfNormal(2)`` for
  sigma's truncated normal, the ordered prior's log 2!), so log Z is the
  normalised model's; Stan's ``~`` drops them, which moves no posterior;
- posteriordb's data file is not in the repository. The data is generated
  from ``DATA_SEED`` at the published shape (N = 1,000) from the case
  study's generating values as recalled, not read (``ASSUMED``). The seed
  of a run moves only the particles.

Nothing is cut: ``reduced`` is empty.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

NAME = "gmm_mixture"
SOURCE = ("https://github.com/stan-dev/posteriordb/blob/master/posterior_database/"
          "posteriors/low_dim_gauss_mix-low_dim_gauss_mix.json")
DTYPE = "float32"
N = 1000
DIM = 5
DATA_SEED = 20_191_119
REDUCED: list = []
ASSUMED = {
    "DATA_SEED": DATA_SEED,
    "generating_values": ("a recollection of the case study's simulation, not a reading of "
                          "posteriordb's data file: mu = (-2.75, 2.75), sigma = (1, 1), "
                          "a draw from the second component with probability 0.4"),
    "mu": (-2.75, 2.75),
    "sigma": (1.0, 1.0),
    "second_component_probability": 0.4,
}


def data(n: int = N) -> np.ndarray:
    """The (n,) observations, float32 values as float64, from ``DATA_SEED``."""
    rng = np.random.default_rng(DATA_SEED)
    second = rng.random(n) < ASSUMED["second_component_probability"]
    mu = np.where(second, ASSUMED["mu"][1], ASSUMED["mu"][0])
    sigma = np.where(second, ASSUMED["sigma"][1], ASSUMED["sigma"][0])
    return (mu + sigma * rng.standard_normal(n)).astype(np.float32).astype(np.float64)


def build(seed: int, device, n: int = N, dtype=torch.float32, **_):
    """The problem as served: the model in the port's language, the data on
    ``device`` in ``dtype`` (float32 as served; a test may ask for float64),
    and the data the reference reads."""
    import fugue_tpu_torch as ftt

    y_np = data(n)
    y = torch.tensor(y_np, dtype=dtype, device=device)

    def gmm_mixture():
        mu = ftt.sample("mu", ftt.Ordered(ftt.Normal(0.0, 2.0), 2))
        sigma = ftt.sample("sigma", ftt.HalfNormal(2.0), sample_shape=(2,))
        theta = ftt.sample("theta", ftt.Beta(5.0, 5.0))
        ftt.factor(torch.sum(torch.logaddexp(
            torch.log(theta) + ftt.Normal(mu[0], sigma[0]).log_prob(y),
            torch.log1p(-theta) + ftt.Normal(mu[1], sigma[1]).log_prob(y))))
        return mu

    return SimpleNamespace(model_fn=gmm_mixture, data={"y": y_np}, dim=DIM, map_init=False)


def flops_per_grad(chains: int, n: int = N, **_) -> dict:
    """The float32 operations one batched value-and-gradient needs per
    particle, from the shapes, an exp or a log counted as one. Per
    observation and component the log-density (residual, its scaling, the
    square and the constant: 5) and the weight's log added (1); the
    log-sum-exp of the two (max, difference, exp, log1p, add: 5) and the
    sum (1); the gradient: the two responsibilities (exp and its
    complement, 2) and per component the residual terms of the mean and
    the scale (5 each) and their sums (3 each). The priors, the
    transforms and their gradients: about 40 per particle."""
    per_point = 2 * (5 + 1) + 5 + 1 + 2 + 2 * (5 + 3)
    return {"bf16": 0.0, "fp32": float((per_point * n + 40) * chains)}
