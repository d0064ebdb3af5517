"""eight_schools_nc: posteriordb's eight_schools-eight_schools_noncentered.

Rubin (1981); Gelman et al., BDA §5.5. The non-centred form: mu ~ N(0, 5),
tau ~ HalfCauchy(5), theta_raw ~ N(0, 1)^8, y ~ N(mu + tau·theta_raw,
sigma), with the published y and sigma, in float32. d = 10 unconstrained
coordinates: mu, log tau, theta_raw[0..7].

Departure from the repository's own copy (``chip_smoke.eight_schools_model``,
tau ~ LogNormal(0.5, 1)): this is posteriordb's published prior,
HalfCauchy(5), which the port has (``HalfCauchy``) and the DSL spells
``halfcauchy``. Nothing is cut: ``reduced`` is empty. The data is published;
the seed moves only the chains.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

NAME = "eight_schools_nc"
SOURCE = ("https://github.com/stan-dev/posteriordb/blob/master/posterior_database/"
          "posteriors/eight_schools-eight_schools_noncentered.json")
DTYPE = "float32"
Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
SCHOOLS = 8
DIM = 10
REDUCED: list = []
ASSUMED: dict = {}

# The same model in the DSL (``fugue_tpu_torch.dsl``), as a browser client
# of the JSON-RPC service sends it: 18 scalar sites, the same 10 coordinates
# in the same order.
DSL = """
let mu <- sample("mu", normal(0.0, 5.0));
let tau <- sample("tau", halfcauchy(5.0));
for j in 0..8 {
    let theta_raw <- sample(("theta_raw", j), normal(0.0, 1.0));
    observe(("y", j), normal(mu + tau * theta_raw, sigma[j]), y[j]);
}
return mu
"""
DSL_DATA = {"y": Y, "sigma": SIGMA}


def build(seed: int, device, **_):
    """The problem as served: the model in the port's language, the data on
    ``device`` in float32, and the data the reference reads."""
    import fugue_tpu_torch as ftt

    y = torch.tensor(Y, dtype=torch.float32, device=device)
    sigma = torch.tensor(SIGMA, dtype=torch.float32, device=device)

    def eight_schools_nc():
        mu = ftt.sample("mu", ftt.Normal(0.0, 5.0))
        tau = ftt.sample("tau", ftt.HalfCauchy(5.0))
        theta_raw = ftt.sample("theta_raw", ftt.Normal(0.0, 1.0), sample_shape=(SCHOOLS,))
        ftt.observe("y", ftt.Normal(mu + tau * theta_raw, sigma), y)
        return mu

    return SimpleNamespace(model_fn=eight_schools_nc, data={"y": Y, "sigma": SIGMA},
                           dim=DIM, map_init=False)


def flops_per_grad(chains: int, **_) -> dict:
    """The float32 operations one batched value-and-gradient needs per
    chain, from the shapes: per school the mean (2), the residual and its
    square over sigma² (4), the log-density's sum (2) and the gradient's
    three products and sums (6); the theta_raw prior and its gradient (3 per
    school); mu's prior and gradient (4); tau's exp, half-Cauchy log-density
    with its Jacobian and gradient (12)."""
    per_chain = SCHOOLS * (2 + 4 + 2 + 6 + 3) + 4 + 12
    return {"bf16": 0.0, "fp32": float(per_chain * chains)}

