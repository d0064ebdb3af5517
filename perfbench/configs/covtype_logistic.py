"""covtype_logistic: Bayesian logistic regression at the UCI Covertype shape.

NumPyro's ``examples/covtype.py``, the large-data HMC benchmark of Phan et
al. 2019 (arXiv:1912.11554): coefs ~ N(0, I_55), y ~ BernoulliLogits(X
coefs), X the dataset's 54 standardised features plus an intercept column,
N = 581,012 rows, the label "the most frequent cover type or not".

The real file is not in the repository, so the data is generated at the
dataset's layout, once, from the configuration's own ``DATA_SEED``: like
the real file it is one dataset, the same in every run, and the run's seed
moves the chains, the MAP and every draw of the drive. The layout: 10 correlated Gaussian columns (the
quantitative features), a 4-way one-hot (wilderness area) and a 40-way
one-hot with skewed frequencies (soil type), every column standardised as
the example does, then the intercept. As in the real data, each one-hot
block sums to one, so the standardised block has one direction that only
the prior pins down. X is served in bf16 and the linear predictor goes
through the port's split-bf16 product (``ops.linalg.matmul_bf16x2_fastgrad``);
everything else is float32. Nothing is cut: ``reduced`` is empty.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

NAME = "covtype_logistic"
SOURCE = "https://github.com/pyro-ppl/numpyro/blob/master/examples/covtype.py"
DTYPE = "float32"
ROWS = 581_012
DATA_SEED = 581_012
FEATURES = 55  # 54 standardised columns + intercept
QUANTITATIVE = 10
REDUCED: list = []
ASSUMED = {
    # the real data's shares of the four wilderness areas (Rawah, Neota,
    # Comanche Peak, Cache la Poudre), rounded
    "wilderness_freq": [0.449, 0.052, 0.436, 0.063],
    # soil types: Zipf frequencies p_k ~ (k + 1)^-1.2 over the 40 types
    "soil_zipf_exponent": 1.2,
    # the quantitative columns: unit Gaussians with correlation 0.4^|i-j|
    "quantitative_corr": 0.4,
    # the generating coefficients: N(0, 0.2^2) each, intercept 0, which
    # gives a linear predictor of sd about 1.5 (the real task's ~75% accuracy)
    "w_true_sd": 0.2,
}


def soil_freq() -> torch.Tensor:
    k = torch.arange(40, dtype=torch.float64)
    p = (k + 1.0) ** -ASSUMED["soil_zipf_exponent"]
    return p / p.sum()


def make_data(seed: int, device, rows: int = ROWS):
    """(X (rows, 55) bf16, y (rows,) bool, w_true (55,) float32) on
    ``device``, from a generator on the device seeded with ``seed``, in a few
    large calls. Columns: 10 quantitative, 4 wilderness, 40 soil, intercept."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    q = QUANTITATIVE
    r = ASSUMED["quantitative_corr"]
    idx = torch.arange(q, dtype=torch.float64)
    corr = r ** (idx[:, None] - idx[None, :]).abs()
    chol = torch.linalg.cholesky(corr).to(device=device, dtype=torch.float32)
    quant = torch.randn((rows, q), generator=g, device=device) @ chol.T
    wild_p = torch.tensor(ASSUMED["wilderness_freq"], dtype=torch.float32, device=device)
    soil_p = soil_freq().to(device=device, dtype=torch.float32)
    wild = torch.multinomial(wild_p, rows, replacement=True, generator=g)
    soil = torch.multinomial(soil_p, rows, replacement=True, generator=g)
    raw = torch.cat([quant,
                     torch.nn.functional.one_hot(wild, 4).to(torch.float32),
                     torch.nn.functional.one_hot(soil, 40).to(torch.float32)], dim=1)
    raw = raw.double()
    std = raw.std(dim=0, correction=0)
    feats = ((raw - raw.mean(dim=0)) / torch.where(std > 0, std, torch.ones_like(std)))
    x = torch.cat([feats.to(torch.float32),
                   torch.ones((rows, 1), dtype=torch.float32, device=device)], dim=1)
    x = x.to(torch.bfloat16)
    w_true = torch.randn(FEATURES, generator=g, device=device) * ASSUMED["w_true_sd"]
    w_true[-1] = 0.0
    logits = x.float() @ w_true
    y = torch.rand(rows, generator=g, device=device) < torch.sigmoid(logits)
    return x, y, w_true


def build(seed: int, device, rows: int = ROWS):
    """The problem as served: the model in the port's language over the
    dataset (``DATA_SEED``; ``seed`` moves only the chains), and the data
    the reference reads."""
    import fugue_tpu_torch as ftt
    from fugue_tpu_torch.ops.linalg import matmul_bf16x2_fastgrad

    x, y, _ = make_data(DATA_SEED, device, rows)
    zeros = torch.zeros(FEATURES, dtype=torch.float32, device=device)

    def covtype():
        coefs = ftt.sample("coefs", ftt.Normal(zeros, 1.0))
        ftt.observe("obs", ftt.BernoulliLogits(matmul_bf16x2_fastgrad(x, coefs)), y)

    return SimpleNamespace(model_fn=covtype, data={"x": x, "y": y}, dim=FEATURES,
                           rows=rows, map_init=True)


def flops_per_grad(chains: int, rows: int = ROWS) -> dict:
    """The operations one batched value-and-gradient needs, from the shapes,
    whatever the implementation: the forward product X·w and the gradient
    product Xᵀ·r with bf16 inputs, 2·N·D·C each (the served product splits
    the coefficients into two bf16 passes; that is how it is built, not
    what the math needs, so the count leaves it out), and in float32 per (row,
    chain) the log-likelihood and its cotangent (8: a product with y, the
    softplus as exp and log1p, a subtraction, the sum; the sigmoid as exp
    and a division, a subtraction) and per (coefficient, chain) the prior
    and its gradient (4)."""
    n, d, c = rows, FEATURES, chains
    return {"bf16": 4.0 * n * d * c, "fp32": 8.0 * n * c + 4.0 * d * c}


def product_cost(chains: int, rows: int = ROWS) -> dict:
    """Operations and bytes of the bf16 products of one batched gradient,
    each input read once and each output written once: the forward reads
    X (bf16) and the (D, C) float32 coefficients and writes the (N, C)
    float32 logits; the gradient product reads X and the (N, C) bf16
    cotangent and writes (D, C) float32. The operations are the math's,
    2·N·D·C for each product (``flops_per_grad``)."""
    n, d, c = rows, FEATURES, chains
    fwd = 2 * n * d + 4 * d * c + 4 * n * c
    bwd = 2 * n * d + 2 * n * c + 4 * d * c
    return {"flops": 4.0 * n * d * c, "bytes": float(fwd + bwd)}

