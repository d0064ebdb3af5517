"""Models written once for each package, for the PyTorch parity tests.

Each ``*_pair`` returns ``(jax_staged, torch_staged)`` built from the same
numpy data, so a test can push the same inputs through both. The JAX side
uses the bench models where they exist (``bench.py``); the torch side takes
``chip_smoke.py``'s models where it has them, so the card runs the model the
tests check.
"""

import numpy as np
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from chip_smoke import (densemass_model, eight_schools_model, group_plate_model,
                        hierarchical_model, logistic_model, plate_model)


def torch_eight_schools():
    return eight_schools_model("cpu", torch.float64)


def eight_schools_pair():
    import bench

    return ft.stage(bench.eight_schools_model), ftt.stage(torch_eight_schools(), device="cpu")


def torch_hierarchical():
    return hierarchical_model("cpu", torch.float64)


def hierarchical_pair():
    import bench

    return ft.stage(bench.hierarchical_model), ftt.stage(torch_hierarchical(), device="cpu")


def plate_data(n, seed=5):
    return np.random.default_rng(seed).normal(1.5, 2.0, n)


def plate_pair(n):
    """mu ~ N(0, 10), sigma ~ LogNormal(0, 1), factor(pnormal_loglik_sum)."""
    import jax.numpy as jnp
    from fugue_tpu.ops.pallas_kernels import pnormal_loglik_sum as jax_pnormal

    y_np = plate_data(n)
    y_j = jnp.asarray(y_np)
    y_t = torch.as_tensor(y_np)

    def jax_plate():
        mu = ft.sample("mu", ft.Normal(0.0, 10.0))
        sigma = ft.sample("sigma", ft.LogNormal(0.0, 1.0))
        ft.factor(jax_pnormal(y_j, mu, sigma))

    return ft.stage(jax_plate), ftt.stage(plate_model(y_t), device="cpu")


# bench.py's scale rows. Their models are closures inside the bench
# functions (bench_scale_*), so the JAX side is written here after them, at
# whatever width the data has; the torch side is chip_smoke.py's.


def jax_logistic(d):
    """bench._logistic_setup's (and bench_scale_chees's) model."""
    from fugue_tpu.ops import matmul_bf16x2_fastgrad

    def model(xd, yd):
        w = ft.sample("w", ft.Normal(0.0, 1.0), sample_shape=(d,))
        ft.observe("y", ft.BernoulliLogits(matmul_bf16x2_fastgrad(xd, w)), yd)

    return model


def logistic_pair(x, y):
    """The logistic model on bf16-representable ``x`` (N, D) and bool
    ``y`` (N,), numpy: the design bf16 in both packages."""
    import jax.numpy as jnp

    xt = torch.as_tensor(x).to(torch.bfloat16)
    return (ft.stage(jax_logistic(x.shape[1]), jnp.asarray(x, jnp.bfloat16), jnp.asarray(y)),
            ftt.stage(logistic_model(xt, torch.as_tensor(y)), device="cpu"))


def jax_densemass(tril):
    """bench_scale_densemass's model: w ~ MVN(0, scale_tril), y ~ N(X w, 1)."""
    import jax.numpy as jnp

    tril = jnp.asarray(tril)
    d = tril.shape[0]

    def model(xd, yd):
        w = ft.sample("w", ft.MultivariateNormal(jnp.zeros(d), scale_tril=tril))
        ft.observe("y", ft.Normal(xd @ w, 1.0), yd)

    return model


def densemass_pair(x, y, tril):
    """The dense-mass row's model on float64 numpy data."""
    import jax.numpy as jnp

    t = [torch.as_tensor(a) for a in (x, y, tril)]
    return (ft.stage(jax_densemass(tril), jnp.asarray(x), jnp.asarray(y)),
            ftt.stage(densemass_model(*t), device="cpu"))


def jax_group_plate(groups):
    """bench_scale_plate's model: mu, theta (groups,), one observe of Y."""

    def model(yd):
        mu = ft.sample("mu", ft.Normal(0.0, 1.0))
        theta = ft.sample("theta", ft.Normal(mu, 1.0), sample_shape=(groups,))
        ft.observe("Y", ft.Normal(theta[:, None], 1.0), yd)

    return model


def group_plate_pair(y):
    """The group plate on float64 numpy ``y`` (groups, rows)."""
    import jax.numpy as jnp

    return (ft.stage(jax_group_plate(y.shape[0]), jnp.asarray(y)),
            ftt.stage(group_plate_model(torch.as_tensor(y)), device="cpu"))
