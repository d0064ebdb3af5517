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
from chip_smoke import eight_schools_model, hierarchical_model, plate_model


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
