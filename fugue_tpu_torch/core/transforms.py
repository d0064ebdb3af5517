"""Unconstraining bijectors for gradient-based kernels.

The port of ``Identity``, ``Exp`` and ``transform_for_support`` from
``fugue_tpu/core/transforms.py``. Each transform provides
``forward(z) -> x``, ``inverse(x) -> z`` and ``log_det_jacobian(z) ->
log|dx/dz|`` (summed over the site's shape by the caller). All are
elementwise and run under ``torch.func`` transforms. The sigmoid, affine
sigmoid and stick-breaking transforms wait for the distributions that need
them.
"""

from __future__ import annotations

import torch

from ..errors import ErrorCode, StagingError
from .distributions import Support


class Transform:
    name = "identity"

    def forward(self, z):
        return z

    def inverse(self, x):
        return x

    def log_det_jacobian(self, z):
        return torch.zeros_like(z)


class Identity(Transform):
    pass


class Exp(Transform):
    """R → (0, ∞): x = exp(z); log|dx/dz| = z."""

    name = "exp"

    def forward(self, z):
        return torch.exp(z)

    def inverse(self, x):
        return torch.log(x)

    def log_det_jacobian(self, z):
        return z


def transform_for_support(support: Support) -> Transform:
    """Pick the unconstraining transform for a continuous support."""
    if support.kind == "real":
        return Identity()
    if support.kind == "positive":
        return Exp()
    raise StagingError(
        ErrorCode.NOT_STAGEABLE,
        f"no transform for support {support.kind!r} in the PyTorch port yet",
        {"support": support.kind},
    )
