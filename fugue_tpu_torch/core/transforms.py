"""Unconstraining bijectors for gradient-based kernels.

The port of ``fugue_tpu/core/transforms.py``. Each continuous support maps
to a bijector z ∈ R ↔ x ∈ support with ``forward(z) -> x``, ``inverse(x) ->
z`` and ``log_det_jacobian(z) -> log|dx/dz|`` (summed over the site's shape
by the caller). All run under ``torch.func`` transforms. log|J| of the
sigmoid family is taken through softplus and log-sigmoid, never as the log
of a forward value: in float32 σ(z) rounds to 0 or 1 for |z| above about
17, while the softplus forms stay finite, as do their gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .distributions import Support


class Transform:
    name = "identity"

    def forward(self, z):
        return z

    def inverse(self, x):
        return x

    def log_det_jacobian(self, z):
        return torch.zeros_like(z)

    def unconstrained_shape(self, shape):
        """Shape of the unconstrained z for a constrained site of ``shape``:
        the same, except for dimension-changing transforms (StickBreaking:
        k → k-1 along the last axis)."""
        return tuple(shape)


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


def _sigmoid_log_det(z):
    return -F.softplus(z) - F.softplus(-z)


class Sigmoid(Transform):
    """R → (0, 1): x = σ(z); log|dx/dz| = -softplus(z) - softplus(-z)."""

    name = "sigmoid"

    def forward(self, z):
        return torch.sigmoid(z)

    def inverse(self, x):
        return torch.log(x) - torch.log1p(-x)

    def log_det_jacobian(self, z):
        return _sigmoid_log_det(z)


class AffineSigmoid(Transform):
    """R → (low, high): x = low + (high - low)·σ(z).

    ``low`` and ``high`` may be Python floats, per-element tensors, or
    values of earlier sites (dependent bounds such as ``Uniform(0, a)``):
    ``ConstrainHandler`` rebuilds the transform from the runtime
    distribution at each replay, so the Jacobian uses the current bounds."""

    name = "affine_sigmoid"

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def forward(self, z):
        return self.low + (self.high - self.low) * torch.sigmoid(z)

    def inverse(self, x):
        u = (x - self.low) / (self.high - self.low)
        return torch.log(u) - torch.log1p(-u)

    def log_det_jacobian(self, z):
        width = self.high - self.low
        log_width = torch.log(width) if isinstance(width, torch.Tensor) else math.log(width)
        return log_width + _sigmoid_log_det(z)


class StickBreaking(Transform):
    """R^{k-1} → interior of the (k-1)-simplex (k components), along the
    last axis: the bijector of ``Dirichlet`` sites.

    Break fractions u_j = σ(z_j − log(k−1−j)) (the offset puts z = 0 at the
    uniform simplex), x_j = u_j · rem_j with rem_j = Π_{i<j}(1 − u_i), and
    the last component takes the remaining stick. log|J| = Σ_j log u_j +
    log(1 − u_j) + log rem_j, with the logs as log-sigmoids of z."""

    name = "stick_breaking"

    def __init__(self, k: int):
        self.k = int(k)

    def unconstrained_shape(self, shape):
        if not shape or shape[-1] != self.k:
            raise ValueError(
                f"stick-breaking expects trailing event axis {self.k}, got {shape}"
            )
        return tuple(shape[:-1]) + (self.k - 1,)

    def _offsets(self, like):
        return torch.log(torch.arange(self.k - 1, 0, -1, dtype=like.dtype, device=like.device))

    def forward(self, z):
        u = torch.sigmoid(z - self._offsets(z))
        ones = torch.ones_like(z[..., :1])
        rem = torch.cat([ones, torch.cumprod(1.0 - u, dim=-1)], dim=-1)
        return torch.cat([u * rem[..., :-1], rem[..., -1:]], dim=-1)

    def inverse(self, x):
        head = x[..., : self.k - 1]
        csum = torch.cumsum(head, dim=-1)
        rem = torch.cat([torch.ones_like(x[..., :1]), 1.0 - csum[..., :-1]], dim=-1)
        u = head / rem
        return torch.log(u) - torch.log1p(-u) + self._offsets(x)

    def log_det_jacobian(self, z):
        y = z - self._offsets(z)
        log_u = F.logsigmoid(y)
        log_1mu = F.logsigmoid(-y)
        log_rem = torch.cat(
            [torch.zeros_like(z[..., :1]), torch.cumsum(log_1mu[..., :-1], dim=-1)], dim=-1
        )
        return torch.sum(log_u + log_1mu + log_rem, dim=-1)


class Ordered(Transform):
    """R^k → increasing vectors of R^k, along the last axis: the bijector of
    ``distributions.Ordered`` sites, Stan's ``ordered``. x_1 = z_1,
    x_j = x_{j-1} + exp(z_j); log|J| = Σ_{j≥2} z_j (the Jacobian is
    triangular with diagonal 1, exp(z_2), ..., exp(z_k))."""

    name = "ordered"

    def __init__(self, k: int):
        self.k = int(k)

    def unconstrained_shape(self, shape):
        if not shape or shape[-1] != self.k:
            raise ValueError(f"ordered expects trailing event axis {self.k}, got {shape}")
        return tuple(shape)

    def forward(self, z):
        return torch.cat([z[..., :1], z[..., :1] + torch.cumsum(torch.exp(z[..., 1:]), dim=-1)],
                         dim=-1)

    def inverse(self, x):
        return torch.cat([x[..., :1], torch.log(x[..., 1:] - x[..., :-1])], dim=-1)

    def log_det_jacobian(self, z):
        return torch.sum(z[..., 1:], dim=-1)


def transform_for_support(support: Support) -> Transform:
    """The static, support-keyed transform. Distributions whose support
    depends on runtime parameters (``Uniform``) override
    ``Distribution.unconstraining_transform`` instead; an interval with
    bounds unknown statically falls back to Identity here, and discrete
    supports have no transform (Identity)."""
    if support.kind == "positive":
        return Exp()
    if support.kind == "unit":
        return Sigmoid()
    if support.kind == "interval":
        if support.low is not None and support.high is not None:
            return AffineSigmoid(support.low, support.high)
        return Identity()
    if support.kind == "simplex":
        return StickBreaking(support.size)
    if support.kind == "ordered":
        return Ordered(support.size)
    return Identity()
