"""The plain reference of eight_schools_nc: its potential, gradient and
constraining map in plain PyTorch at any precision, and its posterior's
moments in float64 NumPy by quadrature. Imports nothing of the program.

Unconstrained coordinates q = (mu, s, t_0 .. t_7), tau = exp(s):

    log p = log N(mu; 0, 5) + log HalfCauchy(tau; 5) + s
            + sum_j log N(t_j; 0, 1) + sum_j log N(y_j; mu + tau t_j, sigma_j)

and U = -log p, with every normalising constant, as a served potential has.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def potential_and_grad(data, q, dtype=torch.float64):
    """(U (S,), dU/dq (S, 10)) at the (S, 10) positions ``q``, every
    operation in ``dtype``; analytic gradient."""
    q = torch.as_tensor(q).to(dtype)
    y = torch.tensor(data["y"], dtype=dtype, device=q.device)
    sig = torch.tensor(data["sigma"], dtype=dtype, device=q.device)
    mu, s, t = q[:, 0], q[:, 1], q[:, 2:]
    tau = torch.exp(s)
    resid = y - mu[:, None] - tau[:, None] * t  # (S, 8)
    log_p = (-0.5 * (mu / 5.0) ** 2 - math.log(5.0) - HALF_LOG_2PI
             + math.log(2.0 / math.pi) - math.log(5.0) - torch.log1p((tau / 5.0) ** 2) + s
             + torch.sum(-0.5 * t * t - HALF_LOG_2PI, dim=1)
             + torch.sum(-0.5 * (resid / sig) ** 2 - torch.log(sig) - HALF_LOG_2PI, dim=1))
    r = resid / (sig * sig)
    d_mu = -mu / 25.0 + torch.sum(r, dim=1)
    d_s = tau * (-2.0 * tau / (25.0 + tau * tau)) + 1.0 + tau * torch.sum(r * t, dim=1)
    d_t = -t + r * tau[:, None]
    grad = torch.cat([d_mu[:, None], d_s[:, None], d_t], dim=1)
    return -log_p, -grad


def constrain(q, dtype=torch.float64):
    """(S, 10) unconstrained → (S, 10) constrained (mu, tau, theta_raw)."""
    q = torch.as_tensor(q).to(dtype)
    return torch.cat([q[:, :1], torch.exp(q[:, 1:2]), q[:, 2:]], dim=1)


def posterior(data, n_mu: int = 1201, n_s: int = 1601):
    """(mean (10,), variance (10,), the mean's own error variance: 0) of
    the unconstrained coordinates under the posterior, in float64: theta
    is integrated out in closed form, y_j ~ N(mu, sqrt(sigma_j^2 +
    tau^2)), and (mu, s) summed on a grid;
    t_j given (mu, tau) is Gaussian with mean tau (y_j - mu) / (sigma_j^2 +
    tau^2) and variance sigma_j^2 / (sigma_j^2 + tau^2)."""
    y = np.asarray(data["y"], np.float64)
    sig = np.asarray(data["sigma"], np.float64)
    mu = np.linspace(-25.0, 35.0, n_mu)[:, None]
    s = np.linspace(-16.0, 6.0, n_s)[None, :]
    tau = np.exp(s)
    lp = -0.5 * (mu / 5.0) ** 2 - np.log1p((tau / 5.0) ** 2) + s
    for j in range(len(y)):
        v = sig[j] ** 2 + tau ** 2
        lp = lp - 0.5 * (y[j] - mu) ** 2 / v - 0.5 * np.log(v)
    w = np.exp(lp - lp.max())
    w /= w.sum()
    mean = np.empty(2 + len(y))
    var = np.empty(2 + len(y))
    mu_b = np.broadcast_to(mu, w.shape)
    s_b = np.broadcast_to(s, w.shape)
    mean[0], mean[1] = np.sum(w * mu_b), np.sum(w * s_b)
    var[0] = np.sum(w * mu_b ** 2) - mean[0] ** 2
    var[1] = np.sum(w * s_b ** 2) - mean[1] ** 2
    for j in range(len(y)):
        v = sig[j] ** 2 + tau ** 2
        m = tau * (y[j] - mu) / v
        cv = sig[j] ** 2 / v
        mean[2 + j] = np.sum(w * m)
        var[2 + j] = np.sum(w * (cv + m * m)) - mean[2 + j] ** 2
    return mean, var, np.zeros_like(mean)
