"""The plain reference of covtype_logistic: its potential and gradient in
plain PyTorch at any precision, in blocks of rows, and the posterior's
moments in float64. Imports nothing of the program.

    U(w) = sum_k (w_k^2 / 2 + log(2 pi) / 2) + sum_i (softplus(l_i) - y_i l_i),
    l = X w,   dU/dw = w - X^T (y - sigmoid(l))

X is the benchmark's bf16 data, read exactly (every bf16 value is a
float64 value); nothing is taken from the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 65536  # rows per block: (BLOCK, S) logits in float64 take 64 MB at S = 128


def potential_and_grad(data, q, dtype=torch.float64, block: int = BLOCK):
    """(U (S,), dU/dq (S, D)) at the (S, D) positions ``q``, on the data's
    device, every operation (products, softplus, sums) in ``dtype``."""
    x, y = data["x"], data["y"]
    w = torch.as_tensor(q).to(device=x.device, dtype=dtype)
    s, d = w.shape
    u = torch.sum(0.5 * w * w, dim=1) + torch.tensor(0.5 * d * math.log(2.0 * math.pi),
                                                      dtype=dtype, device=x.device)
    g = w.clone()
    for lo in range(0, x.shape[0], block):
        xb = x[lo:lo + block].to(dtype)
        yb = y[lo:lo + block].to(dtype)
        lb = xb @ w.T  # (rows, S)
        u = u + torch.sum(torch.nn.functional.softplus(lb) - yb[:, None] * lb, dim=0)
        g = g - (xb.T @ (yb[:, None] - torch.sigmoid(lb))).T
    return u, g


def constrain(q, dtype=torch.float64):
    """The coefficients are unconstrained: the identity, in ``dtype``."""
    return torch.as_tensor(q).to(dtype)


def potential(data, q, block: int = BLOCK):
    """U at the (S, D) positions ``q`` in float64, no gradient."""
    x, y = data["x"], data["y"]
    w = torch.as_tensor(q).to(device=x.device, dtype=torch.float64)
    u = torch.sum(0.5 * w * w, dim=1) + 0.5 * w.shape[1] * math.log(2.0 * math.pi)
    for lo in range(0, x.shape[0], block):
        lb = x[lo:lo + block].double() @ w.T
        u = u + torch.sum(torch.nn.functional.softplus(lb)
                          - y[lo:lo + block].double()[:, None] * lb, dim=0)
    return u


def laplace(data, iters: int = 30, block: int = BLOCK):
    """(MAP (D,), inverse negative Hessian (D, D)) in float64: Newton's
    method from 0 with plain float64 products until a step moves no
    coefficient by 1e-12."""
    x, y = data["x"], data["y"]
    d = x.shape[1]
    dev = x.device
    w = torch.zeros(d, dtype=torch.float64, device=dev)
    eye = torch.eye(d, dtype=torch.float64, device=dev)

    def grad_hess(w):
        g = -w.clone()
        h = eye.clone()
        for lo in range(0, x.shape[0], block):
            xb = x[lo:lo + block].double()
            p = torch.sigmoid(xb @ w)
            g += xb.T @ (y[lo:lo + block].double() - p)
            h += (xb * (p * (1.0 - p))[:, None]).T @ xb
        return g, h

    for _ in range(iters):
        g, h = grad_hess(w)
        step = torch.linalg.solve(h, g)
        w = w + step
        if float(step.abs().max()) < 1e-12:
            break
    _, h = grad_hess(w)
    return w, torch.linalg.inv(h)


def posterior(data, draws: int = 1 << 18, scale: float = 1.2, seed: int = 0,
              chunk: int = 2048):
    """(mean (D,), variance (D,), the mean's own error variance (D,)) of
    the posterior in float64, by self-normalised importance sampling from
    the Laplace approximation with its covariance widened by ``scale``^2:
    ``draws`` proposals from a fixed CPU generator, each weighted by
    exp(-U) over the proposal's density; the error variance by the delta
    method, sum_k w_k^2 (theta_k - mean)^2. The Laplace mean alone is off
    by up to about 0.1 posterior sd here, more than a window's Monte Carlo
    error."""
    m, cov = laplace(data)
    chol = torch.linalg.cholesky(cov) * scale
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((draws, m.shape[0]), generator=g, dtype=torch.float64).to(m.device)
    theta = m + z @ chol.T
    u = torch.cat([potential(data, theta[i:i + chunk]) for i in range(0, draws, chunk)])
    log_w = -u + 0.5 * torch.sum(z * z, dim=1)
    w = torch.exp(log_w - log_w.max())
    w = w / w.sum()
    mean = torch.sum(w[:, None] * theta, dim=0)
    dev2 = (theta - mean) ** 2
    var = torch.sum(w[:, None] * dev2, dim=0)
    err = torch.sum((w * w)[:, None] * dev2, dim=0)
    return tuple(t.cpu().numpy().astype(np.float64) for t in (mean, var, err))
