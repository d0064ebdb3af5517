"""The plain reference of gmm_mixture: its potential, gradient and
constraining map in plain PyTorch at any precision, and the posterior's
moments and log evidence by importance sampling, in float64. Imports
nothing of the program and no kernel; TF32 is off.

Unconstrained coordinates q = (a, b, s_1, s_2, t): mu_1 = a,
mu_2 = a + exp(b), sigma_k = exp(s_k), theta = sigmoid(t).

    log p = log 2 + log N(mu_1; 0, 2) + log N(mu_2; 0, 2) + b
            + sum_k [log HalfNormal(sigma_k; 2) + s_k]
            + log Beta(theta; 5, 5) + log theta + log(1 - theta)
            + sum_n log(theta N(y_n; mu_1, sigma_1) + (1 - theta) N(y_n; mu_2, sigma_2))

and U = -log p, with every normalising constant (log 2 = log 2! of the
ordered pair), so that exp(-U) integrates to the model's evidence Z.

The posterior (``posterior``) is computed without SMC and without the
program: the mode by damped Newton steps, the Laplace covariance there,
and self-normalised importance sampling from a Student-t (4 degrees of
freedom) centred at the mode with that covariance, in blocks, each block
an estimate of its own, so that the spread of the blocks gives the
estimates' Monte Carlo error.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
LOG_BETA_5_5 = 2.0 * math.lgamma(5.0) - math.lgamma(10.0)
DOF = 4.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _parts(y, q):
    a, b, s1, s2, t = (q[:, j:j + 1] for j in range(5))  # each (S, 1)
    gap, sig1, sig2 = torch.exp(b), torch.exp(s1), torch.exp(s2)
    mu1, mu2 = a, a + gap
    theta = torch.sigmoid(t)
    log_theta, log_1m = -F.softplus(-t), -F.softplus(t)
    r1, r2 = (y - mu1) / sig1, (y - mu2) / sig2  # (S, N)
    l1 = log_theta - 0.5 * r1 * r1 - s1 - HALF_LOG_2PI
    l2 = log_1m - 0.5 * r2 * r2 - s2 - HALF_LOG_2PI
    lse = torch.logaddexp(l1, l2)
    log_prior = (math.log(2.0)
                 - 0.5 * (mu1 / 2.0) ** 2 - math.log(2.0) - HALF_LOG_2PI
                 - 0.5 * (mu2 / 2.0) ** 2 - math.log(2.0) - HALF_LOG_2PI + b
                 + 2.0 * (0.5 * math.log(2.0 / math.pi) - math.log(2.0))
                 - (sig1 * sig1 + sig2 * sig2) / 8.0 + s1 + s2
                 + 5.0 * log_theta + 5.0 * log_1m - LOG_BETA_5_5)
    return SimpleNamespace(gap=gap, sig1=sig1, sig2=sig2, mu1=mu1, mu2=mu2, theta=theta,
                           r1=r1, r2=r2, l1=l1, l2=l2, lse=lse, log_prior=log_prior)


def log_density(data, q, dtype=torch.float64):
    """log p (S,) at the (S, 5) positions ``q``, every operation in ``dtype``."""
    q = torch.as_tensor(q).to(dtype)
    y = torch.as_tensor(data["y"]).to(dtype=dtype, device=q.device)
    p = _parts(y, q)
    return p.log_prior[:, 0] + torch.sum(p.lse, dim=1)


def potential_and_grad(data, q, dtype=torch.float64):
    """(U (S,), dU/dq (S, 5)) at the (S, 5) positions ``q``, every
    operation in ``dtype``; analytic gradient."""
    _no_tf32()
    q = torch.as_tensor(q).to(dtype)
    y = torch.as_tensor(data["y"]).to(dtype=dtype, device=q.device)
    p = _parts(y, q)
    log_p = p.log_prior[:, 0] + torch.sum(p.lse, dim=1)
    w1 = torch.exp(p.l1 - p.lse)  # responsibilities of the first component
    w2 = torch.exp(p.l2 - p.lse)
    d_mu1 = torch.sum(w1 * p.r1, dim=1, keepdim=True) / p.sig1 - p.mu1 / 4.0
    d_mu2 = torch.sum(w2 * p.r2, dim=1, keepdim=True) / p.sig2 - p.mu2 / 4.0
    d_s1 = torch.sum(w1 * (p.r1 * p.r1 - 1.0), dim=1, keepdim=True) - p.sig1 * p.sig1 / 4.0 + 1.0
    d_s2 = torch.sum(w2 * (p.r2 * p.r2 - 1.0), dim=1, keepdim=True) - p.sig2 * p.sig2 / 4.0 + 1.0
    d_t = torch.sum(w1 - p.theta, dim=1, keepdim=True) + 5.0 - 10.0 * p.theta
    grad = torch.cat([d_mu1 + d_mu2, p.gap * d_mu2 + 1.0, d_s1, d_s2, d_t], dim=1)
    return -log_p, -grad


def constrain(q, dtype=torch.float64):
    """(S, 5) unconstrained → (S, 5) constrained (mu_1, mu_2, sigma_1,
    sigma_2, theta)."""
    q = torch.as_tensor(q).to(dtype)
    return torch.cat([q[:, :1], q[:, :1] + torch.exp(q[:, 1:2]), torch.exp(q[:, 2:4]),
                      torch.sigmoid(q[:, 4:5])], dim=1)


def mode(data, iterations: int = 60):
    """(the posterior mode q* (5,), the Hessian of U there (5, 5)) in
    float64 on the CPU: damped Newton steps from the data's quartiles, the
    Hessian by central differences of the analytic gradient."""
    y = torch.as_tensor(data["y"], dtype=torch.float64)
    lo, hi = torch.quantile(y, 0.25).item(), torch.quantile(y, 0.75).item()
    q = torch.tensor([lo, math.log(max(hi - lo, 1e-3)), 0.0, 0.0, 0.0], dtype=torch.float64)

    def u_and_g(x):
        u, g = potential_and_grad(data, x[None, :])
        return u[0], g[0]

    def hessian(x, h=1e-5):
        cols = []
        for j in range(5):
            e = torch.zeros(5, dtype=torch.float64)
            e[j] = h
            cols.append((u_and_g(x + e)[1] - u_and_g(x - e)[1]) / (2.0 * h))
        hm = torch.stack(cols, dim=1)
        return 0.5 * (hm + hm.T)

    u, g = u_and_g(q)
    for _ in range(iterations):
        hm = hessian(q)
        evals, evecs = torch.linalg.eigh(hm)
        step = -(evecs @ ((evecs.T @ g) / torch.clamp(torch.abs(evals), min=1e-3)))
        scale = 1.0
        while scale > 1e-6:
            q_new = q + scale * step
            u_new, g_new = u_and_g(q_new)
            if torch.isfinite(u_new) and u_new <= u:
                break
            scale *= 0.5
        else:
            break
        converged = float(u - u_new) < 1e-12 and float(torch.max(torch.abs(g_new))) < 1e-8
        q, u, g = q_new, u_new, g_new
        if converged:
            break
    return q, hessian(q)


def posterior(data, draws: int = 1 << 22, blocks: int = 64, seed: int = 0, device="cpu"):
    """The posterior's moments and log evidence by self-normalised
    importance sampling, in float64: ``draws`` draws of a Student-t at the
    mode with the Laplace covariance, in ``blocks`` equal blocks.

    A dict: ``mean`` and ``var`` (5,) of (mu_1, mu_2, sigma_1, sigma_2,
    theta), ``mean_err_var`` (5,) the squared Monte Carlo error of the
    mean (the blocks' spread over their number), ``log_z`` and
    ``log_z_err_var`` the same for log Z, ``ess`` the importance sample's
    effective size."""
    _no_tf32()
    q0, hm = mode(data)
    cov = torch.linalg.inv(hm)
    chol = torch.linalg.cholesky(0.5 * (cov + cov.T))
    q0, chol = q0.to(device), chol.to(device)
    data = {"y": torch.as_tensor(data["y"], dtype=torch.float64).to(device)}
    d = 5
    log_det = float(torch.sum(torch.log(torch.diagonal(chol))))
    log_norm = (math.lgamma(0.5 * (DOF + d)) - math.lgamma(0.5 * DOF)
                - 0.5 * d * math.log(DOF * math.pi) - log_det)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    per = draws // blocks
    lse_b, m1_b, m2_b, lse2_b = [], [], [], []
    for _ in range(blocks):
        g = torch.randn((per, d), generator=gen, dtype=torch.float64, device=device)
        chi2 = 2.0 * torch._standard_gamma(
            torch.full((per,), 0.5 * DOF, dtype=torch.float64, device=device), generator=gen)
        x = q0 + (g @ chol.T) * torch.sqrt(DOF / chi2)[:, None]
        maha = torch.sum(g * g, dim=1) * (DOF / chi2)
        log_q = log_norm - 0.5 * (DOF + d) * torch.log1p(maha / DOF)
        log_w = log_density(data, x) - log_q
        lse = torch.logsumexp(log_w, dim=0)
        w = torch.exp(log_w - lse)
        c = constrain(x)
        lse_b.append(lse)
        lse2_b.append(torch.logsumexp(2.0 * log_w, dim=0))
        m1_b.append(w @ c)
        m2_b.append(w @ (c * c))
    lse_b, lse2_b = torch.stack(lse_b), torch.stack(lse2_b)
    m1_b, m2_b = torch.stack(m1_b), torch.stack(m2_b)
    log_z_b = lse_b - math.log(per)
    lse_all = torch.logsumexp(lse_b, dim=0)
    share = torch.exp(lse_b - lse_all)  # each block's share of the total weight
    mean = share @ m1_b
    var = share @ m2_b - mean * mean
    ess = float(torch.exp(2.0 * lse_all - torch.logsumexp(lse2_b, dim=0)))
    return {"mean": mean.cpu(), "var": var.cpu(),
            "mean_err_var": (torch.var(m1_b, dim=0) / blocks).cpu(),
            "log_z": float(lse_all - math.log(per * blocks)),
            "log_z_err_var": float(torch.var(log_z_b) / blocks),
            "ess": ess}
