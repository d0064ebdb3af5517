"""Mean-field and full-rank variational inference with pathwise gradients.

The port of ``fugue_tpu/inference/vi.py``. Support-matched families
(Real → Normal, Positive → LogNormal, Unit and static intervals → Beta),
the unconstrained diagonal guide for sites with no factorized family
(dependent bounds, simplex sites), the full-rank guide, the MC ELBO and
its analytic-entropy form, and the drive: Adam or SGD with optax's update
rules and schedules, the clamps after every step, and the ELBO-plateau
stop checked at the end of every ``check_every`` chunk.

The drive keeps each guide's parameters in ONE flat tensor: the
optimizer, the clamp and the guide's draws are a few launches per
iteration, not a few per site, and ``VIResult.params`` is the JAX
package's nested ``{address: {loc, raw_scale | raw_a, raw_b}}`` (or
``{loc, raw_scale}``, ``{loc, raw_tril}``) layout as views of it. One
iteration is one batched model run: ``torch.func.vmap`` of the log joint
over the n_samples draws, and one gradient with respect to the flat
parameters. The loop reads nothing from the device but one bool per chunk
when the plateau test can fire; the ELBO history stays on the device until
the end.

Random inputs come from a draws object (``GeneratorDraws`` by default):
per iteration the family groups' standard normals, the Beta sites' two
standard gammas, or the unconstrained and full-rank guides' normals. A
test hands the drive another object and replays the JAX key schedule. The
Beta sites' gammas carry the implicit reparameterization gradient
``torch._standard_gamma_grad``, which is not JAX's ``random_gamma_grad``:
the two differ by up to about 3e-4 relative.

``mesh=`` runs the optimization over the ranks of a ``DeviceMesh``
(``parallel.sharded.sharded_vi``): each rank's loss is its share of the
negative ELBO, and its gradient and value are summed over the ranks after
the backward pass and before the optimizer step, so every rank applies the
same update and the parameters stay the same on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from .. import settings
from ..core.numerics import log_beta
from ..errors import ErrorCode, FugueError
from ..parallel.mesh import cross_sum
from ..runtime.staging import StagedModel, stage


class GuideError(FugueError):
    """Unsupported guide construction (discrete latents)."""


_LOG_2PI = math.log(2 * math.pi)


def _softplus(x):
    """log(1 + exp(x)) as ``logaddexp(x, 0)``, the JAX package's form."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _inv_softplus(y: float) -> float:
    return y if y > 20.0 else math.log(math.expm1(min(y, 20.0)))


class _StandardGammaRsample(torch.autograd.Function):
    """Standard Gamma(alpha) draws ``g``, given, with the implicit
    reparameterization gradient dg/dalpha."""

    @staticmethod
    def forward(ctx, alpha, g):
        ctx.save_for_backward(alpha, g)
        return g.view_as(g)

    @staticmethod
    def backward(ctx, grad):
        alpha, g = ctx.saved_tensors
        return grad * torch._standard_gamma_grad(alpha, g), None


def _gamma_rsample(alpha, g):
    return _StandardGammaRsample.apply(alpha, g.detach())


# ---------------------------------------------------------------------------
# Variational families
# ---------------------------------------------------------------------------


class Family:
    """One mean-field factor over a site: unconstrained parameters, a
    reparameterized ``sample``, ``log_prob`` and ``entropy``, and the
    parameters' clamps (``bounds``)."""

    def init(self, shape, *, device="cuda"):
        raise NotImplementedError

    def bounds(self):
        """{name: (low, high)} of the clamp applied after every step."""
        return {}

    def clamp(self, params):
        b = self.bounds()
        return {k: torch.clamp(v, *b[k]) if k in b else v for k, v in params.items()}

    def sample(self, generator, params, shape):
        raise NotImplementedError

    def log_prob(self, params, x):
        raise NotImplementedError

    def entropy(self, params):
        raise NotImplementedError


class NormalFamily(Family):
    """Real support: N(loc, softplus(raw_scale))."""

    def init(self, shape, loc=0.0, scale=1.0, *, device="cuda"):
        dt = settings.real_dtype()
        return {"loc": torch.full(shape, loc, dtype=dt, device=device),
                "raw_scale": torch.full(shape, _inv_softplus(scale), dtype=dt, device=device)}

    def bounds(self):
        return {"loc": (-1e6, 1e6), "raw_scale": (_inv_softplus(1e-6), _inv_softplus(1e3))}

    def sample(self, generator, params, shape):
        eps = torch.randn(shape, generator=generator, device=generator.device,
                          dtype=params["loc"].dtype)
        return params["loc"] + _softplus(params["raw_scale"]) * eps

    def log_prob(self, params, x):
        s = _softplus(params["raw_scale"])
        z = (x - params["loc"]) / s
        return -0.5 * z * z - torch.log(s) - 0.5 * _LOG_2PI

    def entropy(self, params):
        s = _softplus(params["raw_scale"])
        return torch.sum(0.5 * (1.0 + _LOG_2PI) + torch.log(s))


class LogNormalFamily(NormalFamily):
    """Positive support: LogNormal(loc, softplus(raw_scale))."""

    def bounds(self):
        return {"loc": (-30.0, 30.0), "raw_scale": (_inv_softplus(1e-6), _inv_softplus(50.0))}

    def sample(self, generator, params, shape):
        return torch.exp(super().sample(generator, params, shape))

    def log_prob(self, params, x):
        s = _softplus(params["raw_scale"])
        lx = torch.log(x)
        z = (lx - params["loc"]) / s
        return -lx - torch.log(s) - 0.5 * _LOG_2PI - 0.5 * z * z

    def entropy(self, params):
        s = _softplus(params["raw_scale"])
        return torch.sum(params["loc"] + 0.5 * (1.0 + _LOG_2PI) + torch.log(s))


class BetaFamily(Family):
    """Unit support: Beta(exp(raw_a), exp(raw_b)), drawn as G1 / (G1 + G2)
    from two standard gammas, clipped to [1e-6, 1 - 1e-6]."""

    def init(self, shape, a=1.0, b=1.0, *, device="cuda"):
        dt = settings.real_dtype()
        return {"raw_a": torch.full(shape, math.log(a), dtype=dt, device=device),
                "raw_b": torch.full(shape, math.log(b), dtype=dt, device=device)}

    def bounds(self):
        lo, hi = math.log(1e-3), math.log(1e4)
        return {"raw_a": (lo, hi), "raw_b": (lo, hi)}

    def sample(self, generator, params, shape):
        a = torch.exp(params["raw_a"]).expand(shape)
        b = torch.exp(params["raw_b"]).expand(shape)
        g1 = _gamma_rsample(a, torch._standard_gamma(a.detach().contiguous(), generator=generator))
        g2 = _gamma_rsample(b, torch._standard_gamma(b.detach().contiguous(), generator=generator))
        return torch.clamp(g1 / (g1 + g2), 1e-6, 1.0 - 1e-6)

    def log_prob(self, params, x):
        a = torch.exp(params["raw_a"])
        b = torch.exp(params["raw_b"])
        return (a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x) - log_beta(a, b)

    def entropy(self, params):
        a = torch.exp(params["raw_a"])
        b = torch.exp(params["raw_b"])
        h = (log_beta(a, b) - (a - 1) * torch.digamma(a) - (b - 1) * torch.digamma(b)
             + (a + b - 2) * torch.digamma(a + b))
        return torch.sum(h)


class _IntervalBetaFamily(BetaFamily):
    """A Beta warped affinely onto a static interval [low, high]."""

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def sample(self, generator, params, shape):
        return self.low + (self.high - self.low) * super().sample(generator, params, shape)

    def log_prob(self, params, x):
        u = (x - self.low) / (self.high - self.low)
        return super().log_prob(params, u) - math.log(self.high - self.low)

    def entropy(self, params):
        return super().entropy(params) + math.log(self.high - self.low) * params["raw_a"].numel()


def family_for_support(support) -> Family:
    """The support-matched family; other supports raise ``GuideError``."""
    if support.kind == "real":
        return NormalFamily()
    if support.kind == "positive":
        return LogNormalFamily()
    if support.kind == "unit":
        return BetaFamily()
    if support.kind == "interval" and support.low is not None:
        return _IntervalBetaFamily(support.low, support.high)
    raise GuideError(
        ErrorCode.NOT_STAGEABLE,
        f"no mean-field family for support {support.kind!r} "
        "(discrete latents are rejected; marginalize them or use MH/SMC)",
        {"support": support.kind},
    )


def _reject_discrete(staged: StagedModel, what: str) -> None:
    if staged.discrete_sites:
        raise GuideError(
            ErrorCode.NOT_STAGEABLE,
            f"model has discrete latent sites; {what} requires continuous latents",
            {"discrete": [s.address for s in staged.discrete_sites]},
        )


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


class GeneratorDraws:
    """The drive's random inputs, from one ``torch.Generator``, in run
    order. Per iteration the drive asks for ONE of:

    - ``meanfield(n, totals, dtype)``: ``{kind: (n, total)}`` standard
      normals for the "lognormal" and "normal" family groups (the kinds
      with sites, in that order), then, if the guide has Beta sites,
      ``gammas(a, b)``: standard Gamma(a) and Gamma(b) draws of a's and b's
      shape (n, total), given the concentrations;
    - ``normal(n, d, dtype)``: (n, d) standard normals, for the
      unconstrained and full-rank guides.

    A test hands the drive another object with these methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _randn(self, shape, dtype):
        return torch.randn(shape, generator=self.generator, device=self.generator.device,
                           dtype=dtype)

    def meanfield(self, n, totals, dtype):
        return {kind: self._randn((n, total), dtype) for kind, total in totals.items()}

    def gammas(self, a, b):
        return (torch._standard_gamma(a.contiguous(), generator=self.generator),
                torch._standard_gamma(b.contiguous(), generator=self.generator))

    def normal(self, n, d, dtype):
        return self._randn((n, d), dtype)


def _draws_for(seed, device):
    if isinstance(seed, (int, np.integer)):
        return GeneratorDraws(torch.Generator(device=device).manual_seed(int(seed)))
    return seed  # a draws object


# ---------------------------------------------------------------------------
# Guides over one flat parameter tensor
# ---------------------------------------------------------------------------


class _Block(NamedTuple):
    """One parameter's slice of a flat guide tensor, with its clamp."""

    key: Optional[str]  # the site address; None for a top-level parameter
    name: str
    start: int
    stop: int
    shape: Tuple[int, ...]
    low: float
    high: float


class _FlatGuide:
    """A guide whose parameters live in one flat tensor ``theta``.

    ``_layout`` lists its ``_Block``s. ``unflatten`` gives the nested
    parameter dict as views of theta, ``flatten`` the inverse (any array
    leaves, converted to the guide's dtype and device)."""

    def __init__(self, staged: StagedModel):
        self.staged = staged
        self.device = staged.device
        self._layout = []
        self.size = 0
        self._bounds_cache = {}

    def _add(self, key, name, n, shape, low, high):
        self._layout.append(_Block(key, name, self.size, self.size + n, tuple(shape), low, high))
        self.size += n

    def unflatten(self, theta) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for b in self._layout:
            v = theta[b.start:b.stop].view(b.shape)
            if b.key is None:
                out[b.name] = v
            else:
                out.setdefault(b.key, {})[b.name] = v
        return out

    def flatten(self, params) -> torch.Tensor:
        dt = settings.real_dtype()
        parts = []
        for b in self._layout:
            v = params[b.name] if b.key is None else params[b.key][b.name]
            if not isinstance(v, torch.Tensor):
                v = np.array(v)  # a writable copy (JAX arrays are read-only)
            v = torch.as_tensor(v, dtype=dt, device=self.device)
            if v.numel() != b.stop - b.start:
                raise ValueError(f"parameter {b.key}/{b.name} has {v.numel()} elements, "
                                 f"the guide {b.stop - b.start}")
            parts.append(v.reshape(-1))
        return torch.cat(parts)

    def init_params(self, **kw):
        return self.unflatten(self.init_flat(**kw))

    def _block_fill(self, value_of, dtype):
        """A flat tensor on the guide's device, each layout block filled
        with ``value_of(block)``: made there, with no host copy."""
        return torch.cat([torch.full((b.stop - b.start,), value_of(b), dtype=dtype,
                                     device=self.device) for b in self._layout])

    def _bounds(self, theta):
        """(low, high) tensors of theta's shape, one clamp for all sites."""
        if theta.dtype not in self._bounds_cache:
            self._bounds_cache[theta.dtype] = (self._block_fill(lambda b: b.low, theta.dtype),
                                               self._block_fill(lambda b: b.high, theta.dtype))
        return self._bounds_cache[theta.dtype]

    def clamp_flat(self, theta):
        return torch.clamp(theta, *self._bounds(theta))

    def clamp(self, params):
        return self.unflatten(self.clamp_flat(self.flatten(params)))

    def entropy(self, params):
        return self._entropy_flat(self.flatten(params))


_GROUP_KINDS = ("lognormal", "normal")  # the JAX pack order: fold_in(key, 0), (key, 1)


class MeanFieldGuide(_FlatGuide):
    """Address-keyed mean-field guide over the continuous latents: one
    support-matched family per site. Sites of one family kind are packed:
    one draw of base noise per kind, sliced per site in address order.

    theta holds, per group (LogNormal sites, Normal sites, Beta sites), the
    group's first parameter for all its sites, then its second."""

    def __init__(self, staged: StagedModel):
        _reject_discrete(staged, "mean-field VI")
        super().__init__(staged)
        self.sites = staged.continuous_sites
        self.families: Dict[str, Family] = {
            s.address: family_for_support(s.support) for s in self.sites}
        groups = {"lognormal": [], "normal": [], "beta": []}
        for s in self.sites:
            fam = self.families[s.address]
            kind = ("lognormal" if isinstance(fam, LogNormalFamily) else
                    "normal" if isinstance(fam, NormalFamily) else "beta")
            groups[kind].append(s)
        self._groups = {}  # kind → (start, total, [(site, offset in group)])
        for kind in _GROUP_KINDS + ("beta",):
            sites = groups[kind]
            if not sites:
                continue
            total = sum(s.size for s in sites)
            start, members = self.size, []
            for j, name in enumerate(("loc", "raw_scale") if kind != "beta" else
                                     ("raw_a", "raw_b")):
                off = 0
                for s in sites:
                    b = self.families[s.address].bounds()[name]
                    self._add(s.address, name, s.size, s.shape, *b)
                    if j == 0:
                        members.append((s, off))
                    off += s.size
            self._groups[kind] = (start, total, members)
        self._interval_log_width = sum(
            math.log(f.high - f.low) * self.staged.site(a).size
            for a, f in self.families.items() if isinstance(f, _IntervalBetaFamily))

    def init_flat(self):
        # loc 0 and scale 1; log a = log b = 0
        return self._block_fill(lambda b: _inv_softplus(1.0) if b.name == "raw_scale" else 0.0,
                                settings.real_dtype())

    def _sample_flat(self, theta, draws, n: int) -> Dict[str, Any]:
        """n reparameterized draws of every site → {address: (n, *shape)}."""
        out: Dict[str, Any] = {}
        totals = {k: self._groups[k][1] for k in _GROUP_KINDS if k in self._groups}
        eps = draws.meanfield(n, totals, theta.dtype)  # called every iteration, even empty
        for kind, (start, total, members) in self._groups.items():
            first, second = theta[start:start + total], theta[start + total:start + 2 * total]
            if kind == "beta":
                a = torch.exp(first).expand(n, total)
                b = torch.exp(second).expand(n, total)
                ga, gb = draws.gammas(a.detach(), b.detach())
                g1, g2 = _gamma_rsample(a, ga), _gamma_rsample(b, gb)
                x = torch.clamp(g1 / (g1 + g2), 1e-6, 1.0 - 1e-6)
            else:
                x = first + _softplus(second) * eps[kind]
                if kind == "lognormal":
                    x = torch.exp(x)
            for s, off in members:
                v = x[:, off:off + s.size].reshape((n,) + tuple(s.shape))
                fam = self.families[s.address]
                if isinstance(fam, _IntervalBetaFamily):
                    v = fam.low + (fam.high - fam.low) * v
                out[s.address] = v
        return out

    def _entropy_flat(self, theta):
        total_h = torch.zeros((), dtype=theta.dtype, device=theta.device)
        for kind, (start, total, _) in self._groups.items():
            first, second = theta[start:start + total], theta[start + total:start + 2 * total]
            if kind == "beta":
                total_h = total_h + BetaFamily().entropy({"raw_a": first, "raw_b": second})
            else:
                fam = LogNormalFamily() if kind == "lognormal" else NormalFamily()
                total_h = total_h + fam.entropy({"loc": first, "raw_scale": second})
        return total_h + self._interval_log_width

    def sample_latents(self, draws, params, n: int = 1) -> Dict[str, Any]:
        """n draws of every site → {address: (n, *shape)}; ``draws`` is a
        draws object or an int seed."""
        return self._sample_flat(self.flatten(params), _draws_for(draws, self.device), n)

    def log_q(self, params, latents):
        """log q of ONE draw ``latents``, summed over sites."""
        total = torch.zeros((), dtype=settings.real_dtype(), device=self.device)
        for s in self.sites:
            total = total + torch.sum(
                self.families[s.address].log_prob(params[s.address], latents[s.address]))
        return total

    def sample_trace(self, draws, params):
        """One guide draw replayed through the model → its full Trace."""
        lat = {a: v[0] for a, v in self.sample_latents(draws, params, 1).items()}
        return self.staged.replay_trace(lat)


class _GaussianGuide(_FlatGuide):
    """A Gaussian guide on the staged model's unconstrained R^d; draws map
    back through the runtime support transforms."""

    def __init__(self, staged: StagedModel, what: str):
        _reject_discrete(staged, what)
        super().__init__(staged)
        self.d = staged.dim

    def _sample_z(self, theta, draws, n: int):
        raise NotImplementedError

    def sample_latents(self, draws, params, n: int = 1) -> Dict[str, Any]:
        z = self._sample_z(self.flatten(params), _draws_for(draws, self.device), n)
        return vmap(lambda zz: self.staged.constrain(zz)[0])(z)


class UnconstrainedMeanFieldGuide(_GaussianGuide):
    """q(z) = N(loc, diag(softplus(raw_scale)^2)) on unconstrained R^d: the
    mean-field fallback for sites with no factorized family (bounds that
    depend on other sites, simplex sites)."""

    def __init__(self, staged: StagedModel):
        super().__init__(staged, "VI")
        b = NormalFamily().bounds()
        self._add(None, "loc", self.d, (self.d,), *b["loc"])
        self._add(None, "raw_scale", self.d, (self.d,), *b["raw_scale"])

    def init_flat(self, scale: float = 0.5):
        return self._block_fill(lambda b: _inv_softplus(scale) if b.name == "raw_scale" else 0.0,
                                settings.real_dtype())

    def _sample_z(self, theta, draws, n: int):
        loc, raw = theta[:self.d], theta[self.d:]
        return loc + _softplus(raw) * draws.normal(n, self.d, theta.dtype)

    def _entropy_flat(self, theta):
        return torch.sum(0.5 * (1.0 + _LOG_2PI) + torch.log(_softplus(theta[self.d:])))


def _meanfield_guide_for(staged: StagedModel):
    """The constrained support-matched guide when every site has a family,
    else the unconstrained diagonal guide. Discrete sites always raise."""
    if staged.discrete_sites:
        return MeanFieldGuide(staged)
    try:
        return MeanFieldGuide(staged)
    except GuideError:
        return UnconstrainedMeanFieldGuide(staged)


class FullRankGuide(_GaussianGuide):
    """q(z) = N(loc, L L^T) on unconstrained R^d, L lower-triangular from
    ``raw_tril`` (row-major ``tril_indices`` order) with a softplus
    diagonal. The entropy is analytic."""

    def __init__(self, staged: StagedModel):
        super().__init__(staged, "full-rank VI")
        d = self.d
        self._rows, self._cols = torch.tril_indices(d, d, device=self.device)
        self._diag = self._rows == self._cols
        i = torch.arange(d, device=self.device)
        self._diag_pos = i * (i + 3) // 2  # (i, i) in row-major tril order
        self._add(None, "loc", d, (d,), -1e6, 1e6)
        self._add(None, "raw_tril", d * (d + 1) // 2, (d * (d + 1) // 2,), -1e3, 1e3)

    def init_flat(self, scale: float = 0.5):
        theta = torch.zeros(self.size, dtype=settings.real_dtype(), device=self.device)
        return theta.index_fill(0, self.d + self._diag_pos, _inv_softplus(scale))

    def _chol_flat(self, theta):
        raw = theta[self.d:]
        raw = torch.where(self._diag, _softplus(raw), raw)
        return raw.new_zeros(self.d, self.d).index_put((self._rows, self._cols), raw)

    def _chol(self, params):
        return self._chol_flat(self.flatten(params))

    def _sample_z(self, theta, draws, n: int):
        L = self._chol_flat(theta)
        return theta[:self.d] + draws.normal(n, self.d, theta.dtype) @ L.T

    def _entropy_flat(self, theta):
        diag = _softplus(theta[self.d:][self._diag_pos])
        return 0.5 * self.d * (1.0 + _LOG_2PI) + torch.sum(torch.log(diag))

    def covariance(self, params):
        L = self._chol(params)
        return L @ L.T


# ---------------------------------------------------------------------------
# ELBO
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VIConfig:
    n_iterations: int = 1000
    n_samples: int = 16  # MC samples per ELBO estimate
    learning_rate: float = 0.05
    decay: float = 0.0  # Robbins-Monro exponent; 0 → constant-rate SGD
    plateau_window: int = 100
    plateau_tol: float = 1e-4
    check_every: int = 50
    optimizer: str = "adam"  # "adam" | "sgd"


@dataclass
class VIResult:
    params: Dict[str, Any]  # nested views of one flat tensor
    elbo_history: np.ndarray
    converged: bool
    n_iterations_run: int
    guide: Any

    def final_elbo(self) -> float:
        return float(self.elbo_history[-1])

    def posterior_sample(self, seed: int, n: int = 1):
        """n guide draws → {address: (n, *shape)}."""
        return self.guide.sample_latents(seed, self.params, n)


def _log_joints(guide, latents):
    return vmap(guide.staged.log_joint)(latents)


def elbo(seed, guide: MeanFieldGuide, params, n_samples: int):
    """MC ELBO = E_q[log p(x, z) - log q(z)] over n_samples draws; ``seed``
    is an int or a draws object."""
    lat = guide.sample_latents(seed, params, n_samples)
    lq = vmap(lambda one: guide.log_q(params, one))(lat)
    return torch.mean(_log_joints(guide, lat) - lq)


def elbo_analytic_entropy(seed, guide: MeanFieldGuide, params, n_samples: int):
    """E_q[log p] + H(q), the entropy analytic: the optimization objective."""
    lat = guide.sample_latents(seed, params, n_samples)
    return torch.mean(_log_joints(guide, lat)) + guide.entropy(params)


def estimate_elbo(seed: int, model_fn=None, n_samples: int = 128, *, staged=None,
                  model_args: tuple = (), device="cuda") -> float:
    """ELBO of the initial (prior-scaled) mean-field guide: a model-fit
    sanity metric."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    guide = MeanFieldGuide(staged)
    return float(elbo(seed, guide, guide.init_params(), n_samples))


# ---------------------------------------------------------------------------
# Optimizers: optax's update rules on one flat tensor
# ---------------------------------------------------------------------------


class _Adam:
    """``optax.adam(schedule)``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    bias correction at count + 1, the schedule at the count before the
    update. The moments start at zero (and restart on resume)."""

    def __init__(self, schedule, b1=0.9, b2=0.999, eps=1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.count = 0
        self.mu = self.nu = None

    def step(self, theta, g):
        if self.mu is None:
            self.mu, self.nu = torch.zeros_like(g), torch.zeros_like(g)
        self.mu = (1 - self.b1) * g + self.b1 * self.mu
        self.nu = (1 - self.b2) * (g * g) + self.b2 * self.nu
        k = self.count + 1
        mu_hat = self.mu / (1 - self.b1 ** k)
        nu_hat = self.nu / (1 - self.b2 ** k)
        update = (-self.schedule(self.count)) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        self.count = k
        return theta + update


class _SGD:
    """``optax.sgd(schedule)``: theta - schedule(count) * g."""

    def __init__(self, schedule):
        self.schedule = schedule
        self.count = 0

    def step(self, theta, g):
        update = (-self.schedule(self.count)) * g
        self.count += 1
        return theta + update


def _optimizer(config: VIConfig):
    lr = config.learning_rate
    if config.optimizer == "adam":
        # the annealed rate: Adam's scale-free steps otherwise jitter at the
        # optimum
        t0 = max(config.n_iterations / 10.0, 1.0)
        return _Adam(lambda t: lr * (1.0 + t / t0) ** -0.6)
    if config.decay > 0:
        return _SGD(lambda t: lr * (t + 1.0) ** -config.decay)
    return _SGD(lambda t: lr)


# ---------------------------------------------------------------------------
# The drive
# ---------------------------------------------------------------------------


def _iteration(guide, loss_fn, opt, theta, draws, group=None):
    """One optimizer step: (clamped new theta, the ELBO at the old theta).
    With a process ``group`` the gradient and the loss are summed over the
    ranks (one all-reduce) after the backward pass, before the step."""
    th = theta.detach().requires_grad_(True)
    loss = loss_fn(th, draws)
    (g,) = torch.autograd.grad(loss, th)
    loss = loss.detach()
    if group is not None:
        packed = cross_sum(torch.cat([g, loss.reshape(1)]), group)
        g, loss = packed[:-1], packed[-1]
    with torch.no_grad():
        return guide.clamp_flat(opt.step(th.detach(), g)), -loss


def _drive(guide, loss_fn, config: VIConfig, theta, draws, group=None) -> VIResult:
    """``n_chunks = max(1, n_iterations // check_every)`` chunks of
    ``check_every`` iterations (an ``n_iterations`` below ``check_every``
    runs one whole chunk). After each chunk, when 2 * plateau_window fits in
    the history and has run, the means of the last two windows are compared
    (one bool read), and the run stops at the first chunk that plateaus.
    ``group``: the sharded drive (``_iteration``); the history is then the
    same on every rank, and so is the stop."""
    ce = config.check_every
    n_chunks = max(1, config.n_iterations // ce)
    hist_len = n_chunks * ce
    w = config.plateau_window
    plateau_on = 2 * w <= hist_len
    opt = _optimizer(config)
    hist = torch.zeros(hist_len, dtype=theta.dtype, device=theta.device)
    c, conv = 0, False
    while c < n_chunks and not conv:
        for i in range(ce):
            theta, elbo_i = _iteration(guide, loss_fn, opt, theta, draws, group)
            hist[c * ce + i] = elbo_i
        total = (c + 1) * ce
        if plateau_on and total >= 2 * w:
            recent = torch.mean(hist[total - w:total])
            prev = torch.mean(hist[total - 2 * w:total - w])
            rel = torch.abs(recent - prev) / torch.clamp(torch.abs(prev), min=1.0)
            conv = bool(rel < config.plateau_tol)  # the chunk's one host read
        c += 1
    n_done = c * ce
    return VIResult(params=guide.unflatten(theta), elbo_history=hist[:n_done].cpu().numpy(),
                    converged=conv, n_iterations_run=n_done, guide=guide)


def _start(guide, resume):
    """The initial flat parameters: the guide's init, or a previous result's
    parameters (a ``VIResult`` of either package, or its params)."""
    if resume is None:
        return guide.init_flat()
    params = getattr(resume, "params", resume)
    return guide.flatten(params)


def _loss(guide, n_samples):
    """The negative ELBO of n_samples draws, the entropy analytic: a
    function of (theta, draws). One batched model run."""
    if isinstance(guide, MeanFieldGuide):
        def loss(theta, draws):
            lat = guide._sample_flat(theta, draws, n_samples)
            return -(torch.mean(_log_joints(guide, lat)) + guide._entropy_flat(theta))
    else:  # unconstrained R^d: E_q[log p(x(z)) + log|J|] + H(q)
        def loss(theta, draws):
            z = guide._sample_z(theta, draws, n_samples)
            lp = vmap(guide.staged.log_joint_unconstrained)(z)
            return -(torch.mean(lp) + guide._entropy_flat(theta))
    return loss


def optimize_fullrank_vi(
    seed: int,
    model_fn: Optional[Callable] = None,
    config: VIConfig = VIConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    resume=None,
    device="cuda",
    draws=None,
    mesh=None,
    shard: str = "auto",
) -> VIResult:
    """Full-rank ADVI: pathwise gradients of E_q[log p(x(z)) + log|J|] +
    H(q), annealed Adam, clamps and the plateau stop.

    ``resume``: a previous ``VIResult`` (of this package or the JAX
    package) or its params; the run continues from those parameters with
    fresh Adam moments and schedule. ``draws`` replaces the generator seeded
    from ``seed`` (see ``GeneratorDraws``). ``mesh``: run over the mesh's
    ranks (``parallel.sharded.sharded_vi``, ``shard=`` its mode)."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    if mesh is not None:
        from ..parallel.sharded import sharded_vi

        return sharded_vi(seed, config=config, mesh=mesh, guide="fullrank", shard=shard,
                          staged=staged, resume=resume)
    guide = FullRankGuide(staged)
    draws = _draws_for(seed if draws is None else draws, staged.device)
    return _drive(guide, _loss(guide, config.n_samples), config, _start(guide, resume), draws)


def optimize_meanfield_vi(
    seed: int,
    model_fn: Optional[Callable] = None,
    config: VIConfig = VIConfig(),
    *,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    resume=None,
    device="cuda",
    draws=None,
    mesh=None,
    shard: str = "auto",
) -> VIResult:
    """Mean-field VI with pathwise gradients, Adam or Robbins-Monro SGD,
    clamps and the ELBO-plateau stop. Models with a site that has no
    factorized family take the unconstrained diagonal guide. ``resume``,
    ``draws``, ``mesh`` and ``shard`` as in ``optimize_fullrank_vi``."""
    if staged is None:
        staged = stage(model_fn, *model_args, device=device)
    if mesh is not None:
        from ..parallel.sharded import sharded_vi

        return sharded_vi(seed, config=config, mesh=mesh, guide="meanfield", shard=shard,
                          staged=staged, resume=resume)
    guide = _meanfield_guide_for(staged)
    draws = _draws_for(seed if draws is None else draws, staged.device)
    return _drive(guide, _loss(guide, config.n_samples), config, _start(guide, resume), draws)
