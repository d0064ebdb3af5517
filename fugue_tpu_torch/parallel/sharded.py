"""Sharded inference drivers: chains, particles and data across ranks.

The port of ``fugue_tpu/parallel/sharded.py``. JAX runs one SPMD program
over a ``Mesh`` with ``shard_map``; PyTorch runs one process per GPU, and
EVERY rank calls the same driver with the same arguments. Each rank runs
the single-device drive on its slice of the batch, and the drive's
adaptation statistics reduce over the mesh's process group
(``chain_group=`` of the engines; the vocabulary is in ``parallel.mesh``):

- HMC, NUTS, ChEES, Gibbs and PT: the acceptance mean, the initial step
  size's consensus exp(mean log ε₀), the midpoint's Welford merge and
  ChEES's criterion means are all-reduces, so ε, the mass and T are the
  same on every rank. The trees, trajectories and rescues stay on the rank;
- SMC: ``adaptive_smc(mesh=...)`` (gathered weight vectors, the particle
  ring);
- VI: the loss and its gradient are summed over the ranks after the
  backward pass and before the optimizer step;
- ESS and ABC: nothing adapts; ranks draw from folded seeds.

Randomness: a rank's stream is seeded from ``fold_seed(seed, salt,
flat_axis_index)``, as JAX folds the run key with the shard's flat index;
draws that must agree on every rank (the initial positions, which JAX draws
for every chain and splits; VI data mode's guide draws) come from an
unfolded seed on every rank.

Every driver returns the single-device driver's result dataclass with the
GLOBAL (n_chains, ...) tensors, gathered once at the end, on every rank;
replicated values (ε, the mass, T) are the same on every rank. ``mesh``
defaults to every rank of the default process group along the chain axis
(a one-rank group is made when there is none); ``chain_axes`` chooses the
mesh axes that split the batch (default: the chain axis when the mesh has
one, else every axis).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import settings
from ..core.rng import fold_seed
from ..runtime.staging import StagedModel, stage
from .mesh import ShardLayout, cross_mean, make_chain_mesh


def _layout(mesh, chain_axes, device) -> ShardLayout:
    if mesh is None:
        mesh = make_chain_mesh(device=device)
    return ShardLayout.of(mesh, chain_axes)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _staged(staged, model_fn, model_args, device) -> StagedModel:
    return staged if staged is not None else stage(model_fn, *model_args, device=device)


def _start(staged, config, shard: ShardLayout, seed: int, salt: int, n_chains: int):
    """(this rank's rows of the global initial positions, this rank's
    generator): every rank draws q0 for all chains from the unfolded seed."""
    from ..inference.hmc import initial_positions

    c = shard.split(n_chains)
    q0 = initial_positions(staged, _generator(staged.device, fold_seed(seed, salt, 0)),
                           n_chains, config.init)[shard.rows(c)]
    return q0, _generator(staged.device, fold_seed(seed, salt, 1, shard.seed_index))


def sharded_hmc_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config=None,
    *,
    n_chains: int = 8,
    mesh=None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
    device="cuda",
):
    """HMC with the chain batch split over the mesh's chain axes.

    ``n_chains`` is the GLOBAL chain count (it must divide by the number of
    ranks along ``chain_axes``). Every rank adapts the same ε and mass
    (``hmc.make_hmc_drive(chain_group=...)``) and returns the same
    ``HMCResult`` with global (n_chains, ...) tensors."""
    from ..inference.hmc import HMCConfig, HMCResult, constrain_positions, make_hmc_drive

    config = config or HMCConfig()
    staged = _staged(staged, model_fn, model_args, device)
    shard = _layout(mesh, chain_axes, staged.device)
    q0, generator = _start(staged, config, shard, seed, 7, n_chains)
    drive = make_hmc_drive(staged, config, q0.shape[0], n_samples, n_warmup,
                           discrete=discrete, chain_group=shard.group)
    q_f, qs, ljs, aps, divs, eps, inv_mass = drive(q0, generator)
    positions = shard.gather(qs.movedim(0, 1))
    return HMCResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        log_joint=shard.gather(ljs.movedim(0, 1)),
        accept_prob=torch.mean(shard.gather(aps, 1), dim=-1),
        divergences=shard.gather(divs.movedim(0, 1)),
        step_size=float(eps),
        inv_mass=inv_mass,
        final_positions=shard.gather(q_f),
    )


def sharded_nuts_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config=None,
    *,
    n_chains: int = 8,
    mesh=None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
    device="cuda",
):
    """NUTS with the chain batch split over the mesh's chain axes: each rank
    builds its chains' trees on its own; only the warmup adaptation reduces
    over the ranks. The async drive (the default) makes one all-reduce per
    warmup iteration (finished count, acceptance sum and running chains),
    so the ranks run the same warmup iterations; each rank samples on its
    own, with no collective. ``lockstep_leaves``, ``warmup_leaves`` and
    ``host_syncs`` are the summed counts of every rank."""
    from ..inference.nuts import NUTSConfig, NUTSResult, make_nuts_drive
    from ..inference.hmc import constrain_positions

    config = config or NUTSConfig()
    staged = _staged(staged, model_fn, model_args, device)
    shard = _layout(mesh, chain_axes, staged.device)
    q0, generator = _start(staged, config, shard, seed, 13, n_chains)
    drive = make_nuts_drive(staged, config, q0.shape[0], n_samples, n_warmup,
                            discrete=discrete, chain_group=shard.group)
    q_f, qs, aps, divs, depths, eps, inv_mass, n_leaps, counts = drive(q0, generator)
    positions = shard.gather(qs.movedim(0, 1))
    host = shard.gather(torch.tensor(
        [[counts["leaves"], counts["host_syncs"], counts["warmup_leaves"]]], device=staged.device))
    leaves, syncs, warm = host.sum(dim=0).tolist()
    return NUTSResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        accept_prob=torch.mean(shard.gather(aps, 1), dim=-1),
        divergences=shard.gather(divs.movedim(0, 1)),
        tree_depths=shard.gather(depths.movedim(0, 1)),
        step_size=float(eps),
        inv_mass=inv_mass,
        final_positions=shard.gather(q_f),
        n_leapfrogs=int(shard.gather(n_leaps).to(torch.int64).sum()),
        lockstep_leaves=int(leaves),
        host_syncs=int(syncs),
        warmup_leaves=int(warm),
    )


def sharded_chees_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config=None,
    *,
    n_chains: int = 8,
    mesh=None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
    device="cuda",
):
    """ChEES-HMC with the chain batch split over the mesh's chain axes. The
    criterion's gradient is a cross-chain mean, so it reduces over the ranks
    with the acceptance statistic and the Welford moments: ε and T, and
    every transition's leapfrog count L, are the same on every rank."""
    from ..inference.chees import ChEESConfig, ChEESResult, GeneratorDraws, make_chees_drive
    from ..inference.hmc import constrain_positions

    config = config or ChEESConfig()
    staged = _staged(staged, model_fn, model_args, device)
    shard = _layout(mesh, chain_axes, staged.device)
    q0, generator = _start(staged, config, shard, seed, 17, n_chains)
    drive = make_chees_drive(staged, config, q0.shape[0], n_samples, n_warmup,
                             discrete=discrete, chain_group=shard.group)
    q_f, qs, ljs, aps, divs, eps_f, T_f, mean_L, inv_mass, counts = drive(
        q0, GeneratorDraws(generator))
    positions = shard.gather(qs.movedim(0, 1))
    T_float = float(T_f)
    t_cap = 2.0 * math.pi * config.max_trajectory_periods
    return ChEESResult(
        samples=constrain_positions(staged, positions),
        positions=positions,
        log_joint=shard.gather(ljs.movedim(0, 1)),
        accept_prob=aps,
        divergences=shard.gather(divs.movedim(0, 1)),
        step_size=float(eps_f),
        trajectory_length=T_float,
        trajectory_cap_reached=bool(config.adapt_mass and n_warmup > 0
                                    and T_float >= t_cap * (1.0 - 1e-5)),
        mean_leapfrog=mean_L,
        n_leapfrogs=counts["leapfrogs"] * n_chains,  # L is the same on every rank
        inv_mass=inv_mass,
        final_positions=shard.gather(q_f),
        criterion=config.criterion,
        host_syncs=counts["host_syncs"],
    )


def sharded_smc(
    seed: int,
    n_particles: int,
    model_fn: Optional[Callable] = None,
    config=None,
    *,
    mesh=None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    resume=None,
    device="cuda",
):
    """Tempered SMC with the particles split over the mesh's chain axis
    (``smc.adaptive_smc(mesh=...)``): per stage only the (N,) weight and
    log-likelihood vectors are all-gathered, and the particles move over
    the ring of neighbouring ranks."""
    from ..inference.smc import SMCConfig, adaptive_smc

    staged = _staged(staged, model_fn, model_args, device)
    if mesh is None:
        mesh = make_chain_mesh(device=staged.device)
    return adaptive_smc(seed, n_particles, config=config or SMCConfig(), staged=staged,
                        mesh=mesh, resume=resume)


def sharded_pt_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    config=None,
    *,
    n_chains: int = 8,
    mesh=None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
    device="cuda",
):
    """Replica-exchange HMC with the chain batch split over the mesh. The β
    ladder is whole on every rank and swaps stay within a rank's chains;
    only the per-rung acceptance means reduce over the ranks, so every rank
    adapts the same per-rung ε."""
    from ..inference.tempering import PTConfig, make_pt_drive, pt_result

    config = config or PTConfig()
    staged = _staged(staged, model_fn, model_args, device)
    if staged.dim == 0:
        raise ValueError("model has no continuous latent sites; use MH")
    shard = _layout(mesh, chain_axes, staged.device)
    c = shard.split(n_chains)
    drive = make_pt_drive(staged, config, c, n_samples, n_warmup, discrete=discrete,
                          chain_group=shard.group)
    rank_seed = fold_seed(seed, 29, shard.seed_index)
    q_f, eps_f, q1s, accs, pair_accs = drive(_generator(staged.device, rank_seed), rank_seed)
    return pt_result(staged, config, shard.gather(q_f, 1), eps_f, shard.gather(q1s, 1), accs,
                     shard.gather(pair_accs, 2))


def sharded_ess_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 200,
    config=None,
    *,
    n_chains: int = 64,
    mesh=None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete: Optional[Dict[str, Any]] = None,
    chain_axes=None,
    device="cuda",
):
    """Elliptical slice sampling with the chains split over the mesh.
    Nothing adapts, so the chains are independent: each rank runs
    ``ess_chain`` on its chains from its folded seed, and no collective
    runs until the results are gathered. ``host_reads`` sums every rank's."""
    from ..inference.ess import ESSConfig, ESSResult, ess_chain

    staged = _staged(staged, model_fn, model_args, device)
    shard = _layout(mesh, chain_axes, staged.device)
    res = ess_chain(fold_seed(seed, 31, shard.seed_index), n_samples=n_samples,
                    n_warmup=n_warmup, config=config or ESSConfig(),
                    n_chains=shard.split(n_chains), staged=staged, discrete=discrete)
    stats = shard.gather(torch.tensor([[res.mean_shrink_iters, float(res.host_reads)]],
                                      dtype=torch.float64, device=staged.device)).cpu()
    return ESSResult(
        samples={a: shard.gather(v) for a, v in res.samples.items()},
        log_lik=shard.gather(res.log_lik),
        mean_shrink_iters=float(stats[:, 0].mean()),  # equal blocks: the mean of means
        final_flat=shard.gather(res.final_flat),
        host_reads=int(stats[:, 1].sum()),
    )


def sharded_gibbs_chain(
    seed: int,
    model_fn: Optional[Callable] = None,
    n_samples: int = 1000,
    n_warmup: int = 500,
    config=None,
    *,
    n_chains: int = 8,
    mesh=None,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    discrete_scale: float = 1.0,
    chain_axes=None,
    device="cuda",
):
    """HMC-within-Gibbs with the chain batch split over the mesh: the
    acceptance mean and the ε₀ consensus reduce over the ranks, so every
    rank adapts the same continuous-block kernel; the discrete sweeps stay
    on the rank."""
    from ..inference.gibbs import GibbsResult, make_gibbs_drive
    from ..inference.hmc import HMCConfig

    config = config or HMCConfig(n_leapfrog=16)
    staged = _staged(staged, model_fn, model_args, device)
    shard = _layout(mesh, chain_axes, staged.device)
    drive = make_gibbs_drive(staged, config, shard.split(n_chains), n_samples, n_warmup,
                             discrete_scale=discrete_scale, chain_group=shard.group)
    cont, disc, aps, dacc, eps_f, (z_f, disc_f) = drive(
        _generator(staged.device, fold_seed(seed, 13, shard.seed_index)))
    samples = {a: shard.gather(v, 1).movedim(0, 1) for a, v in {**cont, **disc}.items()}
    return GibbsResult(
        samples=samples,
        accept_prob_hmc=torch.mean(shard.gather(aps, 1), dim=-1),
        accept_rate_discrete=cross_mean(torch.mean(dacc), shard.group),
        step_size=float(eps_f),
        final_positions=shard.gather(z_f),
        final_discrete={a: shard.gather(v) for a, v in disc_f.items()},
    )


def sharded_abc_rejection(
    seed: int,
    model_fn: Optional[Callable] = None,
    observed=None,
    distance=None,
    epsilon: float = 1.0,
    n_samples: int = 100,
    *,
    mesh=None,
    max_attempts: int = 1_000_000,
    batch_size: int = 8192,
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    device="cuda",
):
    """Likelihood-free rejection with the simulation batch split over the
    mesh. Each rank simulates ``batch_size / ranks`` candidates from its
    folded seed, decides acceptance, takes its first ``cap`` accepted rows
    (a stable sort of the acceptance mask, as ``abc_rejection`` does), and
    only those rows and the counts are all-gathered: the candidate batch
    never leaves its rank. One host read of the gathered counts per
    dispatch; every rank takes the same rows in rank order."""
    from ..inference.abc import (ABCResult, _distances, _observed, _stage_exhausted,
                                 compact_accepted, euclidean_distance)

    distance = distance or euclidean_distance
    staged = _staged(staged, model_fn, model_args, device)
    shard = _layout(mesh, None, staged.device)
    local_batch = shard.split(batch_size, "batch_size")
    observed = _observed(observed, staged.device)
    cap = min(n_samples, local_batch)

    collected, dists = [], []
    n_acc = attempts = i = 0
    while n_acc < n_samples:
        if attempts >= max_attempts:
            raise _stage_exhausted(0, n_acc, n_samples, attempts)
        data, latents = staged.simulate_batch(fold_seed(seed, i, shard.seed_index),
                                              local_batch)
        d = _distances(distance, data, observed)
        ok = d <= epsilon
        take = compact_accepted(ok, cap)
        n_ok = torch.clamp(torch.sum(ok), max=cap).reshape(1)
        top = {a: shard.gather(v[take]) for a, v in latents.items()}
        d_top, counts = shard.gather(d[take]), shard.gather(n_ok).tolist()  # the read
        i += 1
        attempts += batch_size
        for r, c in enumerate(counts):
            n_take = min(int(c), n_samples - n_acc)
            if n_take <= 0:
                continue
            rows = slice(r * cap, r * cap + n_take)
            collected.append({a: v[rows] for a, v in top.items()})
            dists.append(d_top[rows])
            n_acc += n_take
    return ABCResult(
        particles={a: torch.cat([c[a] for c in collected]) for a in collected[0]},
        distances=torch.cat(dists),
        log_weights=torch.zeros(n_samples, dtype=settings.real_dtype(), device=staged.device),
        n_attempts=attempts,
    )


# ---------------------------------------------------------------------------
# VI
# ---------------------------------------------------------------------------


def _map_tree(tree, fn):
    """``tree`` with every tensor and numpy array leaf replaced by ``fn(leaf)``
    (through tuples, lists and dicts)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_tree(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return tree


def _data_leaves(staged: StagedModel):
    """The array arguments of the staged model with a leading axis."""
    leaves = []
    _map_tree((staged.args, staged.kwargs), lambda x: leaves.append(x) if x.ndim >= 1 else None)
    return leaves


def _plate_model(staged: StagedModel, n_plate: int, shard: ShardLayout) -> StagedModel:
    """The model staged on this rank's rows of the plate: only leaves whose
    leading axis is the largest one (``n_plate``) are split; every other
    leaf (a per-latent constant that happens to divide by the rank count)
    is kept whole."""
    rows = shard.rows(n_plate // shard.size)

    def cut(x):
        return x[rows] if x.ndim >= 1 and x.shape[0] == n_plate else x

    return StagedModel(staged.model_fn, _map_tree(staged.args, cut),
                       _map_tree(staged.kwargs, cut), device=staged.device)


def sharded_vi(
    seed: int,
    model_fn: Optional[Callable] = None,
    config=None,
    *,
    mesh=None,
    guide: str = "meanfield",
    shard: str = "auto",
    factors: str = "replicated",
    model_args: tuple = (),
    staged: Optional[StagedModel] = None,
    chain_axes=None,
    resume=None,
    device="cuda",
):
    """VI over the ranks of the mesh: each rank's loss is its share of the
    negative ELBO, and the loss and gradient are summed over the ranks after
    the backward pass, before the optimizer step, so the parameters stay the
    same on every rank.

    ``shard=``:

    - ``"data"``: the plate is split over the ranks. Each rank stages the
      model on its rows of the arguments whose leading axis is the largest
      (every other argument whole), draws the SAME guide samples (an
      unfolded seed), and scores its rows: its share is (prior side +
      entropy) / ranks + its likelihood. The likelihood must decompose over
      the plate and every latent must be global;
    - ``"samples"``: each rank draws ``config.n_samples`` independent draws
      from its folded seed, and its share is its ELBO / ranks: the mean over
      n_samples × ranks draws. Works for any model;
    - ``"auto"``: ``"data"`` when the largest leading axis divides by the
      rank count with at least 8 rows per rank, else ``"samples"``.

    ``factors=``: ``"replicated"`` (``factor`` terms do not depend on the
    plate, counted once) or ``"sharded"`` (summed with the likelihood).
    ``guide=``: ``"meanfield"`` or ``"fullrank"``. ``resume=`` continues
    from a previous result's parameters. Returns a ``VIResult``."""
    from ..inference.vi import (FullRankGuide, MeanFieldGuide, VIConfig, _draws_for, _drive,
                                _meanfield_guide_for, _start)

    config = config or VIConfig()
    staged = _staged(staged, model_fn, model_args, device)
    layout = _layout(mesh, chain_axes, staged.device)
    n_dev = layout.size
    n_plate = max((x.shape[0] for x in _data_leaves(staged)), default=None)
    plate_divides = n_plate is not None and n_plate % n_dev == 0
    if shard == "auto":
        shard = "data" if plate_divides and n_plate >= 8 * n_dev else "samples"
    if shard == "data":
        if n_plate is None:
            raise ValueError("shard='data' needs at least one staged data leaf "
                             "(pass the dataset as a stage()/model_args argument)")
        if not plate_divides:
            raise ValueError(f"largest data leaf axis 0 ({n_plate}) does not split "
                             f"evenly over {n_dev} shards")
        local = staged if n_dev == 1 else _plate_model(staged, n_plate, layout)
        draws = _draws_for(int(seed), staged.device)
    elif shard == "samples":
        local = staged
        draws = _draws_for(fold_seed(seed, layout.seed_index), staged.device)
    else:
        raise ValueError(f"unknown shard mode {shard!r}")
    if factors not in ("replicated", "sharded"):
        raise ValueError(f"unknown factors mode {factors!r}")
    if guide == "fullrank":
        g = FullRankGuide(local)
    elif guide == "meanfield":
        g = _meanfield_guide_for(local)
    else:
        raise ValueError(f"unknown guide {guide!r}")
    dt = settings.real_dtype()
    zero = torch.zeros((), dtype=dt, device=staged.device)

    def real(x):
        # a part the model left a Python 0.0 becomes a tensor with no
        # host-to-device copy (one would be a host sync per iteration)
        return (zero + x).to(dt)

    def parts(p, base):
        """(prior side, likelihood) of one draw under ``factors``."""
        if factors == "sharded":
            return real(base), real(p.log_likelihood) + real(p.log_factors)
        return real(base) + real(p.log_factors), real(p.log_likelihood)

    def lat_parts(lat):
        p = local.log_density_parts(lat)
        return parts(p, p.log_prior)

    def z_parts(z):
        p, logdet = local.log_density_parts_unconstrained(z)
        return parts(p, p.log_prior + logdet)

    def draw_parts(theta, dr):
        if isinstance(g, MeanFieldGuide):
            return vmap(lat_parts)(g._sample_flat(theta, dr, config.n_samples))
        return vmap(z_parts)(g._sample_z(theta, dr, config.n_samples))

    if shard == "data":
        def loss(theta, dr):
            pr, lik = draw_parts(theta, dr)
            return -(torch.mean(pr) + g._entropy_flat(theta)) / n_dev - torch.mean(lik)
    else:
        def loss(theta, dr):
            pr, lik = draw_parts(theta, dr)
            return -(torch.mean(pr + lik) + g._entropy_flat(theta)) / n_dev

    return _drive(g, loss, config, _start(g, resume), draws, layout.group)
