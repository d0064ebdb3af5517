"""Device meshes, placements, and the collectives the engines use.

The port of ``fugue_tpu/parallel/mesh.py``. A JAX ``Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the JAX axis names, and a named axis becomes that dimension's process
group. ``chain_sharding`` and ``replicated`` give DTensor placements.

The collective vocabulary takes an optional process group; with ``None`` it
is the plain single-device operation, so an engine written against it runs
unchanged on one device:

- ``cross_mean`` / ``cross_sum`` / ``cross_min`` for ``pmean`` / ``psum``
  / ``pmin``: an ``all_reduce``. Gloo has no ``ReduceOp.AVG``, so a mean is
  the SUM divided by the group size on every backend;
- ``all_gather_tiled`` for a tiled ``all_gather``;
- ``ring_exchange`` for ``ppermute`` to the ring neighbours: one
  ``batch_isend_irecv``.

The backend decides where the bytes travel. NCCL reduces device tensors in
place on the card and adds no host read. Gloo moves CPU tensors; a CUDA
tensor on a gloo group (ranks that share one card) is copied to the host
on purpose, reduced there, and copied back. ``COUNTS`` counts the
collective calls and those host stagings (each one a device-to-host read).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

CHAIN_AXIS = "chains"
DATA_AXIS = "data"

# collective calls, and the calls that staged a CUDA tensor through the host
COUNTS = {"collectives": 0, "host_staged": 0}


def make_chain_mesh(n_devices: Optional[int] = None, *, device="cuda"):
    """1-D mesh with every rank (or the first ``n_devices``) along the chain
    axis: the default layout for MCMC/SMC batches."""
    from torch.distributed.device_mesh import DeviceMesh

    from .distributed import ensure_process_group

    ensure_process_group(device)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return DeviceMesh(torch.device(device).type, torch.arange(n), mesh_dim_names=(CHAIN_AXIS,))


def make_chain_data_mesh(chain_devices: int, data_devices: int, *, device="cuda"):
    """2-D mesh: chains × data. Chains split the batch; the data axis splits
    large observation plates, whose partial log-likelihoods reduce with a
    sum."""
    from torch.distributed.device_mesh import DeviceMesh

    from .distributed import ensure_process_group

    ensure_process_group(device)
    need = chain_devices * data_devices
    if dist.get_world_size() < need:
        raise ValueError(f"need {need} devices for a {chain_devices}x{data_devices} mesh, "
                         f"have {dist.get_world_size()}")
    grid = torch.arange(need).reshape(chain_devices, data_devices)
    return DeviceMesh(torch.device(device).type, grid, mesh_dim_names=(CHAIN_AXIS, DATA_AXIS))


def chain_sharding(mesh, ndim: int = 1) -> List:
    """DTensor placements that shard dim 0 (chains, particles) over the chain
    axis and replicate over every other mesh axis. ``ndim`` is the tensor's
    rank, as in the JAX package; the placements do not depend on it."""
    from torch.distributed.tensor import Replicate, Shard

    del ndim
    return [Shard(0) if name == CHAIN_AXIS else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh) -> List:
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def chain_sharded(x, mesh):
    """The global (n, ...) tensor ``x``, held whole on every rank, as a
    DTensor sharded over the chain axis (``chain_sharding``): this rank
    keeps its rows of ``x``."""
    from torch.distributed.tensor import DTensor

    names = tuple(mesh.mesh_dim_names)
    size = mesh.size(names.index(CHAIN_AXIS))
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split over {size} ranks")
    local = x.shape[0] // size
    me = mesh.get_local_rank(CHAIN_AXIS)
    return DTensor.from_local(x[me * local:(me + 1) * local], mesh, chain_sharding(mesh))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def resolve_chain_axes(mesh, chain_axes=None) -> Tuple[str, ...]:
    """The axes that split a batch: ``chain_axes``, else the chain axis when
    the mesh has one, else every axis (the multi-host layout)."""
    if chain_axes is None:
        names = tuple(mesh.mesh_dim_names)
        chain_axes = (CHAIN_AXIS,) if CHAIN_AXIS in names else names
    return (chain_axes,) if isinstance(chain_axes, str) else tuple(chain_axes)


# (id(mesh), axes) -> this rank's group over several mesh axes
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}


def axes_group(mesh, axes: Sequence[str]):
    """The process group of this rank's ranks along ``axes`` of ``mesh``:
    the dimension's own group for one axis; for several, one group per
    coordinate of the other axes, made once per mesh by every rank."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        others = [d for d in range(len(names)) if d not in dims]
        size = math.prod(mesh.size(d) for d in dims)
        rows = mesh.mesh.permute(others + dims).reshape(-1, size).tolist()
        _GROUPS[key], _ = dist.new_subgroups_by_enumeration(rows)
    return _GROUPS[key]


@dataclass(frozen=True)
class ShardLayout:
    """How a batch splits over the ranks of a group: this rank holds block
    ``index`` of ``size`` equal blocks, and folds ``seed_index`` (the
    row-major mesh coordinate, ``flat_axis_index``) into its seeds. The
    one-device layout has no group."""

    group: Any = None
    size: int = 1
    index: int = 0
    seed_index: int = 0

    @staticmethod
    def of(mesh, axes=None) -> "ShardLayout":
        from .distributed import flat_axis_index

        axes = resolve_chain_axes(mesh, axes)
        group = axes_group(mesh, axes)
        return ShardLayout(group, dist.get_world_size(group), dist.get_rank(group),
                           flat_axis_index(mesh, axes))

    def split(self, n: int, what: str = "n_chains") -> int:
        """This rank's share of ``n``; ``n`` must divide evenly."""
        if n % self.size:
            raise ValueError(f"{what}={n} not divisible by mesh size {self.size}")
        return n // self.size

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``size * n_local``."""
        return slice(self.index * n_local, (self.index + 1) * n_local)

    def gather(self, x, dim: int = 0):
        """Every rank's block of ``x`` along ``dim``, in block order."""
        return all_gather_tiled(x, self.group, dim)


# ---------------------------------------------------------------------------
# Collectives over an optional group
# ---------------------------------------------------------------------------


def _staged(x, group) -> bool:
    """A CUDA tensor on a gloo group goes through the host."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(x, group):
    COUNTS["collectives"] += 1
    if _staged(x, group):
        COUNTS["host_staged"] += 1
        return x.detach().cpu().contiguous()
    return x.detach().clone().contiguous()


def _all_reduce(x, op, group):
    y = _to_wire(x, group)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def cross_sum(x, group=None):
    """Σ over the group's ranks of ``x`` (``psum``)."""
    return x if group is None else _all_reduce(x, dist.ReduceOp.SUM, group)


def cross_mean(x, group=None):
    """The mean over the group's ranks of ``x`` (``pmean``): the SUM over
    the group size (gloo has no AVG)."""
    if group is None:
        return x
    return _all_reduce(x, dist.ReduceOp.SUM, group) / dist.get_world_size(group)


def cross_min(x, group=None):
    """The minimum over the group's ranks (``pmin``)."""
    return x if group is None else _all_reduce(x, dist.ReduceOp.MIN, group)


_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_tiled(x, group=None, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order (a tiled
    ``all_gather``)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    y = _to_wire(x.movedim(dim, 0), group)
    if y.dtype == torch.bool:  # moved as bytes: not every backend gathers bool
        y = y.to(torch.uint8)
    out = y.new_empty((n * y.shape[0],) + tuple(y.shape[1:]))
    _gather_single(out, y, group=group)
    return out.to(device=x.device, dtype=x.dtype).movedim(0, dim)


def ring_exchange(tensors: Sequence[torch.Tensor], group, *, forward: bool):
    """Send each tensor to the next rank of the group (``forward``) or the
    previous one, and receive the same shapes from the other side (a
    ``ppermute`` over the ring). One ``batch_isend_irecv`` for all of them."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (me + 1) % n if forward else (me - 1) % n)
    frm = dist.get_global_rank(group, (me - 1) % n if forward else (me + 1) % n)
    ops, outs = [], []
    for x in tensors:
        y = _to_wire(x, group)
        if y.dtype == torch.bool:  # moved as bytes, as in all_gather_tiled
            y = y.to(torch.uint8)
        buf = torch.empty_like(y)
        ops += [dist.P2POp(dist.isend, y, to, group), dist.P2POp(dist.irecv, buf, frm, group)]
        outs.append((buf, x))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [buf.to(device=x.device, dtype=x.dtype) for buf, x in outs]
