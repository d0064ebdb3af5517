"""Process bootstrap and two-level device meshes over ``torch.distributed``.

The port of ``fugue_tpu/parallel/distributed.py``. JAX runs one process per
host and sees every device of the slice in it; PyTorch runs one process per
GPU (launched by ``torchrun`` or spawned), and every rank calls the same
driver. So:

- ``initialize_distributed`` wraps ``torch.distributed.init_process_group``
  with an environment bootstrap. It is idempotent and a no-op for one
  process, so the same script runs on a laptop, one host or a cluster.
  The backend comes from the configuration: NCCL when the ranks' tensors
  live on CUDA devices, gloo for CPU tensors and for ranks that share one
  card (NCCL refuses two ranks on one device). Nothing catches a failed
  initialisation and carries on elsewhere.
- ``make_hybrid_mesh`` builds a ``DeviceMesh`` with the DCN (host-spanning)
  axes outermost and the ICI (within-host) axes innermost, so collectives
  over the inner axes stay inside a host. Its ``mesh_dim_names`` are the
  JAX axis names.
- ``flat_axis_index`` linearises a rank's mesh coordinate row-major, for
  per-rank seeds that depend only on the logical layout.

Runbook: every rank runs the same program. Under ``torchrun`` the standard
``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` are read; ``FUGUE_COORDINATOR_ADDRESS`` (``host:port``),
``FUGUE_NUM_PROCESSES``, ``FUGUE_PROCESS_ID``, ``FUGUE_LOCAL_DEVICE_IDS``
and ``FUGUE_BACKEND`` win over them. Call ``initialize_distributed()``
first, then build a mesh and pass it to the sharded drivers.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# torchrun's names, each the fallback of a FUGUE_ name
_TORCHRUN = {"NUM_PROCESSES": "WORLD_SIZE", "PROCESS_ID": "RANK",
             "LOCAL_DEVICE_IDS": "LOCAL_RANK"}

# set once this module has initialised the default process group
_initialized = False


@dataclass(frozen=True)
class DistributedConfig:
    """Bootstrap parameters for ``torch.distributed.init_process_group``.

    ``coordinator_address`` is ``host:port`` of rank 0's store;
    ``local_device_ids`` the CUDA device(s) of this rank (its first is
    made current); ``backend`` "nccl" or "gloo", None to choose it from the
    device (``default_backend``)."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[Tuple[int, ...]] = None
    backend: Optional[str] = None

    @property
    def is_multiprocess(self) -> bool:
        if self.num_processes is not None:
            return self.num_processes > 1
        return self.coordinator_address is not None


def _env_get(env: Mapping[str, str], name: str) -> Optional[str]:
    for key in ("FUGUE_" + name, _TORCHRUN.get(name)):
        v = env.get(key) if key else None
        if v is not None and v != "":
            return v
    return None


def config_from_env(env: Optional[Mapping[str, str]] = None) -> DistributedConfig:
    """Parse the bootstrap config from environment variables.

    ``FUGUE_COORDINATOR_ADDRESS`` (else ``MASTER_ADDR:MASTER_PORT`` when
    both are set), ``FUGUE_NUM_PROCESSES`` (else ``WORLD_SIZE``),
    ``FUGUE_PROCESS_ID`` (else ``RANK``), ``FUGUE_LOCAL_DEVICE_IDS`` (comma
    separated; else ``LOCAL_RANK``) and ``FUGUE_BACKEND``. Absent
    variables stay ``None``."""
    if env is None:
        env = os.environ
    coord = _env_get(env, "COORDINATOR_ADDRESS")
    if coord is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coord = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    nproc = _env_get(env, "NUM_PROCESSES")
    pid = _env_get(env, "PROCESS_ID")
    local = _env_get(env, "LOCAL_DEVICE_IDS")
    return DistributedConfig(
        coordinator_address=coord,
        num_processes=int(nproc) if nproc is not None else None,
        process_id=int(pid) if pid is not None else None,
        local_device_ids=tuple(int(x) for x in local.split(",")) if local else None,
        backend=_env_get(env, "BACKEND"),
    )


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo otherwise. Ranks that share one card
    name gloo in their config instead."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    config: Optional[DistributedConfig] = None,
    *,
    env: Optional[Mapping[str, str]] = None,
    device="cuda",
    _initialize_fn=None,
) -> bool:
    """Initialise the default process group from ``config`` (or the
    environment). Returns ``True`` if ``init_process_group`` was called,
    ``False`` for the single-process no-op or a second call. ``device``
    chooses the backend when the config names none. ``_initialize_fn`` is
    a test seam (defaults to ``torch.distributed.init_process_group``),
    called with ``backend``, ``init_method``, ``world_size`` and ``rank``."""
    global _initialized
    if _initialized:
        return False
    if config is None:
        config = config_from_env(env)
    if not config.is_multiprocess:
        return False  # one process: nothing to coordinate
    if config.coordinator_address is None or config.process_id is None \
            or config.num_processes is None:
        raise ValueError(
            "a multi-process run needs the coordinator address, the number of "
            f"processes and this process's id; got {config}")
    backend = config.backend or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or 'gloo'")
    if backend == "nccl" and config.local_device_ids:
        torch.cuda.set_device(config.local_device_ids[0])
    fn = _initialize_fn if _initialize_fn is not None else dist.init_process_group
    fn(backend=backend, init_method=f"tcp://{config.coordinator_address}",
       world_size=config.num_processes, rank=config.process_id)
    _initialized = True
    return True


def ensure_process_group(device="cuda", *, env: Optional[Mapping[str, str]] = None,
                         _initialize_fn=None) -> None:
    """The default group, made when none exists. When the environment
    names more than one process (``torchrun``), it is the group of them
    all (``initialize_distributed`` from the environment), so that no rank
    runs the whole batch alone; else a one-rank group on an in-process
    store (no port), so a sharded driver runs in a plain single process."""
    if dist.is_initialized():
        return
    config = config_from_env(env)
    if config.is_multiprocess:
        initialize_distributed(config, device=device, _initialize_fn=_initialize_fn)
    else:
        dist.init_process_group(default_backend(device), store=dist.HashStore(),
                                world_size=1, rank=0)


# ---------------------------------------------------------------------------
# DCN × ICI two-level meshes
# ---------------------------------------------------------------------------


def hybrid_mesh_shape(ici_axes: Dict[str, int], dcn_axes: Optional[Dict[str, int]],
                      n: int) -> Tuple[Tuple[str, ...], List[int]]:
    """``(names, sizes)`` of the mesh over ``n`` ranks: ``dcn_axes`` first,
    then ``ici_axes``; at most one size may be ``-1``, inferred from ``n``."""
    dcn_axes = dcn_axes or {}
    names = tuple(dcn_axes) + tuple(ici_axes)
    sizes = list(dcn_axes.values()) + list(ici_axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1 (inferred)")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"cannot infer axis: {n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} devices, have {n}")
    return names, sizes


def make_hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Optional[Dict[str, int]] = None,
                     *, device="cuda"):
    """A ``DeviceMesh`` over every rank of the default group: ``dcn_axes``
    outermost (host-spanning), ``ici_axes`` innermost, laid out row-major
    over the ranks, so that under ``torchrun`` (consecutive ranks on one
    host) the inner axes stay within a host. One size may be ``-1``."""
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(device)
    names, sizes = hybrid_mesh_shape(ici_axes, dcn_axes, dist.get_world_size())
    return init_device_mesh(torch.device(device).type, tuple(sizes), mesh_dim_names=names)


def make_pod_chain_mesh(*, local_size: Optional[int] = None, device="cuda"):
    """The default multi-host layout for MCMC/SMC: a "hosts" axis over
    hosts and a "chains" axis over each host's ranks (``local_size``,
    default ``LOCAL_WORLD_SIZE`` or every rank). The sharded drivers split
    chain batches over BOTH axes."""
    ensure_process_group(device)
    n = dist.get_world_size()
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % local_size:
        raise ValueError(f"{n} ranks not divisible into hosts of {local_size}")
    return make_hybrid_mesh({"chains": local_size}, {"hosts": n // local_size}, device=device)


def flat_axis_index(mesh, axes: Sequence[str]) -> int:
    """Row-major linear index of this rank's coordinate over ``axes``: the
    per-rank seed folds depend only on the logical mesh layout."""
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    idx = 0
    for ax in axes:
        d = names.index(ax)
        idx = idx * mesh.size(d) + coord[d]
    return idx
