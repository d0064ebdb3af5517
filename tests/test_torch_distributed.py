"""The port's process bootstrap and two-level meshes
(``fugue_tpu_torch/parallel/distributed.py``), after the JAX package's
``tests/test_distributed.py``: the environment parsing and its precedence
(``FUGUE_`` over torchrun's names), the one-process no-op, the
initialisation seam called with the parsed config and the backend the
config chooses, the hybrid mesh's shape and its inferred axis, and the
row-major flat index. A mesh over real ranks is built in
``tests/test_torch_parallel_ranks.py``; here it is built over a one-rank
group.
"""

import itertools

import numpy as np
import pytest

from fugue_tpu_torch.parallel import distributed as pdist
from fugue_tpu_torch.parallel.distributed import (
    DistributedConfig,
    config_from_env,
    default_backend,
    flat_axis_index,
    hybrid_mesh_shape,
    initialize_distributed,
)


def test_config_from_env_fugue_vars():
    cfg = config_from_env({
        "FUGUE_COORDINATOR_ADDRESS": "10.0.0.1:8476",
        "FUGUE_NUM_PROCESSES": "4",
        "FUGUE_PROCESS_ID": "2",
        "FUGUE_LOCAL_DEVICE_IDS": "0,1,2,3",
        "FUGUE_BACKEND": "nccl",
    })
    assert cfg == DistributedConfig("10.0.0.1:8476", 4, 2, (0, 1, 2, 3), "nccl")
    assert cfg.is_multiprocess


def test_config_from_env_torchrun_fallback_and_precedence():
    cfg = config_from_env({
        "MASTER_ADDR": "host", "MASTER_PORT": "1234",
        "FUGUE_NUM_PROCESSES": "2",
        "WORLD_SIZE": "8",  # FUGUE_ wins
        "RANK": "1",
        "LOCAL_RANK": "1",
    })
    assert cfg.coordinator_address == "host:1234"
    assert cfg.num_processes == 2
    assert cfg.process_id == 1
    assert cfg.local_device_ids == (1,)
    assert cfg.backend is None
    cfg = config_from_env({"FUGUE_COORDINATOR_ADDRESS": "a:1", "MASTER_ADDR": "b",
                           "MASTER_PORT": "2"})
    assert cfg.coordinator_address == "a:1"


def test_config_from_env_empty_is_single_process():
    cfg = config_from_env({})
    assert cfg == DistributedConfig()
    assert not cfg.is_multiprocess
    assert not config_from_env({"WORLD_SIZE": "1", "RANK": "0"}).is_multiprocess


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.setattr(pdist, "_initialized", False)
    calls = []
    assert initialize_distributed(env={}, _initialize_fn=lambda **kw: calls.append(kw)) is False
    assert initialize_distributed(DistributedConfig(num_processes=1),
                                  _initialize_fn=lambda **kw: calls.append(kw)) is False
    assert calls == []


@pytest.mark.parametrize("device, backend_env, backend", [
    ("cpu", None, "gloo"), ("cuda", None, "nccl"), ("cuda", "gloo", "gloo"),
])
def test_initialize_calls_the_seam_with_the_env_config(monkeypatch, device, backend_env,
                                                       backend):
    """The seam gets the parsed address, world size and rank, and the backend
    the config names or, without one, the device's; a second call is a
    no-op. Two ranks that share one card name gloo."""
    monkeypatch.setattr(pdist, "_initialized", False)
    env = {"FUGUE_COORDINATOR_ADDRESS": "localhost:29500", "FUGUE_NUM_PROCESSES": "2",
           "FUGUE_PROCESS_ID": "1"}
    if backend_env:
        env["FUGUE_BACKEND"] = backend_env
    calls = []
    assert initialize_distributed(env=env, device=device,
                                  _initialize_fn=lambda **kw: calls.append(kw)) is True
    assert calls == [{"backend": backend, "init_method": "tcp://localhost:29500",
                      "world_size": 2, "rank": 1}]
    assert initialize_distributed(env=env, _initialize_fn=lambda **kw: calls.append(kw)) is False
    assert len(calls) == 1


def test_initialize_rejects_an_incomplete_or_unknown_config(monkeypatch):
    monkeypatch.setattr(pdist, "_initialized", False)
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(DistributedConfig(num_processes=2, process_id=0),
                               _initialize_fn=lambda **kw: None)
    with pytest.raises(ValueError, match="backend"):
        initialize_distributed(DistributedConfig("h:1", 2, 0, backend="mpi"),
                               _initialize_fn=lambda **kw: None)
    assert pdist._initialized is False


def test_ensure_process_group_joins_the_environments_ranks(monkeypatch):
    """With no group yet and an environment of two processes (torchrun's
    names), the group made is the two ranks' (the seam gets them), never a
    one-rank group that would run the whole batch alone."""
    monkeypatch.setattr(pdist, "_initialized", False)
    monkeypatch.setattr(pdist.dist, "is_initialized", lambda: False)
    made_alone = []
    monkeypatch.setattr(pdist.dist, "init_process_group", lambda *a, **kw: made_alone.append(kw))
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": "29511", "WORLD_SIZE": "2", "RANK": "1"}
    calls = []
    pdist.ensure_process_group("cpu", env=env, _initialize_fn=lambda **kw: calls.append(kw))
    assert calls == [{"backend": "gloo", "init_method": "tcp://localhost:29511",
                      "world_size": 2, "rank": 1}]
    assert made_alone == []
    monkeypatch.setattr(pdist, "_initialized", False)
    pdist.ensure_process_group("cpu", env={"WORLD_SIZE": "1"},
                               _initialize_fn=lambda **kw: calls.append(kw))
    assert len(calls) == 1 and made_alone[0]["world_size"] == 1


def test_default_backend_follows_the_device():
    assert default_backend("cuda") == "nccl"
    assert default_backend("cuda:1") == "nccl"
    assert default_backend("cpu") == "gloo"


def test_hybrid_mesh_shapes():
    names, sizes = hybrid_mesh_shape({"chains": 4}, {"hosts": 2}, 8)
    assert names == ("hosts", "chains")  # DCN outermost
    assert sizes == [2, 4]


def test_hybrid_mesh_inferred_axis():
    assert hybrid_mesh_shape({"chains": -1}, {"hosts": 2}, 8)[1] == [2, 4]
    assert hybrid_mesh_shape({"chains": 8}, None, 8) == (("chains",), [8])
    with pytest.raises(ValueError):
        hybrid_mesh_shape({"a": -1}, {"b": -1}, 8)
    with pytest.raises(ValueError):
        hybrid_mesh_shape({"a": 3}, {"b": 2}, 8)  # 6 != 8
    with pytest.raises(ValueError):
        hybrid_mesh_shape({"a": -1}, {"b": 3}, 8)  # 8 is not a multiple of 3


class _GridMesh:
    """The mesh interface ``flat_axis_index`` reads, at one coordinate."""

    def __init__(self, names, sizes, coord):
        self.mesh_dim_names, self._sizes, self._coord = names, sizes, coord

    def get_coordinate(self):
        return list(self._coord)

    def size(self, d):
        return self._sizes[d]


def test_flat_axis_index_is_row_major():
    names, sizes = ("hosts", "chains"), (2, 4)
    idx = [flat_axis_index(_GridMesh(names, sizes, c), names)
           for c in itertools.product(range(2), range(4))]
    assert idx == list(range(8))
    # over the inner axis alone: the local index
    assert flat_axis_index(_GridMesh(names, sizes, (1, 3)), ("chains",)) == 3
    # axis order decides the linearisation, not the mesh's order
    assert flat_axis_index(_GridMesh(names, sizes, (1, 2)), ("chains", "hosts")) == 5


def test_make_hybrid_and_pod_meshes_over_one_rank(one_rank):
    from fugue_tpu_torch.parallel import make_hybrid_mesh, make_pod_chain_mesh

    mesh = make_hybrid_mesh({"chains": -1}, {"hosts": 1}, device="cpu")
    assert mesh.mesh_dim_names == ("hosts", "chains")
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert flat_axis_index(mesh, ("hosts", "chains")) == 0
    pod = make_pod_chain_mesh(device="cpu")
    assert pod.mesh_dim_names == ("hosts", "chains")
    assert np.asarray(pod.mesh).tolist() == [[0]]
    with pytest.raises(ValueError):
        make_hybrid_mesh({"chains": 2}, device="cpu")  # 2 ranks asked of 1


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group (made by the port when none exists), taken
    down after the module."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    pdist.ensure_process_group("cpu")
    yield
    if made:
        dist.destroy_process_group()
