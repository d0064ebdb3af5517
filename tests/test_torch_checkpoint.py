"""Checkpoints of the PyTorch port (``fugue_tpu_torch/runtime/checkpoint.py``)
against the JAX package's ``.npz`` format, on the CPU.

- Round trip (tensors, a generator, Python numbers, a dataclass), a missing
  leaf, an atomic overwrite.
- A file written by either package for the same structure has the same
  keys and loads in the other: a dict state, and an MH state batch (the JAX
  ``vmap``-ed ``init_mh_state`` against ``interop.mh_state_from_numpy``).
- A restored MH state, and a restored ``MhSession`` carry, step bitwise like
  the original.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fugue_tpu as ft
import fugue_tpu_torch as ftt
from fugue_tpu.inference.mh import init_mh_state as jax_init_mh_state
from fugue_tpu.runtime import checkpoint as jck
from fugue_tpu_torch import interop, settings
from fugue_tpu_torch.dsl.sessions import MhSession
from fugue_tpu_torch.inference import mh
from fugue_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def torch_model():
    y = torch.tensor([1.0, 1.2], dtype=torch.float64)

    def model():
        mu = ftt.sample("mu", ftt.Normal(0.0, 2.0))
        ftt.observe("y", ftt.Normal(mu, 1.0), y)
        return mu

    return model


def jax_model():
    mu = ft.sample("mu", ft.Normal(0.0, 2.0))
    ft.observe("y", ft.Normal(mu, 1.0), jnp.array([1.0, 1.2]))
    return mu


def test_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(7)
    torch.rand(3, generator=g)  # move the generator off its seed
    state = {
        "positions": torch.arange(12.0, dtype=torch.float64).reshape(3, 4),
        "generator": g,
        "nested": {"scale": torch.tensor(0.5), "t": torch.tensor(3), "flags": [True, 2, 1.5]},
        "adapt": mh.AdaptationState(log_scale=torch.zeros(2), t=torch.ones(2)),
        "absent": None,
    }
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state)
    out = load_checkpoint(path, state)
    torch.testing.assert_close(out["positions"], state["positions"], rtol=0, atol=0)
    assert out["nested"]["t"].dtype == torch.int64 and out["nested"]["flags"] == [True, 2, 1.5]
    assert isinstance(out["adapt"], mh.AdaptationState) and out["absent"] is None
    assert out["generator"] is not g
    torch.testing.assert_close(torch.rand(5, generator=out["generator"]),
                               torch.rand(5, generator=g), rtol=0, atol=0)
    with np.load(path) as data:
        assert set(data.files) == {"positions", "generator", "nested/scale", "nested/t",
                                   "nested/flags/0", "nested/flags/1", "nested/flags/2",
                                   "adapt/log_scale", "adapt/t"}


def test_leaves_take_the_templates_dtype(tmp_path):
    path = str(tmp_path / "d.npz")
    save_checkpoint(path, {"v": torch.tensor([1.5, 2.5], dtype=torch.float64)})
    out = load_checkpoint(path, {"v": torch.zeros(2, dtype=torch.float32)})
    assert out["v"].dtype == torch.float32 and out["v"].tolist() == [1.5, 2.5]


def test_missing_leaf_raises(tmp_path):
    path = str(tmp_path / "x.npz")
    save_checkpoint(path, {"a": torch.ones(3)})
    with pytest.raises(KeyError):
        load_checkpoint(path, {"a": torch.ones(3), "b": torch.zeros(2)})


def test_atomic_overwrite(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"v": torch.tensor(1.0)})
    save_checkpoint(path, {"v": torch.tensor(2.0)})
    out = load_checkpoint(path, {"v": torch.tensor(0.0)})
    assert float(out["v"]) == 2.0
    assert os.listdir(tmp_path) == ["c.npz"]  # no temporary file is left


def test_dict_state_crosses_packages(tmp_path):
    rng = np.random.default_rng(0)
    pos, scale = rng.normal(size=(3, 4)), rng.uniform(size=2)
    jstate = {"positions": jnp.asarray(pos), "nested": {"scale": jnp.asarray(scale),
                                                        "t": jnp.array(3)}}
    tstate = {"positions": torch.as_tensor(pos), "nested": {"scale": torch.as_tensor(scale),
                                                            "t": torch.tensor(3)}}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, jstate)
    save_checkpoint(tpath, tstate)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert set(a.files) == set(b.files)
    from_jax = load_checkpoint(jpath, tstate)
    np.testing.assert_array_equal(from_jax["positions"].numpy(), pos)
    assert int(from_jax["nested"]["t"]) == 3
    from_port = jck.load_checkpoint(tpath, jstate)
    np.testing.assert_array_equal(np.asarray(from_port["nested"]["scale"]), scale)


def test_mh_state_crosses_packages_and_steps_bitwise(tmp_path):
    jstaged, tstaged = ft.stage(jax_model), ftt.stage(torch_model(), device="cpu")
    jstate = jax.vmap(lambda k: jax_init_mh_state(jstaged, k))(
        jax.random.split(jax.random.PRNGKey(0), 4))
    tstate = interop.mh_state_from_numpy(
        {a: np.asarray(v) for a, v in jstate.latents.items()}, np.asarray(jstate.log_joint),
        np.asarray(jstate.adapt.log_scale), np.asarray(jstate.adapt.t), device="cpu",
        dtype=torch.float64)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, jstate)
    save_checkpoint(tpath, tstate)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert set(a.files) == set(b.files) == {"latents/mu", "log_joint", "adapt/log_scale",
                                                "adapt/t"}
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    restored = load_checkpoint(jpath, tstate)  # the JAX package's file
    back = jck.load_checkpoint(tpath, jstate)  # the port's file
    np.testing.assert_array_equal(np.asarray(back.log_joint), np.asarray(jstate.log_joint))
    rng = np.random.default_rng(1)
    noise = (torch.as_tensor(rng.integers(0, 1, 4)), torch.as_tensor(rng.normal(size=(4, 1))),
             torch.as_tensor(np.log(rng.uniform(size=4))))
    s1, a1 = mh.mh_step_from_noise(tstaged, tstate, *noise, True)
    s2, a2 = mh.mh_step_from_noise(tstaged, restored, *noise, True)
    assert torch.equal(a1, a2)
    for x, y in ((s1.latents["mu"], s2.latents["mu"]), (s1.log_joint, s2.log_joint),
                 (s1.adapt.log_scale, s2.adapt.log_scale)):
        assert torch.equal(x, y)


def test_mh_session_resumes_bitwise(tmp_path):
    sess = MhSession(3, torch_model(), n_chains=8, device="cpu")
    sess.step(20)
    path = str(tmp_path / "sess.npz")
    save_checkpoint(path, sess.carry)
    fresh = MhSession(99, torch_model(), n_chains=8, device="cpu")
    fresh.carry = load_checkpoint(path, fresh.carry)
    np.testing.assert_array_equal(fresh.step(15)["mu"], sess.step(15)["mu"])
    with pytest.raises(TypeError):
        fresh.carry = {"state": None, "generator": None}
