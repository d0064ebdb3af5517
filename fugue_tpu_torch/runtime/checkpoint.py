"""Checkpoint / resume for long-running inference.

The port of ``save_checkpoint`` and ``load_checkpoint`` from
``fugue_tpu/runtime/checkpoint.py``: any sampler state (positions,
adaptation state, samples so far, the generator) is a tree of tensors and
round-trips through one ``.npz`` file keyed by tree paths.
``load_checkpoint`` takes a template tree (the freshly initialized state),
so the structure never depends on unpickling arbitrary objects.

The tree is walked explicitly: dicts by key, lists and tuples by index,
dataclasses and namedtuples by field name, joined by ``/`` as the JAX
package's ``_path_str`` joins them, so a file written by either package for
the same structure has the same keys. Leaves are tensors, numpy arrays,
Python numbers and ``torch.Generator``s, whose state (``get_state()``, a
uint8 tensor) is stored like the JAX key. ``None`` is an empty subtree.

``save_checkpoint_sharded`` and ``load_checkpoint_sharded`` are the
multi-rank path (the JAX package's orbax checkpoints), over
``torch.distributed.checkpoint``: a leaf that is a DTensor sharded over the
chain axis (``parallel.mesh.chain_sharded``) is written by each rank as its
own block, never gathered, and restored into the template's placements, so
each rank reads only the rows it owns. ``path`` is then a directory.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict

import numpy as np
import torch

_LEAVES = (torch.Tensor, np.ndarray, np.generic, torch.Generator, bool, int, float)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """A tree of the same structure with each leaf replaced by
    ``fn(path, leaf)``."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if tree is None:
        return None
    if isinstance(tree, _LEAVES):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, fn, join(k))) for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(_map(getattr(tree, f), fn, join(f)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, join(i)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn, join(f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    raise TypeError(f"checkpoint: no rule for a {type(tree).__name__} at {prefix!r}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        leaf = leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any) -> None:
    """Serialize a tree of tensors to ``path`` (.npz), atomically: the file
    is written under a name unique to this process and then renamed."""
    arrays: Dict[str, np.ndarray] = {}

    def put(key, leaf):
        arrays[key] = _to_numpy(leaf)
        return leaf

    _map(state, put)
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=f".{os.getpid()}.tmp",
                               dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)  # a crash never leaves a torn checkpoint
    except BaseException:
        os.unlink(tmp)
        raise


def _restore(template, array: np.ndarray):
    """``array`` as a leaf like ``template``: a tensor on its device in its
    dtype, a numpy array of its dtype, a Python number of its type, or a new
    generator on its device in the saved state."""
    if isinstance(template, torch.Generator):
        g = torch.Generator(device=template.device)
        g.set_state(torch.from_numpy(np.ascontiguousarray(array)))
        return g
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.ascontiguousarray(array)).to(
            device=template.device, dtype=template.dtype)
    if isinstance(template, (np.ndarray, np.generic)):
        return np.asarray(array, dtype=template.dtype)
    return type(template)(array.item())


def _dcp_leaf(leaf):
    """A leaf as ``torch.distributed.checkpoint`` stores it: a generator as
    its state, a numpy array as a tensor; tensors, DTensors and numbers as
    they are."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(leaf))
    return leaf


def save_checkpoint_sharded(path: str, state: Any) -> None:
    """Checkpoint a tree whose tensor leaves may be DTensors sharded over a
    device mesh: every rank calls this, and each writes only its own
    shards (replicated leaves are written once). ``path`` is a directory."""
    import torch.distributed.checkpoint as dcp

    flat: Dict[str, Any] = {}

    def put(key, leaf):
        flat[key] = _dcp_leaf(leaf)
        return leaf

    _map(state, put)
    dcp.save(flat, checkpoint_id=os.fspath(path))


def load_checkpoint_sharded(path: str, template: Any) -> Any:
    """Restore a tree saved by ``save_checkpoint_sharded``. ``template``
    supplies the structure and each leaf's device, dtype and placements: a
    DTensor leaf comes back as a DTensor with this rank's shard read in."""
    import torch.distributed.checkpoint as dcp

    flat: Dict[str, Any] = {}

    def put(key, leaf):
        x = _dcp_leaf(leaf)
        flat[key] = x.clone() if isinstance(x, torch.Tensor) else x
        return leaf

    _map(template, put)
    dcp.load(flat, checkpoint_id=os.fspath(path))

    def restore(key, leaf):
        x = flat[key]
        if isinstance(leaf, torch.Generator):
            g = torch.Generator(device=leaf.device)
            g.set_state(x.cpu())
            return g
        if isinstance(leaf, torch.Tensor):
            return x
        if isinstance(leaf, (np.ndarray, np.generic)):
            return np.asarray(x.cpu().numpy(), dtype=leaf.dtype)
        return type(leaf)(x)

    return _map(template, restore)


def load_checkpoint(path: str, template: Any) -> Any:
    """Restore a tree saved by ``save_checkpoint``; ``template`` supplies the
    structure, and each leaf's device and dtype."""
    with np.load(os.fspath(path)) as data:
        paths = []
        _map(template, lambda key, leaf: paths.append(key))
        missing = [p for p in paths if p not in data]
        if missing:
            raise KeyError(
                f"checkpoint {path!r} missing leaves {missing[:5]!r}"
                + ("..." if len(missing) > 5 else "")
            )
        return _map(template, lambda key, leaf: _restore(leaf, data[key]))
