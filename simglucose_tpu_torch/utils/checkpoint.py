"""Checkpoint / resume of the port's states, in the JAX package's npz format.

Counterpart of ``simglucose_tpu/utils/checkpoint.py:31-141``, npz backend
only (orbax is a JAX library).  A state is a tree of the port's records:
``save_state`` writes its leaves as ``leaf_0 .. leaf_{n-1}`` of one npz, in
the order ``jax.tree_util`` flattens the same tree, so that a file holding
the same leaves interchanges with the JAX package's:

* NamedTuple fields in field order, depth first; tuples and lists by
  position; dicts by sorted key;
* :class:`~simglucose_tpu_torch.rl.policy.PolicyParams` gives its nine
  tensor fields ``w1 .. b_v`` (``jax.tree_util.register_dataclass``'s data
  fields); its decoder metadata is no leaf;
* ``None`` is no leaf.

Two leaf types exist only in the port, each with one rule:

* a ``torch.Generator`` (the trainers' permutation stream) is stored as its
  ``get_state()`` bytes and restored into a new generator with
  ``set_state``, so a resumed run draws the same permutations;
* a Python ``int`` (``FusedTrainState.init``, ``TrainState.step``,
  ``AdamState.count``) is stored as a 0-d int64 array and restored as an
  ``int``.

A JAX train state does not restore into a port train state: its threefry
``key`` and its optax state are other leaves, and :func:`restore_state`
says so by its leaf-count or shape error (``rl/ppo.py::
opt_state_from_optax`` converts an optax state).  What interchanges bit for
bit, both ways, is a ``PolicyParams``.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from simglucose_tpu_torch.rl.policy import LEAVES, PolicyParams


def _children(node, path: str):
    """``(path, child)`` pairs of a record, in the JAX flatten order; None
    for a leaf."""
    if isinstance(node, PolicyParams):
        return [(f"{path}.{n}", getattr(node, n)) for n in LEAVES]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f"{path}.{f}", v) for f, v in zip(node._fields, node)]
    if isinstance(node, (tuple, list)):
        return [(f"{path}[{i}]", v) for i, v in enumerate(node)]
    if isinstance(node, dict):
        return [(f"{path}[{k!r}]", node[k]) for k in sorted(node)]
    return None


def flatten_with_paths(tree: Any) -> list:
    """``[(path, leaf)]`` of ``tree`` in the JAX flatten order; each path as
    ``jax.tree_util.keystr`` writes it (``.params.w2``, ``[0]``,
    ``['w']``)."""

    def walk(node, path):
        if node is None:
            return []
        kids = _children(node, path)
        if kids is None:
            return [(path, node)]
        return [leaf for p, child in kids for leaf in walk(child, p)]

    return walk(tree, "")


def _unflatten(like: Any, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, PolicyParams):
        return like.replace(**{n: _unflatten(getattr(like, n), leaves) for n in LEAVES})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        values = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: values[k] for k in like}
    return next(leaves)


def _host_arrays(tensors: list) -> list:
    """Tensors on the card as numpy arrays, through one copy to the host:
    their bytes concatenated on the card, copied, and split again."""
    if not tensors:
        return []
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, offset = [], 0
    for t, f in zip(tensors, flat):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[offset:offset + f.numel()].view(dtype).reshape(tuple(t.shape)))
        offset += f.numel()
    return out


def save_state(path: str, tree: Any) -> None:
    """Serialize a state tree to ``path`` (an npz of ``leaf_i``).  Tensors
    on the card go to the host in one copy.  A bfloat16 leaf raises
    TypeError (numpy has no bfloat16; cast it to float32 first)."""
    flat = flatten_with_paths(tree)
    arrays = [None] * len(flat)
    on_card = []
    for i, (p, x) in enumerate(flat):
        if isinstance(x, torch.Generator):
            arrays[i] = x.get_state().numpy()
        elif isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                raise TypeError(f"checkpoint leaf {p} is bfloat16, which numpy cannot hold; "
                                "cast it to float32 before saving")
            if x.device.type == "cpu":
                arrays[i] = x.detach().numpy()
            else:
                on_card.append(i)
        elif isinstance(x, int):
            arrays[i] = np.asarray(x, np.int64)
        elif isinstance(x, (np.ndarray, np.generic)):
            arrays[i] = np.asarray(x)
        else:
            raise TypeError(f"checkpoint leaf {p} is a {type(x).__name__}: a leaf is a tensor, a "
                            "numpy array, an int or a torch.Generator")
    for i, a in zip(on_card, _host_arrays([flat[i][1] for i in on_card])):
        arrays[i] = a
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(arrays)})


def _check_shape(path: str, shape, want) -> None:
    if tuple(shape) != tuple(want):
        raise ValueError(
            f"checkpoint leaf {path} has shape {tuple(shape)}, expected {tuple(want)} — the "
            "saved state does not match `like` (wrong batch size / config?)"
        )


def _restore_leaf(path: str, arr: np.ndarray, ref):
    """One saved array as ``ref``'s kind of leaf: ``ref``'s dtype and
    device for a tensor, a new generator in the saved state, an int."""
    if isinstance(ref, torch.Generator):
        _check_shape(path, arr.shape, ref.get_state().shape)
        gen = torch.Generator(device=ref.device)
        gen.set_state(torch.from_numpy(arr.astype(np.uint8)))
        return gen
    if isinstance(ref, torch.Tensor):
        _check_shape(path, arr.shape, ref.shape)
        return torch.as_tensor(arr).to(dtype=ref.dtype).to(ref.device)
    if isinstance(ref, int):
        _check_shape(path, arr.shape, ())
        return type(ref)(arr)
    ref = np.asarray(ref)
    _check_shape(path, arr.shape, ref.shape)
    return arr.astype(ref.dtype) if arr.dtype != ref.dtype else arr


def restore_state(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_state` (or by the JAX package's
    ``save_state``, where the leaves match).  ``like`` gives the structure
    and the leaf contract: the leaf count is checked, each leaf is cast to
    ``like``'s dtype and put on its device, and a shape mismatch raises
    ValueError naming the leaf's path (``.params.w2``)."""
    flat = flatten_with_paths(like)
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        if len(z.files) != len(flat):
            raise ValueError(f"checkpoint has {len(z.files)} leaves, expected {len(flat)}")
        leaves = [_restore_leaf(p, z[f"leaf_{i}"], ref) for i, (p, ref) in enumerate(flat)]
    return _unflatten(like, iter(leaves))


class CheckpointManager:
    """Rolling checkpoint directory: one ``ckpt_<step:012d>.npz`` per saved
    step, the newest ``max_to_keep`` kept.

    >>> mgr = CheckpointManager('ckpts', max_to_keep=3)
    >>> mgr.save(step, train_state)
    >>> state = mgr.restore(like=train_state)      # latest

    ``backend`` is 'npz'; 'orbax' (the JAX package's second backend) is a
    JAX library and raises ValueError here."""

    def __init__(self, directory: str, max_to_keep: int = 3, backend: str = "npz"):
        if backend == "orbax":
            raise ValueError("backend='orbax' is a JAX library and is not ported; use backend='npz'")
        if backend != "npz":
            raise ValueError(f"backend must be 'npz'; got {backend!r}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.backend = backend
        os.makedirs(self.directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:012d}.npz")

    def all_steps(self) -> list:
        steps = []
        for f in os.listdir(self.directory):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                steps.append(int(f[len("ckpt_"):-len(".npz")]))
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> str:
        path = self._step_path(step)
        save_state(path, tree)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._step_path(old))
        return path

    def restore(self, like: Any, step=None) -> Any:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return restore_state(self._step_path(step), like)
