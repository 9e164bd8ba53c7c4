"""The ranks as a mesh, and the tree helpers that lay data out on it.

Counterpart of ``simglucose_tpu/parallel/sharding.py``.  The JAX package
places one global array over a ``('dp', 'tp')`` device mesh; here each rank
holds only its part, so:

* :func:`shard_batch` returns this rank's contiguous slice of every leaf's
  leading (patient) axis;
* :func:`replicate` makes every rank hold rank 0's leaves (a broadcast);
* :func:`gather_to_host` all-gathers the ranks' slices into numpy arrays on
  every rank.

``dp`` is the patient axis.  ``tp`` (the policy's hidden dimension split
over ranks) is ROADMAP queue 1 item 11b and raises here.  A single process
with no group is a mesh of one rank, on which every helper is the identity.

Nothing shards unless its caller passes a mesh: an entry point given
``mesh=None`` runs on this process alone and makes no collective call
(:func:`resolve_mesh`), so one rank may simulate or evaluate by itself
while the others do something else.  Those that split a cohort over the
ranks first compare a digest of their arguments across the ranks
(:func:`check_same`).  A collective runs on the tensor's own device where
the group's backend serves that device, else on the host (gloo) or on
this rank's card (NCCL alone); gloo gathers host tensors only.
"""
from __future__ import annotations

import dataclasses
import hashlib
from datetime import date, datetime, time, timedelta
from numbers import Number

import numpy as np
import torch
import torch.distributed as dist

from simglucose_tpu_torch.parallel.multihost import process_count, process_index

TP_ITEM = "ROADMAP queue 1 item 11b"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The default group's ranks on a ``dp`` axis: ``rank`` is this
    process's position.  ``live`` says whether a process group exists (its
    collectives run even on one rank)."""

    dp: int
    tp: int = 1
    rank: int = 0
    live: bool = False


def make_mesh(dp=None, tp: int = 1) -> Mesh:
    """The ``('dp', 'tp')`` mesh over the default group's ranks (one rank
    without a group).  ``dp`` defaults to every rank; ``dp * tp`` must be
    the rank count."""
    n = process_count()
    if tp != 1:
        raise NotImplementedError(
            f"tp={tp}: splitting the policy's hidden dimension over ranks is {TP_ITEM}; "
            "use tp=1")
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != n_ranks={n}")
    return Mesh(dp=dp, tp=tp, rank=process_index(), live=dist.is_initialized())


def check_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` itself; a ``tp`` axis raises (:data:`TP_ITEM`)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.sharding.Mesh (make_mesh); got {mesh!r}")
    if mesh.tp != 1:
        raise NotImplementedError(f"a mesh with tp={mesh.tp} is {TP_ITEM}")
    return mesh


LOCAL = Mesh(dp=1)


def resolve_mesh(mesh=None) -> Mesh:
    """The mesh an entry point runs on: ``mesh`` itself (checked), or this
    process alone (:data:`LOCAL`, no collectives) when it is None."""
    return LOCAL if mesh is None else check_mesh(mesh)


def map_leaves(fn, tree):
    """``fn`` over the leaves of a tree of the port's records (the
    checkpoint order: NamedTuples, tuples, lists, dicts, ``PolicyParams``'
    tensors; None stays None)."""
    from simglucose_tpu_torch.utils.checkpoint import _unflatten, flatten_with_paths

    return _unflatten(tree, iter([fn(leaf) for _, leaf in flatten_with_paths(tree)]))


def _lane_slice(mesh: Mesh, n: int, what: str) -> slice:
    if n % mesh.dp:
        raise ValueError(f"{what} of {n} does not divide over {mesh.dp} ranks")
    per = n // mesh.dp
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(tree, mesh: Mesh, axis: int = 0):
    """This rank's contiguous slice of the ``axis`` (default leading) axis
    of every tensor / array leaf of at least that many dimensions; other
    leaves (scalars, ints, generators) are replicated as they are.  A leaf
    whose axis does not divide over the ranks raises."""
    check_mesh(mesh)

    def take(a):
        if not isinstance(a, (torch.Tensor, np.ndarray)) or a.ndim <= axis:
            return a
        sl = _lane_slice(mesh, a.shape[axis], "an axis")
        if isinstance(a, np.ndarray):
            return np.ascontiguousarray(np.take(a, np.arange(sl.start, sl.stop), axis=axis))
        return a.narrow(axis, sl.start, sl.stop - sl.start).contiguous()

    return map_leaves(take, tree)


def _comm_device(t: torch.Tensor, gather: bool = False) -> torch.device:
    """The device a collective of ``t`` runs on under the default group:
    ``t``'s own where the group has a backend for its device type (for an
    all-gather of a card tensor that backend must be NCCL: gloo gathers
    host tensors only), else the host where gloo serves it, else this
    rank's card (a group of NCCL alone)."""
    backends = dict(p.split(":") for p in dist.get_backend_config().split(","))
    own = backends.get(t.device.type)
    if own is not None and not (gather and t.device.type == "cuda" and own != "nccl"):
        return t.device
    if "cpu" in backends:
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _broadcast(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, on ``t``'s device."""
    c = t.detach().clone().to(_comm_device(t))
    dist.broadcast(c, 0)
    return c.to(t.device)


def replicate(tree, mesh: Mesh):
    """Every rank's copy of rank 0's tensor leaves (a broadcast of each);
    a ``torch.Generator`` gets rank 0's state.  Other leaves are kept as
    each rank has them.  Without a group, the tree itself."""
    check_mesh(mesh)
    if not mesh.live:
        return tree

    def bcast(a):
        if isinstance(a, torch.Generator):
            g = torch.Generator(device=a.device)
            g.set_state(_broadcast(a.get_state()))
            return g
        return _broadcast(a) if torch.is_tensor(a) else a

    return map_leaves(bcast, tree)


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, in place (every rank gets the
    same bits); the tensor itself without a group."""
    if mesh is None or not mesh.live:
        return t
    d = _comm_device(t)
    if d == t.device:
        dist.all_reduce(t)
    else:
        c = t.to(d)
        dist.all_reduce(c)
        t.copy_(c)
    return t


def gather_lanes(t: torch.Tensor, mesh, axis: int = -1) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``axis`` in rank order, on every
    rank and on ``t``'s device (the tensor itself without a group).  It
    runs even on a group of one rank."""
    if mesh is None or not mesh.live:
        return t
    src = t.detach().contiguous()
    src = src.to(_comm_device(src, gather=True))
    parts = [torch.empty_like(src) for _ in range(mesh.dp)]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=axis).to(t.device)


def gather_to_host(tree, mesh=None, axis: int = 0):
    """The ranks' shards of every tensor / array leaf concatenated along
    ``axis`` (the leading axis by default), as numpy on every rank; leaves
    of fewer dimensions and other leaves as this rank holds them.  Without
    a mesh, each leaf on the host."""

    def pull(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        if not torch.is_tensor(a):
            return a
        if a.ndim > axis:
            a = gather_lanes(a, mesh, axis)
        return a.detach().cpu().numpy()

    return map_leaves(pull, tree)


def _fingerprint(v) -> str:
    """A text that equal arguments give on every rank: values by value,
    tensors by dtype, shape and a hash of their bytes, functions and other
    objects by qualified name (never by address)."""
    if torch.is_tensor(v) or isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
        return f"{a.dtype}{a.shape}:{hashlib.blake2b(a.tobytes(), digest_size=8).hexdigest()}"
    if isinstance(v, (str, Number, type(None), date, datetime, time, timedelta, torch.dtype)):
        return repr(v)
    if isinstance(v, dict):
        items = sorted(v.items(), key=lambda kv: repr(kv[0]))
        return "{" + ",".join(f"{k!r}:{_fingerprint(x)}" for k, x in items) + "}"
    if isinstance(v, (list, tuple)):
        return type(v).__name__ + "(" + ",".join(map(_fingerprint, v)) + ")"
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return type(v).__name__ + _fingerprint(
            {f.name: getattr(v, f.name) for f in dataclasses.fields(v)})
    return f"{getattr(v, '__module__', '')}.{getattr(v, '__qualname__', type(v).__qualname__)}"


def check_same(mesh, what: str, args) -> None:
    """Raise ValueError on every rank unless every rank of a live ``mesh``
    passed the same ``args`` (one all-gather of a digest): an entry point
    that splits its work over the ranks needs the same global arguments
    on each."""
    if mesh is None or not mesh.live:
        return
    digest = hashlib.blake2b(_fingerprint(args).encode(), digest_size=8).digest()
    every = gather_lanes(torch.tensor([int.from_bytes(digest, "little", signed=True)]), mesh, 0)
    differ = [r for r in range(mesh.dp) if every[r] != every[0]]
    if differ:
        raise ValueError(f"{what}: rank(s) {differ} passed other arguments than rank 0; every "
                         "rank of the mesh must pass the same global arguments")
