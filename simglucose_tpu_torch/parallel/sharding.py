"""The ranks as a mesh, and the tree helpers that lay data out on it.

Counterpart of ``simglucose_tpu/parallel/sharding.py``.  The JAX package
places one global array over a ``('dp', 'tp')`` device mesh; here each rank
holds only its part, so:

* :func:`shard_batch` returns this rank's contiguous slice of every leaf's
  leading (patient) axis;
* :func:`replicate` makes every rank hold rank 0's leaves (a broadcast);
* :func:`gather_to_host` all-gathers the ranks' slices into numpy arrays on
  every rank.

``dp`` is the patient axis and ``tp`` the policy's hidden dimension: rank
``r`` sits at ``(r // tp, r % tp)``, the JAX package's row-major device
order.  The ``tp`` ranks of one ``dp`` coordinate hold the same lanes and
split the policy's compute (``rl/policy.py::policy_apply``); the helpers
above work by ``dp_rank``.  :func:`all_reduce_sum` sums over ``'dp'``,
``'tp'`` or both.  A single process with no group is a mesh of one rank, on
which every helper is the identity.

Nothing shards unless its caller passes a mesh: an entry point given
``mesh=None`` runs on this process alone and makes no collective call
(:func:`resolve_mesh`), so one rank may simulate or evaluate by itself
while the others do something else.  Those that split a cohort over the
ranks first compare a digest of their arguments across the ranks
(:func:`check_same`).  A collective runs on the tensor's own device where
the group's backend serves that device, else on the host (gloo) or on
this rank's card (NCCL alone); gloo gathers host tensors only.

On a live mesh the exchanges are spans of ``utils/profiling.py`` (on only
under a ``torch.profiler`` session): ``mesh.gather`` for each all-gather,
with a ``bytes`` counter of the gathered tensor, and ``mesh.check_same``
for the digest exchange.  A process without a group records neither.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from datetime import date, datetime, time, timedelta
from numbers import Number

import numpy as np
import torch
import torch.distributed as dist

from simglucose_tpu_torch.parallel.multihost import process_count, process_index
from simglucose_tpu_torch.utils.profiling import count, span

AXES = ("dp", "tp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The default group's ranks on a ``(dp, tp)`` grid: ``rank`` is this
    process's position, at ``(dp_rank, tp_rank)``.  ``live`` says whether a
    process group exists (its collectives run even on one rank).
    ``groups`` holds this rank's process sub-groups by axis where both axes
    have more than one rank (:func:`make_mesh` builds them); a collective
    over an axis that spans every rank runs on the default group."""

    dp: int
    tp: int = 1
    rank: int = 0
    live: bool = False
    groups: dict = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.dp < 1 or self.tp < 1:
            raise ValueError(f"dp={self.dp} and tp={self.tp} must be positive")
        if self.tp > 1 and not self.live:
            raise ValueError(f"tp={self.tp} splits the policy over ranks and needs a live "
                             "process group: build the mesh with make_mesh inside it")

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


# (dp, tp) -> (the default group they were built in, this rank's sub-groups)
_GROUPS: dict = {}


def _sub_groups(dp: int, tp: int) -> dict:
    """This rank's ``{'tp': group, 'dp': group}``: the ranks of its
    ``dp_rank``, and those of its ``tp_rank``.  ``new_group`` must be called
    by every rank for every group, in the same order, including the groups
    it is not in: the tp groups by dp coordinate, then the dp groups by tp
    coordinate.  Built once per ``(dp, tp)`` and default group."""
    world = dist.group.WORLD
    hit = _GROUPS.get((dp, tp))
    if hit is not None and hit[0] is world:
        return hit[1]
    rank = dist.get_rank()
    mine = {}
    for d in range(dp):
        g = dist.new_group([d * tp + k for k in range(tp)])
        if rank // tp == d:
            mine["tp"] = g
    for k in range(tp):
        g = dist.new_group([d * tp + k for d in range(dp)])
        if rank % tp == k:
            mine["dp"] = g
    _GROUPS[(dp, tp)] = (world, mine)
    return mine


def make_mesh(dp=None, tp: int = 1) -> Mesh:
    """The ``('dp', 'tp')`` mesh over the default group's ranks (one rank
    without a group).  ``dp`` defaults to every rank over ``tp``; ``dp * tp``
    must be the rank count, and ``tp > 1`` needs a live group.  Every rank
    must call it with the same ``(dp, tp)``: the first call of a 2-D shape
    builds its process sub-groups on every rank."""
    n = process_count()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != n_ranks={n}")
    live = dist.is_initialized()
    groups = _sub_groups(dp, tp) if live and dp > 1 and tp > 1 else None
    return Mesh(dp=dp, tp=tp, rank=process_index(), live=live, groups=groups)


def check_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` itself, which must be a :class:`Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.sharding.Mesh (make_mesh); got {mesh!r}")
    return mesh


LOCAL = Mesh(dp=1)


def resolve_mesh(mesh=None, allow_tp: bool = False) -> Mesh:
    """The mesh an entry point runs on: ``mesh`` itself (checked), or this
    process alone (:data:`LOCAL`, no collectives) when it is None.  An
    entry point that splits patients only (simulation, evaluation) leaves
    ``allow_tp`` False, and a mesh with ``tp > 1`` raises ValueError there:
    the JAX package builds ``tp=1`` meshes for them."""
    if mesh is None:
        return LOCAL
    check_mesh(mesh)
    if mesh.tp > 1 and not allow_tp:
        raise ValueError(f"a mesh with tp={mesh.tp}: simulation and evaluation shard patients "
                         "over 'dp' alone; build the mesh with tp=1")
    return mesh


def _axis_group(mesh: Mesh, axis):
    """The process group of a collective over ``axis`` ('dp', 'tp' or both
    as a tuple): None for the default group, where the axis spans every
    rank (on a group of one rank too), False where it holds this rank
    alone (the collective is the identity), else this rank's sub-group."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if not axes or not set(axes) <= set(AXES):
        raise ValueError(f"axis must be 'dp', 'tp' or both; got {axis!r}")
    n = math.prod(getattr(mesh, a) for a in set(axes))
    if n == mesh.dp * mesh.tp:
        return None
    if n == 1:
        return False
    if mesh.groups is None:
        raise ValueError(f"{mesh} has no process sub-groups: build it with make_mesh")
    return mesh.groups[axes[0]]


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
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def shard_batch(tree, mesh: Mesh, axis: int = 0):
    """This rank's contiguous slice of the ``axis`` (default leading) axis
    of every tensor / array leaf of at least that many dimensions, by its
    ``dp_rank`` (the ``tp`` ranks of one ``dp`` coordinate hold the same
    slice); other leaves (scalars, ints, generators) are replicated as
    they are.  A leaf whose axis does not divide over ``dp`` raises."""
    check_mesh(mesh)

    def take(a):
        if not isinstance(a, (torch.Tensor, np.ndarray)) or a.ndim <= axis:
            return a
        sl = _lane_slice(mesh, a.shape[axis], "an axis")
        if isinstance(a, np.ndarray):
            return np.ascontiguousarray(np.take(a, np.arange(sl.start, sl.stop), axis=axis))
        return a.narrow(axis, sl.start, sl.stop - sl.start).contiguous()

    return map_leaves(take, tree)


def _comm_device(t: torch.Tensor, gather: bool = False, group=None) -> torch.device:
    """The device a collective of ``t`` runs on over ``group`` (None: the
    default group): ``t``'s own where the group has a backend for its
    device type (for an all-gather of a card tensor that backend must be
    NCCL: gloo gathers host tensors only), else the host where gloo serves
    it, else this rank's card (a group of NCCL alone)."""
    backends = dict(p.split(":") for p in dist.get_backend_config(group).split(","))
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
    """Every rank's copy of world rank 0's tensor leaves (a broadcast of each);
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


def all_reduce_sum(t: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks on ``axis`` ('dp', 'tp' or
    both, :func:`_axis_group`), in place (every rank of the axis gets the
    same bits); the tensor itself without a group."""
    if mesh is None or not mesh.live:
        return t
    group = _axis_group(mesh, axis)
    if group is False:
        return t
    d = _comm_device(t, group=group)
    if d == t.device:
        dist.all_reduce(t, group=group)
    else:
        c = t.to(d)
        dist.all_reduce(c, group=group)
        t.copy_(c)
    return t


def all_gather(t: torch.Tensor, mesh, over=AXES, axis: int = 0) -> torch.Tensor:
    """The ``t`` of the ranks on ``over`` ('dp', 'tp' or both, the default:
    every rank) concatenated along ``axis`` in rank order, on each of them
    and on ``t``'s device; the tensor itself without a group."""
    if mesh is None or not mesh.live:
        return t
    group = _axis_group(mesh, over)
    if group is False:
        return t
    with span("mesh.gather"):
        out = _gather(t, group, axis)
        count("bytes", out.numel() * out.element_size())
        return out


def _gather(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """:func:`all_gather` over ``group`` (None: the default group), with no
    span."""
    src = t.detach().contiguous()
    src = src.to(_comm_device(src, gather=True, group=group))
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=axis).to(t.device)


def gather_lanes(t: torch.Tensor, mesh, axis: int = -1) -> torch.Tensor:
    """The ``dp`` ranks' ``t`` concatenated along ``axis`` in ``dp_rank``
    order, on every rank and on ``t``'s device (the tensor itself without a
    group; a ``tp`` rank gathers over its ``dp`` group).  It runs even on a
    group of one rank."""
    return all_gather(t, mesh, "dp", axis)


def gather_to_host(tree, mesh=None, axis: int = 0):
    """The ``dp`` ranks' shards of every tensor / array leaf concatenated
    along ``axis`` (the leading axis by default), as numpy on every rank;
    leaves of fewer dimensions and other leaves as this rank holds them.
    Without a mesh, each leaf on the host."""

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
    with span("mesh.check_same"):
        digest = hashlib.blake2b(_fingerprint(args).encode(), digest_size=8).digest()
        every = _gather(torch.tensor([int.from_bytes(digest, "little", signed=True)]), None, 0)
    differ = [r for r in range(len(every)) if every[r] != every[0]]
    if differ:
        raise ValueError(f"{what}: rank(s) {differ} passed other arguments than rank 0; every "
                         "rank of the mesh must pass the same global arguments")
