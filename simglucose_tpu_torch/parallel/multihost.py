"""Process-group bring-up and per-rank result IO.

Counterpart of ``simglucose_tpu/parallel/multihost.py``.  A JAX process
drives all of its host's devices; here a device is a rank, so a run is
started as one process per device (``torchrun --nproc-per-node=N``, or any
launcher that sets torch's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE``) and each process calls :func:`initialize`.  A rank's
device is ``cuda:(rank % torch.cuda.device_count())``.

Single-process runs need nothing: without a cluster environment
:func:`initialize` does nothing, and every helper works on one process
(then "global" == "local").  :func:`process_group` joins the group for a
block and leaves it with the other ranks.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def default_backend() -> str:
    """``"cpu:gloo,cuda:nccl"`` where CUDA is present (device tensors reduce
    over NCCL, host tensors gather over gloo), ``"gloo"`` on the CPU."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def spawn_backend(n_ranks: int, device) -> str:
    """The backend of ``n_ranks`` ranks that one process spawns on
    ``device``: :func:`default_backend` where each rank has a card of its
    own (rank r on card r), gloo where ranks share a card (NCCL refuses two
    ranks on one card) or run on the CPU."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return default_backend()
    return "gloo"


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Bring up the default process group and pin this rank's device.

    With no arguments it reads torch's environment (``MASTER_ADDR``,
    ``RANK``, ``WORLD_SIZE``) and does nothing where that is absent (a
    single-process run).  Otherwise ``init_method`` (``tcp://host:port`` or
    ``file://path``), ``world_size`` and ``rank`` are given explicitly.
    ``backend`` defaults to :func:`default_backend`; it is never switched
    quietly, and a group that fails to form raises."""
    if init_method is None and world_size is None:
        if not all(k in os.environ for k in _ENV):
            logger.info("torch.distributed not initialized (no %s); single process",
                        "/".join(_ENV))
            return
        init_method = "env://"
    # each rank sits on its card before any collective (NCCL binds a
    # communicator to the current card at its first collective, on every
    # group): by the rank of the arguments or torch's environment, and
    # again by the one the group holds (where only the store knew it)
    known = rank if rank is not None else os.environ.get("RANK")
    if torch.cuda.is_available() and known is not None:
        torch.cuda.set_device(int(known) % torch.cuda.device_count())
    # torch reads an unset world size and rank as -1 (from the environment
    # under env://), and refuses None
    dist.init_process_group(backend or default_backend(), init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    if torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    logger.info("distributed: rank %d/%d, backend %s", dist.get_rank(), dist.get_world_size(),
                dist.get_backend())


@contextlib.contextmanager
def process_group(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> Iterator[None]:
    """:func:`initialize` for the body, then leave the group together: once
    the body has finished on this rank a barrier, and in every case
    ``destroy_process_group()``.  A rank whose process exits while another
    is still in its last gloo collective aborts in gloo's teardown
    ("terminate called without an active exception").  Where
    :func:`initialize` joins no group (a single process) it does nothing."""
    initialize(init_method, world_size, rank, backend)
    if not dist.is_initialized():
        yield
        return
    done = False
    try:
        yield
        done = True
    finally:
        if done:
            dist.barrier()
        dist.destroy_process_group()


def process_index() -> int:
    """This rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The ranks of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous slice of a ``[global_batch]`` patient axis
    split over the ranks."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} ranks")
    per = global_batch // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def local_shard(tree):
    """Host numpy of the rows this rank holds.  A rank holds only its own
    shard of a sharded tree, so this is each tensor leaf copied to the host
    (the JAX function reassembles a host's addressable device shards)."""
    from simglucose_tpu_torch.parallel.sharding import map_leaves

    return map_leaves(lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a),
                      tree)


def save_local_results(tree, patient_names: Sequence[str], start_time, sample_time: int,
                       save_path: str):
    """Write this rank's patients to per-patient CSVs: ``tree`` is the
    ``(reset, traj)`` pair of this rank's lanes (``[B/n]`` and ``[T, B/n]``
    fields BG, CGM, CHO, insulin, LBGI, HBGI, risk), ``patient_names`` the
    global cohort.  Every rank writes its own shard.  Needs pandas."""
    from simglucose_tpu_torch.analysis.report import cohort_frame

    reset, traj = local_shard(tree)
    names = list(patient_names)[local_batch_slice(len(patient_names))]
    df = cohort_frame(reset, traj, names, start_time, sample_time)
    os.makedirs(save_path, exist_ok=True)
    for name in names:
        df.loc[name].to_csv(os.path.join(save_path, f"{name}.csv"))
    return df
