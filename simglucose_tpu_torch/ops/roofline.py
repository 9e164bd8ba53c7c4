"""The roofline probe K6: plain version, wrapper and timing.

Counterpart of ``tools/roofline_rollout.py::make_chain`` and ``measure``
(the TPU's probe): P independent chains of K applications of one
elementwise op on an ``[8, 128]`` float32 tile, summed into one tile.  The
card runs it as ``csrc/roofline.cu`` (one thread per element of a tile
replicated to ``n_threads`` elements), so one op's rate can be read at any
launch shape; :mod:`simglucose_tpu_torch.tools.roofline_rollout` reads the
seven rates and the ceiling they put on the rollout kernel K1a.

* :func:`chain_reference` is the plain PyTorch version.
* :func:`chain` is the wrapper: a CPU tile goes to the plain version, a
  CUDA tile to the kernel (each launch adds one to ``LAUNCHES["chain"]``),
  anything else raises.
* :func:`measure` times the kernel by CUDA events; it raises without CUDA.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# the ops of the TPU probe (tools/roofline_rollout.py:52-67), in the order
# of csrc/roofline_math.cuh ChainOp
OPS = ("fma", "mul", "tanh", "exp", "log", "div", "select")
# the chain counts the kernel is built for
KERNEL_P = (1, 4, 16)
TILE_SHAPE = (8, 128)
TILE = TILE_SHAPE[0] * TILE_SHAPE[1]

# launches of the CUDA kernel made through :func:`chain`
LAUNCHES = {"chain": 0}


def _one(op: str, y: torch.Tensor) -> torch.Tensor:
    if op == "fma":
        return y * 1.000001 + 1e-6
    if op == "mul":
        return y * 1.000001
    if op == "tanh":
        return torch.tanh(y)
    if op == "exp":
        return torch.exp(y * 1e-6)  # keep finite
    if op == "log":
        return torch.log(torch.abs(y) + 1.0)
    if op == "div":
        return 1.0 / (y + 1.7)
    if op == "select":
        return torch.where(y > 0.5, y * 0.999, y + 1e-4)
    raise ValueError(op)


def probe_tile(device="cuda") -> torch.Tensor:
    """The TPU probe's input: linspace(0.1, 1.0) over the ``[8, 128]`` tile,
    computed in double and rounded to float32."""
    x = np.linspace(0.1, 1.0, TILE).astype(np.float32).reshape(TILE_SHAPE)
    return torch.from_numpy(x).to(device)


def chain_reference(op: str, x, K: int, P: int) -> torch.Tensor:
    """Plain PyTorch version: the ``[TILE]`` sums of P chains of K
    applications of ``op``, chain p seeded ``x + p * 0.01``, on ``x``'s
    device.  The P chains advance as one ``[P, TILE]`` tensor (each element
    rounds as it would alone); the sum runs in p order, as the kernel's."""
    if op not in OPS:
        raise ValueError(op)
    x = torch.as_tensor(x, dtype=torch.float32).reshape(-1)
    seeds = torch.tensor([float(p) * 0.01 for p in range(P)], dtype=torch.float32,
                         device=x.device)
    ys = x[None, :] + seeds[:, None]
    for _ in range(K):
        ys = _one(op, ys)
    acc = ys[0]
    for p in range(1, P):
        acc = acc + ys[p]
    return acc


def chain(op: str, x, K: int, P: int, n_threads: int, threads_per_block: int = 128) -> torch.Tensor:
    """The probe over ``n_threads`` elements, element i computed from
    ``x[i % 1024]``: ``[n_threads]`` float32 on ``x``'s device.

    ``x`` is the ``[8, 128]`` (1024-element) float32 tile.  On a CPU tensor
    this runs :func:`chain_reference` and repeats its tile; on a CUDA tensor
    it launches K6 in blocks of ``threads_per_block`` threads, or raises (P
    must be one of ``KERNEL_P`` there)."""
    if op not in OPS:
        raise ValueError(op)
    x = torch.as_tensor(x)
    if x.dtype != torch.float32 or x.numel() != TILE:
        raise ValueError(f"x must be a float32 tile of {TILE} elements; got {tuple(x.shape)} {x.dtype}")
    if n_threads < 1 or K < 0 or P < 1:
        raise ValueError(f"need n_threads >= 1, K >= 0, P >= 1; got {n_threads}, {K}, {P}")
    if x.device.type == "cpu":
        tile = chain_reference(op, x, K, P)
        return tile.repeat(-(-n_threads // TILE))[:n_threads]
    if x.device.type == "cuda":
        return _chain_cuda(op, x, K, P, n_threads, threads_per_block)
    raise ValueError(f"chain runs on 'cpu' or 'cuda' tensors; got {x.device}")


def _chain_cuda(op, x, K, P, n_threads, threads_per_block):
    from simglucose_tpu_torch.ops.build import load_library

    lib = load_library()
    x = x.contiguous()
    out = torch.empty(n_threads, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.sgt_chain_launch(OPS.index(op), P, ctypes.c_void_p(x.data_ptr()),
                               ctypes.c_void_p(out.data_ptr()), n_threads, threads_per_block, K,
                               ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"roofline kernel launch failed (op {op!r}, P={P}, {n_threads} threads in blocks "
            f"of {threads_per_block}, K={K}): CUDA error {err}"
        )
    LAUNCHES["chain"] += 1
    return out


def measure(op: str, P: int, n_threads: int, threads_per_block: int, K: int,
            launches: int = 5) -> float:
    """The card's rate for ``op`` at this launch shape: element-ops per
    second (``n_threads * K * P`` per launch) over ``launches`` launches
    timed by CUDA events, after one warm-up launch.  Raises where CUDA is
    absent: a rate is only ever the card's."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure times the roofline kernel on the card; CUDA is not available")
    if op not in OPS:
        raise ValueError(op)
    x = probe_tile("cuda")
    chain(op, x, K, P, n_threads, threads_per_block)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        chain(op, x, K, P, n_threads, threads_per_block)
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / launches
    return n_threads * K * P / seconds
