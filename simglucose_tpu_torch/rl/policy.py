"""The Gaussian MLP policy + value network for glucose control.

Counterpart of ``simglucose_tpu/rl/policy.py``: the same parameters (in the
same field order, so checkpoints and optimizer states carry across), the
same seven observation features and the same action decoders.  Functions
work at any float dtype; the trainers run float32, optionally with the
learner's matmul operands rounded to bfloat16 (``compute_dtype``).

Under a mesh with ``tp > 1`` (:mod:`simglucose_tpu_torch.parallel.sharding`)
:func:`policy_apply` splits the trunk's hidden dimension over the ``tp``
ranks, as the JAX package's activation constraint makes GSPMD split it:
layer 1 by columns, layer 2 by rows with its partial products summed over
the ``tp`` group.  The params stay replicated on every rank.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from simglucose_tpu_torch.core.device import check_device
from simglucose_tpu_torch.ops.streams import action_normal
from simglucose_tpu_torch.parallel.sharding import all_reduce_sum

OBS_DIM = 7

ACTIVATIONS = ("tanh", "relu")
DECODERS = ("sigmoid", "residual_bb")

# Insulin-on-board decay time constant (minutes); see iob_step.
IOB_TAU_MIN = 100.0

LOG_2PI = math.log(2.0 * math.pi)

# the parameter fields in the JAX PolicyParams' (and checkpoints') order
LEAVES = ("w1", "b1", "w2", "b2", "w_mu", "b_mu", "log_std", "w_v", "b_v")


def iob_decay(sample_time) -> float:
    """exp(-dt/tau), computed on the host; the rollout kernel rounds it to
    float32 once, as the tensors here do."""
    return math.exp(-float(sample_time) / IOB_TAU_MIN)


def iob_step(iob, insulin, sample_time):
    """One control-step IOB update: decay by :func:`iob_decay`, add the dose
    delivered this step (U/min x min = U)."""
    return iob * iob_decay(sample_time) + insulin * float(sample_time)


@dataclasses.dataclass(frozen=True)
class PolicyParams:
    """Gaussian-MLP policy + value weights, and the static metadata that
    says how to run them: the trunk activation ``act`` and the action
    decoder (``decoder``, ``action_scale``, ``scale_by_basal``; see the JAX
    package's PolicyParams for the two decoders)."""

    w1: torch.Tensor  # [OBS_DIM, H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, H]
    b2: torch.Tensor  # [H]
    w_mu: torch.Tensor  # [H, 1]
    b_mu: torch.Tensor  # [1]
    log_std: torch.Tensor  # [1]
    w_v: torch.Tensor  # [H, 1]
    b_v: torch.Tensor  # [1]
    act: str = "tanh"
    action_scale: float = 0.2
    scale_by_basal: bool = False
    decoder: str = "sigmoid"

    def leaves(self) -> list:
        return [getattr(self, n) for n in LEAVES]

    def replace(self, **fields) -> "PolicyParams":
        return dataclasses.replace(self, **fields)


def param_specs(act: str = "tanh", action_scale: float = 0.2, scale_by_basal: bool = False,
                decoder: str = "sigmoid") -> PolicyParams:
    """The JAX ``param_specs``: for each leaf, the dimension that ``'tp'``
    splits (JAX's ``PartitionSpec`` position of ``'tp'``), or None where
    the leaf is replicated; the metadata as given.  The port, like the JAX
    trainers, keeps every leaf replicated and splits the compute:
    :func:`policy_apply` takes the ``tp`` rank's slice of ``w1``, ``b1``
    and ``w2`` by these dimensions and runs the heads whole (JAX computes
    them from the all-reduced second layer)."""
    return PolicyParams(w1=1, b1=0, w2=0, b2=None, w_mu=0, b_mu=None, log_std=None, w_v=0,
                        b_v=None, **_metadata(act, action_scale, scale_by_basal, decoder))


def _metadata(act, action_scale, scale_by_basal, decoder) -> dict:
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {ACTIVATIONS}; got {act!r}")
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be 'sigmoid' or 'residual_bb'; got {decoder!r}")
    return dict(act=act, action_scale=float(action_scale), scale_by_basal=bool(scale_by_basal),
                decoder=decoder)


def init_policy(
    generator: torch.Generator,
    hidden: int = 128,
    dtype=torch.float32,
    init_log_std: float = -0.5,
    init_mu_bias: float = 0.0,
    act: str = "tanh",
    action_scale: float = 0.2,
    scale_by_basal: bool = False,
    decoder: str = "sigmoid",
    device="cuda",
) -> PolicyParams:
    """He-initialised weights drawn from ``generator`` (a CPU
    ``torch.Generator``), then moved to ``device`` (``"cpu"`` for the CPU).  ``init_mu_bias`` shifts
    the initial action: a negative bias starts from under-insulinization.
    Use ``act='relu'`` for networks run by the rollout kernel."""
    meta = _metadata(act, action_scale, scale_by_basal, decoder)
    device = check_device(device)

    def he(shape):
        w = torch.randn(shape, generator=generator, dtype=dtype) * math.sqrt(2.0 / shape[0])
        return w.to(device)

    full = lambda n, v: torch.full((n,), v, dtype=dtype, device=device)
    return PolicyParams(
        w1=he((OBS_DIM, hidden)),
        b1=full(hidden, 0.0),
        w2=he((hidden, hidden)),
        b2=full(hidden, 0.0),
        w_mu=he((hidden, 1)) * 0.01,
        b_mu=full(1, init_mu_bias),
        log_std=full(1, init_log_std),
        w_v=he((hidden, 1)),
        b_v=full(1, 0.0),
        **meta,
    )


def policy_from_numpy(
    arrays,
    act: str = "tanh",
    action_scale: float = 0.2,
    scale_by_basal: bool = False,
    decoder: str = "sigmoid",
    dtype=torch.float32,
    device="cuda",
) -> PolicyParams:
    """PolicyParams from the nine JAX PolicyParams leaves as arrays, in
    field order ``w1 b1 w2 b2 w_mu b_mu log_std w_v b_v``, on ``device``."""
    arrays = list(arrays)
    device = check_device(device)
    if len(arrays) != len(LEAVES):
        raise ValueError(f"expected {len(LEAVES)} arrays ({' '.join(LEAVES)}); got {len(arrays)}")
    leaves = {
        n: torch.as_tensor(np.array(a), dtype=dtype).to(device) for n, a in zip(LEAVES, arrays)
    }
    H = leaves["b1"].shape[0]
    shapes = dict(w1=(OBS_DIM, H), b1=(H,), w2=(H, H), b2=(H,), w_mu=(H, 1), b_mu=(1,),
                  log_std=(1,), w_v=(H, 1), b_v=(1,))
    for n, shape in shapes.items():
        if tuple(leaves[n].shape) != shape:
            raise ValueError(f"leaf {n} has shape {tuple(leaves[n].shape)}, expected {shape}")
    return PolicyParams(**leaves, **_metadata(act, action_scale, scale_by_basal, decoder))


def load_policy_npz(path: str, dtype=torch.float32, device="cuda", **metadata) -> PolicyParams:
    """A policy checkpoint written by the JAX package's ``save_state`` (an
    npz of ``leaf_0`` .. ``leaf_8``), read without JAX.  ``metadata`` is
    the decoder the checkpoint was trained with (``act``,
    ``action_scale``, ``scale_by_basal``, ``decoder``): the file does not
    record it."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        if len(z.files) != len(LEAVES):
            raise ValueError(f"checkpoint has {len(z.files)} leaves, expected {len(LEAVES)}")
        arrays = [z[f"leaf_{i}"] for i in range(len(LEAVES))]
    return policy_from_numpy(arrays, dtype=dtype, device=device, **metadata)


def check_action_decoder(
    params: PolicyParams, action_scale: float, scale_by_basal: bool, where: str,
    decoder: str = "sigmoid",
) -> None:
    """Raise if a config's action decoder disagrees with the one the params
    were built for."""
    if (
        float(params.action_scale) != float(action_scale)
        or bool(params.scale_by_basal) != bool(scale_by_basal)
        or params.decoder != decoder
    ):
        raise ValueError(
            f"{where}: action decoder mismatch — params carry "
            f"decoder={params.decoder!r}, action_scale={params.action_scale}, "
            f"scale_by_basal={params.scale_by_basal} but the config uses "
            f"decoder={decoder!r}, action_scale={action_scale}, "
            f"scale_by_basal={scale_by_basal}. Build the params with "
            f"init_policy(...) matching the PPOConfig, or fix the config."
        )


def featurize_parts(cgm, insulin, cho, cgm_prev, iob, basal) -> torch.Tensor:
    """(CGM, insulin, CHO, previous-sample CGM, insulin-on-board, patient
    basal) -> [..., OBS_DIM] normalized features: cgm/400, (cgm-140)/100,
    tanh(insulin/(3 basal)), tanh(cho/10), tanh((cgm-cgm_prev)/10),
    tanh(iob/(120 basal)), tanh(20 basal)."""
    cgm, insulin, cho, cgm_prev, iob, basal = torch.broadcast_tensors(
        *(torch.as_tensor(x) for x in (cgm, insulin, cho, cgm_prev, iob, basal))
    )
    b = basal + 1e-8
    return torch.stack(
        [
            cgm / 400.0,
            (cgm - 140.0) / 100.0,
            torch.tanh(insulin / (3.0 * b)),
            torch.tanh(cho / 10.0),
            torch.tanh((cgm - cgm_prev) / 10.0),
            torch.tanh(iob / (120.0 * b)),
            torch.tanh(20.0 * basal),
        ],
        dim=-1,
    )


def featurize(result, basal, cgm_prev=None, iob=None) -> torch.Tensor:
    """A StepResult (leaves ``[B]``) -> ``[B, OBS_DIM]`` features (see
    :func:`featurize_parts`).  ``cgm_prev``/``iob`` default to the
    cold-start values, zero trend and zero insulin-on-board: exactly the
    episode-reset observation."""
    cgm = result.observation.CGM
    if cgm_prev is None:
        cgm_prev = cgm
    if iob is None:
        iob = torch.zeros_like(cgm)
    return featurize_parts(cgm, result.insulin, result.CHO, cgm_prev, iob, basal)


def round_to(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` (round to nearest even) and back
    to its own dtype.  None or float32 leaves it as it is: float32 compute
    is the inputs' own precision (a float64 plain version stays float64).
    A matmul of bfloat16-rounded float32 operands is the JAX package's
    reduced-precision dot with float32 accumulation: each product of two
    bfloat16 values is exact in float32.  Autograd through it rounds the
    gradient too, as JAX's transpose of a cast does."""
    if compute_dtype in (None, torch.float32) or compute_dtype == x.dtype:
        return x
    return x.to(compute_dtype).to(x.dtype)


class _TPCopy(torch.autograd.Function):
    """Megatron's *f*: the identity forward; backward, each gradient summed
    over the ``tp`` group (one all-reduce).  It marks where replicated
    values enter the split trunk, so that autograd gives every ``tp`` rank
    the whole gradient of a leaf of which each rank used a slice."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), ctx.mesh, "tp")
        return (None, *(p.view_as(g) for p, g in
                        zip(torch.split(flat, [g.numel() for g in grads]), grads)))


class _TPSum(torch.autograd.Function):
    """Megatron's *g*: forward, the ``tp`` ranks' partial products summed
    (one all-reduce: every rank gets the same bits); backward, the
    identity."""

    @staticmethod
    def forward(ctx, mesh, x):
        return all_reduce_sum(x.clone(), mesh, "tp")

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def _split_trunk(params: PolicyParams, obs, f, r, mesh):
    """The trunk with its hidden dimension split over the ``tp`` ranks: this
    rank's ``H/tp`` columns of layer 1 and its activation, then its rows of
    layer 2, the partials summed over the ``tp`` group, ``b2`` and the
    activation (:func:`param_specs`' split)."""
    H = params.b1.shape[0]
    if H % mesh.tp:
        raise ValueError(f"the hidden width {H} does not split over tp={mesh.tp}")
    cols = slice(mesh.tp_rank * (H // mesh.tp), (mesh.tp_rank + 1) * (H // mesh.tp))
    x = r(obs)
    if x.requires_grad:  # the partial input gradients summed before the rounding's transpose
        (x,) = _TPCopy.apply(mesh, x)
    w1, b1, w2 = _TPCopy.apply(mesh, params.w1, params.b1, params.w2)
    h = r(f(x @ r(w1[:, cols]) + b1[cols]))
    return r(f(_TPSum.apply(mesh, h @ r(w2[cols])) + params.b2))


def pack_head(params: PolicyParams):
    """The mean and value heads as one: ``w_head`` ``[H, 2]`` (columns mu,
    v) and ``b_head`` ``[2]``, the layout of :func:`policy_apply` and of
    the grad-step kernels."""
    return torch.cat([params.w_mu, params.w_v], dim=1), torch.cat([params.b_mu, params.b_v])


def policy_apply(params: PolicyParams, obs: torch.Tensor, compute_dtype=None, mesh=None):
    """(mu, log_std, value) for obs [..., OBS_DIM], at the params' dtype.

    ``compute_dtype=torch.bfloat16`` is the JAX package's bf16 trunk: both
    operands of every matmul and the stored hidden activations rounded to
    bfloat16 (:func:`round_to`), float32 accumulation (the matmuls run in
    float32 on the rounded values; TF32 must be off on the card), the bias
    adds and the heads' outputs float32.

    A ``mesh`` with ``tp > 1`` splits the trunk over its ``tp`` ranks
    (:func:`_split_trunk`; the hidden width must divide by ``tp``), each
    rank passing the same ``obs``; the heads run whole on every rank.
    Autograd through it gives every ``tp`` rank each leaf's whole gradient,
    counted once.  Without a mesh, or at ``tp == 1``, it is the one-process
    function."""
    f = torch.tanh if params.act == "tanh" else torch.relu
    r = lambda x: round_to(x, compute_dtype)
    if mesh is not None and mesh.tp > 1:
        h = _split_trunk(params, obs, f, r, mesh)
    else:
        h = r(f(r(obs) @ r(params.w1) + params.b1))
        h = r(f(h @ r(params.w2) + params.b2))
    w_head, b_head = pack_head(params)
    hv = h @ r(w_head) + b_head
    return hv[..., 0], params.log_std[0], hv[..., 1]


def gaussian_logprob(mu, log_std, x):
    z = (x - mu) * torch.exp(-log_std)
    return -0.5 * z * z - log_std - 0.5 * LOG_2PI


def sample_action(params: PolicyParams, obs: torch.Tensor, key: torch.Tensor, step,
                  scale: float = 0.2, mesh=None):
    """Sample a basal rate (U/min) per env: squash N(mu, std) through a
    sigmoid onto [0, scale].  The normal is the Philox draw of
    :func:`simglucose_tpu_torch.ops.streams.action_normal`: ``key`` the
    envs' ``[B, 4]`` trainer keys (seed pair, lane), ``step`` the global
    step (an int or a 0-d tensor), one normal per env and step.  ``mesh``
    splits the policy (:func:`policy_apply`).  Returns (basal, raw, logp,
    value), each ``[B]``."""
    mu, log_std, v = policy_apply(params, obs, mesh=mesh)
    eps = action_normal(key, step, mu.dtype)
    raw = mu + torch.exp(log_std) * eps
    logp = gaussian_logprob(mu, log_std, raw)
    basal = torch.sigmoid(raw) * scale
    return basal, raw, logp, v
