#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``simglucose_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero and prints
no result:

1. CUDA present; the card's name and power limit, torch/CUDA/nvcc versions.
2. Build the rollout kernel from ``simglucose_tpu_torch/csrc`` (nvcc,
   sm_90a); build time and ptxas' registers/spills.
3. Kernel vs its plain PyTorch version on the card (B=256, T=48) in every
   config of the rollout: Philox bits, deterministic and exogenous-noise
   configs (every lane within tolerance), stochastic configs (all but a
   stated fraction of lanes, every lane finite), chunked = single call.
4. The headline config (B=4096, T=4096, PID, auto-reset, Dexcom) through
   ``rollout`` on the card, law-gated with the benchmark's bands, two runs
   bit-identical, and the GuardianRT/Navigator gates at B=1024, T=576;
   env-steps/s of the kernel
   (CUDA events, after a warm-up) and of the plain version (B=4096, T=64),
   whose two outputs are held against each other.
5. ``simulate_cohort(device="cuda")``: first the kernel vs its plain
   version at the exact config and packing of the 30-patient x 24 h BB run
   (B=128, T=480); then the 30 reference patients x 24 h with BB and
   random meals, PID with a custom scenario, and 128 patients x 9 days (two
   chunked calls, equal to one uncut call); finite, right shape,
   law-sane, and the kernel's launch counter grows.
6. Fused PPO training, the second main path.  K1b (the rollout's 'nn'
   controller) vs its plain version at B=256, T=48: deterministic emit and
   plane modes with each decoder, a stochastic sampled config, the shipped
   relu64 checkpoint in eval mode, deterministic emit and plane modes at
   H=128 (init_policy's default width), chunked = single call; K1b, K2
   (GAE) and K3 (the PPO grad step) vs their plain versions at the bench
   config's shapes (B=8192, T=64; a 131072-row minibatch of 2048-row
   shuffle blocks) with times, K1b also at H=128 and each width's two runs
   bit-identical, K3 also at H=128 on the same minibatch, and the epoch-0
   ratio; then 10 iterations
   of the bench config through ``make_fused_train_loop`` (each launch
   counter grows, losses finite, params move, episodes carry), with
   ``fused_ppo_steps_per_sec`` / ``fused_ppo_iters_per_sec`` and the
   per-stage times.
7. Fused PPO training on the observation-plane path (``kernel_prep=False``),
   the third main path.  The learner's 12-row buffer built as the path
   builds it from a real plane-mode K1b rollout at the bench config; K4
   (the 12-row grad step) vs its plain version on a 131072-row minibatch,
   K5 (the whole learner in one cooperative launch) vs its plain version
   over 2 epochs x 4 minibatches of 64 blocks, two K5 runs bit-identical,
   K4 and K5 again at H=128 (K5 bit-identical too), K5 timed against the
   'step' learner (8 x K4 + the optimizer); then 10
   iterations of the bench config with each learner ('step', 'epoch',
   False): launch counters, finite losses, params moving, episodes
   carried, iterations and steps per second, per-stage times.
8. The roofline probe K6.  Each of the seven ops against its plain version
   at K=1-4 and 256, P=1, 4 and 16, and both launch shapes of the rate table
   (every replica of the 1024-element tile equal; bit for bit but fma);
   the float and MUFU opcodes of each op's one-chain kernel, where the
   toolkit has cuobjdump; then ``tools/roofline_rollout.py``'s rate table
   (each op at full occupancy and at K1a's launch shape, 1, 4 and 16 chains
   per thread, the SM clock beside each rate) and K1a's ceilings beside its
   measured headline env-steps/s, with K6's launch count.
9. Evaluation, the fourth main path.  K1b in ``evaluate_policy_kernel``'s
   exact config (the residual-BB checkpoint, stochastic environment) vs its
   plain version at B=256, T=480; the gates of ``tests/test_ppo_eval.py``
   with its margins (relu-64 vs PID, 30 patients x 6 h, seed 1234;
   residual-BB vs BB, 30 x 24 h, seeds 1234 and 77); the paired 4096-lane
   24 h policy-vs-BB comparison at seed 5 with its time to results; the
   K1b/K1a launch counts of the path.

10. The general env path (the eager, kernel-free env of
   ``simglucose_tpu_torch.envs``), on the card, nothing on the CPU: the
   reference oracle (``simulate_cohort(compat_mode=True)``, 30 patients x
   24 h, float64, against ``tests/golden/cohort_golden.npz`` with numpy at
   tests/test_cohort_golden.py's tolerances); the eager path against K1a at
   B=4096, T=480 (BB, a static custom meal scenario, the reference's MT19937
   noise fed to both, float32 rk4), with the shares of flipped doses and
   lanes; the native streams at 4096 x 24 h (PID, random meals, auto-reset)
   within the headline's law bands; one env step and one loop iteration
   under ``torch.cuda.set_sync_debug_mode("error")``; and times on the
   card: ``simulate_cohort`` 30 x 24 h on the eager path in float32 and in
   compat float64 beside the same float32 config on K1a, the eager path's
   env-steps/s at 4096 x 480, and its kernel launches per env step by
   ``torch.profiler``.
11. The bf16 learner (``PPOConfig.learner_bf16``) and the XLA-path trainer.
   The tensor cores: the HMMA instructions in the SASS of the bf16
   grad-step kernels (none may be 0; the float32 ones' beside them), with
   each kernel's registers, spills and shared memory.  K3, K4 and K5 at
   ``compute_dtype=bfloat16`` against their plain bf16 versions on phase
   6's kernel_prep buffer (K3) and phase 7's 12-row buffer (K4, K5), at
   H=64 and H=128, two K3, K4 and K5 runs bit-identical, each timed beside
   its float32 instantiation in the same run, and K5 at phase 7's 256
   shuffle blocks of 512 rows a minibatch; K3's bf16 path
   (``_update_packed`` with ``learner_bf16``) with its launches; the
   observation-plane path with ``learner_bf16`` and each learner (3
   iterations: launches, the epoch-0 ratio, params moving, metrics finite);
   ``make_train_step`` at ``tools/bench_ppo.py``'s config (B=8192, T=64,
   tanh H=128, random initial BG, Dexcom, 2 epochs x 4 minibatches) with
   the float32 autograd learner and bf16 'step' and 'epoch' (env-steps/s,
   launches per iteration, metrics), one rollout of it under
   ``set_sync_debug_mode("error")``; and
   ``evaluate_controller(policy_controller(relu64))`` at 30 patients x 24 h
   on the eager env path beside ``evaluate_policy_kernel`` at the same seed.
12. The single-device user API.  ``batch_sim`` over the 30 reference
   patients x 24 h (BB, random meals): one cohort call and one K1a launch,
   its planes bit-identical to ``simulate_cohort`` on the same arguments,
   and a PID and a BB SimObj as two calls, each its own
   ``simulate_cohort``; checkpoints: fused PPO at phase 6's config
   (kernel_prep, B=8192, T=64, relu 7-64-64) for 2 iterations, each saved
   through ``CheckpointManager(max_to_keep=1)``, restored into a fresh state
   of other params and another generator, one more iteration from each
   bit-identical in every leaf (K1b, K2, K3 counted), the same for a
   ``make_train_step`` state (B=1024, T=16, K4), and the residual-BB
   example through ``restore_state`` equal to ``load_policy_npz``;
   ``T1DSimVectorEnv`` at 4096 envs over one day: ``step_n(480)`` under
   ``set_sync_debug_mode("error")`` (BG finite and in (0, 600]),
   ``step_n(20)`` equal to 20 ``step()`` calls bit for bit at 256 envs, the
   env-steps/s of both; ``T1DSimGymEnv``: the reference's 23:00 start at
   seed 0, a 96-step compat episode on the card against the same on the
   CPU, and a native day; every time beside the card's name and power
   limit.
13. Multi-device (``torch.distributed``, one rank per device).  Two gloo
   ranks sharing the card, then a one-rank group of NCCL alone and one on
   the default backend (NCCL for card tensors, gloo for host tensors),
   each rank a fresh process running this script with ``--rank MODE RANK
   WORLD DIR`` (any failure exits non-zero and fails the phase): with
   ``mesh=``, ``simulate_cohort`` at 30 x 24 h and 1024 x 24 h (BB, random
   meals; K1a with ``lane0``) and ``evaluate_policy_kernel`` at 4096 x
   24 h (K1b plane mode), each equal to the one-process result bit for bit
   on every rank; the fused mesh trainer at phase 6's config (B=8192 split
   over the ranks, T=64, H=64, 'step') for 3 iterations, its first K4 call
   held to the plain version at phase 7's tolerance;
   ``make_train_step(mesh=)`` at B=1024, T=16, one iteration per learner;
   the gloo ranks' params bit-identical after every update, and each
   one-rank group's trainers (every learner, and the fused 'step'
   iteration) equal to the calls without a mesh, bit for bit ('epoch',
   which a mesh runs as autograd, to the autograd learner).  Each rank's
   launch counts equal to the paths' own (``md_expected_launches``); wall
   times per rank, labelled: two ranks sharing one card give no scaling
   number.
14. The port's tools and examples.  The trainer CLI
   (``python -m simglucose_tpu_torch.tools.train_ppo``) at full width:
   B=8192, H=64, T=64, the continuing task on the kernel_prep path, depth
   cut to 2 blocks x 2 iterations with an evaluation after each block
   (``PPO_EVAL_EVERY=1``), its checkpoint in a temporary directory: the
   K1b / K2 / K3 / K1a launches exact (``cli_expected_launches``), its
   numbers finite, the checkpoint restored and not the initial policy, no
   file under ``examples/checkpoints/`` changed; ``bench_ppo_fused`` and
   ``profile_fused_ppo quick`` at B=8192 (8 iterations a call), printing
   their JSON; ``utils.profiling.Throughput`` within 2% of CUDA events on
   one K1a headline call; ``device_trace``'s Chrome trace naming
   ``rollout_kernel``; the examples whose imports the card has
   (``EXAMPLES_ON_CARD``, at reduced depth) and the patient demo, the rest
   listed with what they need (``EXAMPLES_LEFT``).

The last two lines are a JSON object describing the kernels (each with its
time, its plain version's, and its bound: the least time the card could
take for the same work; K1a and K1b with their launch: lanes per patient,
threads per block, the grid's warps per SM (computed, not measured) and
ptxas' registers) and ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX, pandas or matplotlib.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from datetime import datetime, timedelta

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain version on the card.  Deterministic and exogenous-noise
# configs: every lane within these.  The kernel is built as shipped: nvcc
# contracts a*b+c into FMAs (PyTorch's separate kernels round each op), and
# CUDA's libm rounds exp/log/tanh/pow/sin/cos its own way, so BG/CGM drift
# by ulps per minute (measured on an NVIDIA H100 80GB HBM3 at 700 W, B=256,
# T=48: BG/CGM rel err <= 3.2e-6, reward abs err <= 1.3e-4, CHO exact); a
# pump command within an ulp of a rounding boundary quantizes one increment
# apart.
RTOL_GLUCOSE = 2e-5
# At the simulate shape (480 steps) some children reach BG ~0, where a
# relative tolerance means nothing: there BG/CGM may also differ by this
# much absolutely (mg/dL), a thousandth of what a sensor resolves.
ATOL_GLUCOSE_LONG = 1e-3
ATOL_REWARD = 5e-4
RTOL_CHO = 1e-6
# Stochastic configs: a lane whose done flag or pump increment flips at a
# boundary takes another branch (a reset draw, another dose) and leaves the
# plain version's path for the rest of the run; at most this share of lanes.
MAX_DIVERGED_LANES = 0.02

# Shapes of phase 4: the benchmark's headline config, its sensor gates, and
# the horizon at which the plain version is timed beside the kernel.
HEADLINE_B, HEADLINE_T = 4096, 4096
SENSOR_B, SENSOR_T = 1024, 576
PLAIN_T = 64

# Law bands of bench.py (_check_laws, _SENSOR_GATE_BANDS), copied because
# bench.py imports jax.
HEADLINE_BANDS = dict(bg_mean=(170.0, 240.0), done_rate=(0.003, 0.020),
                      resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0))
SENSOR_BANDS = {
    "GuardianRT": dict(bg_mean=(175.0, 240.0), done_rate=(0.005, 0.030),
                       resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0)),
    "Navigator": dict(bg_mean=(165.0, 230.0), done_rate=(0.0005, 0.010),
                      resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0)),
}

# Phase 6: bench.py's fused PPO config (bench_fused_ppo): B=8192 patients,
# T=64 steps per iteration, 2 epochs x 4 minibatches of 2048-row shuffle
# blocks, a relu 7-64-64 policy with mu bias -2.2.
FUSED_B, FUSED_T, FUSED_H = 8192, 64, 64
FUSED_ITERS = 10
# K3-K5 are also held at init_policy's default width (the grad step's
# 32-row tiles and its shared-memory opt-in), on the same buffers
WIDE_H = 128
# K1b vs its plain version, besides the trajectory tolerances above: the
# features within ATOL_FEATURES (the trend feature is a difference of two
# CGMs, each within RTOL_GLUCOSE; a dose one pump increment apart moves the
# insulin feature by up to 6e-4), the value / raw action / log-prob and the
# tail value within ATOL_NN + RTOL_NN |x| (the MLP sums in another order,
# with FMAs, over such features); insulin-on-board within IOB_FLIPS
# increments' doses.  Measured on an NVIDIA H100 80GB HBM3 at 700 W: the
# deterministic configs' features <= 1.3e-5 and value/raw/log-prob <= 9.1e-6
# (the trained relu64 policy's raw action <= 2.9e-4), the stochastic ones
# <= 3.7e-4 and <= 9.5e-4.
ATOL_FEATURES = 1e-3
ATOL_NN, RTOL_NN = 1e-3, 1e-3
IOB_FLIPS = 4
# K2: the same recurrence, with FMAs on the card (measured <= 7.7e-6 on
# advantages up to 44.5).
ATOL_GAE, RTOL_GAE = 1e-4, 1e-5
# K3: each gradient leaf within RTOL_GRAD of its largest magnitude
# (131072 rows summed in another order; measured <= 1e-6 of it); the pg and
# value loss means within ATOL_LOSS + RTOL_GRAD |x| (the pg sum cancels to
# ~0 over normalised advantages: its mean is ~1e-8, off by ~3.5e-9).
RTOL_GRAD = 1e-3
ATOL_LOSS = 1e-6
# The epoch-0 ratio: the behaviour log-prob from K1b against the one the
# learner recomputes at unchanged params (measured 9.5e-7).
ATOL_RATIO = 1e-5
# K5 against its plain version (the 'step' learner's loop over the plain
# grad step, FlatAdam): the JAX package's tolerances for its whole-learner
# kernel (tests/test_pallas_ppo_learner.py:195-212), eight Adam steps over
# gradients summed in another order.
RTOL_PARAMS, ATOL_PARAMS = 5e-3, 3e-5
RTOL_NU, ATOL_NU = 5e-3, 1e-7
RTOL_AUX, ATOL_AUX = 2e-3, 1e-4
# Phase 11: K3 and K4 at bf16 against their plain bf16 versions, each leaf
# within RTOL_GRAD_BF16 of its largest magnitude.  Summed in another order
# and with FMAs, an operand may come out an ulp apart and round to the
# other bfloat16 neighbour, which moves its products by 2^-8 of them.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W (131072 rows, H=64 and
# 128): <= 2.4e-7 of each leaf's largest magnitude, the loss means <= 1e-7;
# the host build flips operands on up to 5.9e-5 of it
# (tests/test_torch_learner_bf16.py, which holds it to 2e-4).  The plain
# bf16 step is ~3e-3 of each leaf's largest magnitude from the float32 one,
# so this bound also fails a kernel that skipped the rounding (checked in
# the run).  K5 keeps its float32 tolerances, and its first Adam moment, a
# running mean of the gradients, is held to this bound leaf by leaf, which
# the float32 plain learner must miss.
RTOL_GRAD_BF16 = 2e-4
# Phase 11's runs: the plane path's timed iterations per learner, and
# make_train_step at tools/bench_ppo.py's config (B=8192 patients, T=64
# steps an iteration) with its timed iterations after one warm-up.
PLANE_BF16_ITERS = 3
TRAIN_B, TRAIN_T, TRAIN_ITERS = 8192, 64, 2

# Phase 8: K6 against its plain version at every chain count the kernel is
# built for (ops/roofline.py KERNEL_P) and at both launch shapes of the rate
# table, every replica of the 1024-element tile equal.  At the short chains
# CHAIN_SMALL_K each op's plain version still moves from one K to the next
# (exp's only from K=1 to K=2: its float32 chain sits at 1 + 2^-20 from then
# on), so a kernel that ran other than K steps disagrees; CHAIN_CHECK_K holds
# a long chain.  Every op but fma runs the IEEE operations and the libm calls
# of PyTorch's kernels in the same order: bit for bit.  fma: nvcc contracts
# the multiply-add into one FFMA where PyTorch rounds twice, each step may
# differ by up to 2 ulp, the map expands by 1.000001 and every chain stays
# positive, so the sums may differ by 2 ulp per step, rtol_chain(K).  The
# largest share of it is taken at K=1, P=16, where the 15 additions'
# roundings weigh most: 0.933 on an NVIDIA H100 80GB HBM3 at 700 W, as a
# host emulation of the single-rounding FFMA predicts.
CHAIN_SMALL_K, CHAIN_CHECK_K = (1, 2, 3, 4), 256


def rtol_chain(K):
    return 2 * K * 2.0 ** -23


# Phase 9, evaluation: K1b in evaluate_policy_kernel's config against its
# plain version at this shape (the plain version takes ~3 s per 64 steps at
# 8192 lanes: never at 4096 x 480), then the paired comparison at scale.
EVAL_CHECK_B, EVAL_CHECK_T = 256, 480
EVAL_SCALE_B, EVAL_SCALE_SEED = 4096, 5

# Phase 10, the general env path.  The cross-engine run at full size, the
# native-stream run, and the reference oracle's tolerances
# (tests/test_cohort_golden.py: BG rtol 1e-5; CGM atol 1e-3; CHO rtol
# 1e-12; insulin rtol 1e-12 or one pump increment; risk rtol 1e-4, atol
# 1e-3).
ENV_B, ENV_T = 4096, 480
ENV_MEALS = dict(det_meal_times=(60, 420, 720, 1080), det_meal_amounts=(10.0, 45.0, 70.0, 80.0))
# The eager path against K1a: tests/test_torch_rollout_exo.py's glucose
# tolerance, rtol 2e-6 (plus ATOL_GLUCOSE_LONG where a child's BG nears 0),
# the other planes as lane_disagreement holds them (a dose one pump
# increment apart, CHO to RTOL_CHO: the kernel multiplies by float32(1/st)
# where the eager path divides); every lane but MAX_DIVERGED_LANES.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W: every lane within, BG/CGM
# rel err <= 1.6e-6, 7e-5 of the doses one increment apart.
RTOL_ENGINES = 2e-6

# Phase 12, the user API: make_train_step resumed at a small batch (phase 11
# runs its full width); the vector env at 4096 envs over one day (480 Dexcom
# steps; its horizon) and step_n against step() at 256 envs for 20 steps
# (half of them at the pump's 30 U/min, which ends episodes in ~10 steps);
# a single env's 96-step compat episode and a native day; the seeds and the
# constant basal (U/min) the runs use.
API_TRAIN_B, API_TRAIN_T = 1024, 16
API_VEC_B, API_VEC_T = 4096, 480
API_VEC_CHECK_B, API_VEC_CHECK_T = 256, 20
API_GYM_COMPAT_T, API_GYM_NATIVE_T = 96, 480
API_SEED, API_BASAL = 11, 0.015
# A compat episode on the card against the same on the CPU: float64 both,
# the same host-made noise, meals and initial state; CUDA's libm and the
# CPU's round exp/log/pow apart by an ulp or so, so BG within RTOL_GYM_BG;
# the meals and the doses (the pump quantizes a constant basal) within
# RTOL_GYM_DOSE, the golden tests' tolerance for CHO and insulin.
RTOL_GYM_BG = 1e-9
RTOL_GYM_DOSE = 1e-12

# Phase 13, multi-device: the ranks' paths and shapes.  simulate_cohort at
# the 30 reference patients and at MD_SIM_B patients (24 h, BB, random
# meals), evaluate_policy_kernel at MD_EVAL_B lanes x 24 h (the residual-BB
# checkpoint), the fused mesh trainer at phase 6's config (B=8192 split over
# the ranks, T=64, H=64, 'step') for MD_FUSED_ITERS iterations, and
# make_train_step at MD_TRAIN_B patients, MD_TRAIN_T steps, one iteration
# per learner.  Every rank process must finish within MD_TIMEOUT_S.
MD_SIM_B, MD_EVAL_B = 1024, 4096
MD_FUSED_ITERS = 3
MD_TRAIN_B, MD_TRAIN_T = 1024, 16
MD_LEARNERS = (("step", False), ("step", True), ("epoch", False), (False, False))
MD_EPOCHS, MD_MINIBATCHES = 2, 4
MD_TIMEOUT_S = 300
# The rank processes: two gloo ranks sharing the card, one rank of a group
# of NCCL alone, and one of initialize()'s default group (NCCL for card
# tensors, gloo for host tensors).
MD_MODES = (("gloo", 2, "gloo"), ("nccl", 1, "nccl"), ("default", 1, None))
# Phase 14: the trainer CLI's depth (blocks x iterations, an evaluation
# after each block), the fused benches' iterations a call, and the examples
# run on the card (with their cuts) or left to tier-1 (with what the card's
# machine lacks for them)
TOOLS_CLI_SHAPE = (2, 2)
TOOLS_BENCH_ITERS = 8
EXAMPLES_ON_CARD = {
    "custom_reward_function": {},
    "fast_cohort_sim": {},
    "train_ppo": dict(iters=1, rollout_steps=16),
    "train_ppo_fused": dict(blocks=1, iters_per_block=2),
}
EXAMPLES_LEFT = {
    "advanced_tutorial": "pandas",
    "apply_customized_controller": "pandas",
    "eval_ppo": "pandas",
    "offline_analysis": "pandas, matplotlib",
    "run_gym": "gymnasium",
    "run_pid_controller": "pandas",
    "run_user_interface": "interactive",
}

# The card's peak rates for a kernel's bound (the least time it could take:
# the larger of its bytes over the memory rate and its operations over the
# rate of their pipe).  One H100 SXM at its full 700 W: 3.35 TB/s of HBM,
# 67 TFLOP/s of float32 outside the tensor cores (NVIDIA's data sheet),
# which is 132 SMs x 128 lanes x 2 FLOP at 1.98 GHz; transcendentals
# (exp, log, tanh, sin, cos, sqrt) go through the special-function units,
# 16 results per SM per clock on compute capability 9.0 (the CUDA
# programming guide's throughput table) at that clock.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# Operations per env step of the rollout kernels: K1a's count by op class,
# simglucose_tpu_torch/tools/roofline_rollout.py::k1a_mix (from
# csrc/rollout_math.cuh; 1561 FLOP and 27.6 transcendentals per step at the
# PID headline config).  The 'nn' controller adds per step the MLP
# (2 (9H + H^2) FLOP), ~25 FLOP of features, decoder and log-prob, and 9
# transcendentals (5 tanh features, the sigmoid's exp, the action noise's
# log, sqrt and cos).
NN_FLOP_PER_STEP, NN_SFU_PER_STEP = 25, 9
# The bf16 grad steps' bound: their products are bfloat16 matmuls with
# float32 accumulation, whose fastest pipe is the tensor cores: 989 TFLOP/s
# of dense bf16 on one H100 SXM (NVIDIA's data sheet).  The kernels run
# their three H x H products there as mma.sync tiles (phase 11 counts the
# HMMA instructions), and the rest of the step on the CUDA cores.
BF16_FLOP_PER_S = 989e12


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def say(*parts):
    print(*parts, flush=True)


def bound(flop, nbytes, sfu=0.0, flop_per_s=F32_FLOP_PER_S):
    """(bound_ms, bound_by): the least time for ``flop`` operations at
    ``flop_per_s`` (float32 outside the tensor cores by default), ``sfu``
    transcendentals and ``nbytes`` of device memory traffic, the pipes
    running side by side."""
    ops_ms = 1e3 * max(flop / flop_per_s, sfu / SFU_OPS_PER_S)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def grad_step_flop(rows, H):
    """FLOP of one PPO grad step over ``rows`` rows of a 7-H-H-2 MLP:
    forward (9H + H^2 MACs), backward (11H + 2H^2 MACs) and ~8H of biases,
    activations and their derivatives per row."""
    return rows * (2 * (20 * H + 3 * H * H) + 8 * H)


def rollout_bound(cfg, B, H=None):
    """Bound of one rollout call of ``cfg`` over B patients: the packed
    parameters read, the trajectory planes, reset row, final state and (for
    the 'nn' controller) weights and learner rows or observation planes
    written, and K1a's operations (``k1a_mix``) with the 'nn' controller's
    counted above in place of the PID's."""
    from simglucose_tpu_torch.tools.roofline_rollout import k1a_mix, mix_flop, mix_sfu

    T = cfg.n_steps
    steps = B * T
    mix = k1a_mix(cfg.sample_time, cfg.controller)
    flop = steps * mix_flop(mix)
    sfu = steps * mix_sfu(mix)
    floats = 50 * B + 6 * steps + 2 * B + (64 + 7) * B
    if H is not None:
        flop += steps * (2 * (9 * H + H * H) + NN_FLOP_PER_STEP)
        sfu += steps * NN_SFU_PER_STEP
        floats += H * (H + 16) + (10 if cfg.nn_emit_learner_rows else 6) * steps + 5 * B
    return bound(flop, 4 * floats, sfu)


def kernel_entry(name, src, replaces, launches, err, ms, plain_ms, bound_ms_by, shape,
                 queued_ms=None, launch=None):
    """One kernel's entry of the summary line.  ``ms`` is by CUDA events
    around each call (as in every earlier line); ``queued_ms``, where
    given, the same calls issued back to back (:func:`queued_ms`);
    ``launch``, where given, the fields of :func:`rollout_launch`.  No
    single PyTorch call computes any of the port's kernels, so
    ``library_ms`` is null."""
    entry = dict(name=name, route="cuda", source=f"simglucose_tpu_torch/csrc/{src}",
                 replaces=replaces, launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1], library_ms=None, shape=shape)
    if queued_ms is not None:
        entry["queued_ms"] = queued_ms
    entry.update(launch or {})
    return entry


def ptxas_spills(ptxas, kernel):
    """(spill stores, spill loads) in bytes that ptxas reported for the
    first entry function whose mangled name holds ``kernel``, or None."""
    current = None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            current = line
        elif current and kernel in current and "spill stores" in line:
            words = line.replace(",", " ").split()
            return (int(words[words.index("spill") - 2]),
                    int(words[len(words) - 1 - words[::-1].index("spill") - 2]))
    return None


def sass_sites(path):
    """``tools/rollout_ab.py``'s SASS summary of the library at ``path``
    (cuobjdump -sass), or None where the toolkit has no cuobjdump."""
    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.tools.rollout_ab import sass_sites as sites

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    return sites(subprocess.run([cuobjdump, "-sass", path], check=True, capture_output=True,
                                text=True, timeout=300).stdout)


def ptxas_registers(ptxas, kernel):
    """Registers ptxas gave the first entry function whose mangled name
    holds ``kernel`` (e.g. ``rollout_nn_kernelE``), or None."""
    current = None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            current = line
        elif current and kernel in current and "Used" in line and "registers" in line:
            return int(line.split("Used")[1].split()[0])
    return None


def rollout_launch(tr, build, kernel, B):
    """The launch of K1a ('rollout_kernel') or K1b ('rollout_nn_kernel') over
    B patients: lanes per patient and threads per block (the launcher's
    constants), ``launch_warps_per_sm`` (computed: the grid's warps over the
    SMs, as if spread evenly; not a measured occupancy) and the registers
    ptxas gave the kernel in this run's build."""
    import torch

    k1a = kernel == "rollout_kernel"
    G, tpb = (tr.K1A_GROUP, tr.K1A_THREADS) if k1a else (tr.K1B_GROUP, tr.K1B_THREADS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(group=G, threads_per_block=tpb, launch_warps_per_sm=B * G / 32 / sms,
                registers=ptxas_registers(build.BUILD_INFO["ptxas"], f"{kernel}E"))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def law_stats(traj, sample_time):
    """bench.py's _law_stats: BG mean, done rate, CGM-BG residual std
    (population std), CHO per day."""
    bg = traj["BG"]
    return dict(
        bg_mean=bg.mean().item(),
        done_rate=traj["done"].float().mean().item(),
        resid_std=(traj["CGM"] - bg).std(correction=0).item(),
        cho_per_day=traj["CHO"].mean().item() * sample_time * (1440 // sample_time),
    )


def gate(name, stats, bands):
    for k, (lo, hi) in bands.items():
        check(lo <= stats[k] <= hi, f"law violation: {name}.{k}={stats[k]:.6g} outside [{lo}, {hi}]")


def main():
    # ---- 1. CUDA ----
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py runs on a machine with an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import simglucose_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(simglucose_tpu_torch.__file__)))
    check(pkg_root == ROOT, f"simglucose_tpu_torch imported from {pkg_root}, not from this checkout")
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.ops.philox import philox_words
    from simglucose_tpu_torch.sim import engine
    from simglucose_tpu_torch.sim.engine import simulate_cohort

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    say("== 1 cuda")
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" count {torch.cuda.device_count()}")

    # ---- 2. build ----
    say("== 2 build")
    build.load_library()
    info = build.BUILD_INFO
    say(f"nvcc: {info['nvcc']}")
    say(f"built {info['path']} in {info['build_seconds']:.2f} s")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("ptxas:", line.strip())

    def packed_for(names, quest=True):
        p = tables.load_patient_params(names, device=dev)
        q = tables.load_quest_params(names, device=dev) if quest else None
        return tr.pack_params(p, basal_rate(p), quest=q)

    # ---- 3. kernel vs plain version ----
    say("== 3 kernel vs plain version (B=256, T=48)")
    B, T = 256, 48
    for c1, c2 in ((0, 0), (17, 3), (4095, 14)):
        w_gpu = philox_words(4096, (123456789, 987654321), c1, c2, device=dev).cpu()
        w_cpu = philox_words(4096, (123456789, 987654321), c1, c2, device="cpu")
        check(torch.equal(w_gpu, w_cpu), f"Philox words differ at counters (*, {c1}, {c2})")
    say("philox: kernel and plain version draw identical words")

    names = tables.cohort_names(B)
    packed = packed_for(names)
    gen = torch.Generator().manual_seed(0)
    rnoise = (10 * torch.randn(2, B // 128, 128, generator=gen)).to(dev)
    snoise = (10 * torch.randn(T, B // 128, 128, generator=gen)).to(dev)
    meals = dict(det_meal_times=(3, 10, 60), det_meal_amounts=(30.0, 25.0, 50.0))
    ladder = [
        # (name, config, extra args, stochastic)
        ("det_pid", tr.RolloutConfig(n_steps=T, deterministic=True, controller="pid"), {}, False),
        ("det_bb_meals", tr.RolloutConfig(n_steps=T, deterministic=True, controller="bb", **meals), {}, False),
        ("det_navigator", tr.config_for_sensor("Navigator", n_steps=T, deterministic=True), {}, False),
        ("det_guardianrt", tr.config_for_sensor("GuardianRT", n_steps=T, deterministic=True), {}, False),
        ("exo_bb", tr.RolloutConfig(n_steps=T, deterministic=True, exogenous_noise=True, autoreset=False,
                                    controller="bb", **meals),
         dict(reset_noise=rnoise, step_noise=snoise), False),
        ("static_exo_bb", tr.RolloutConfig(n_steps=T, scenario_kind="static", exogenous_noise=True,
                                           autoreset=False, random_init_bg=False, fixed_start_min=0,
                                           controller="bb", **meals),
         dict(reset_noise=rnoise, step_noise=snoise), False),
        ("static_native_pid", tr.RolloutConfig(n_steps=T, scenario_kind="static", autoreset=False,
                                               fixed_start_min=0, controller="pid", **meals), {}, True),
        ("stoch_pid_autoreset", tr.RolloutConfig(n_steps=T, controller="pid", fixed_start_min=1380,
                                                 bg_done_high=180.0), {}, True),
        ("stoch_bb_fixed_horizon", tr.RolloutConfig(n_steps=T, controller="bb", autoreset=False,
                                                    random_init_bg=False, fixed_start_min=1380), {}, True),
        ("stoch_const_guardianrt", tr.config_for_sensor("GuardianRT", n_steps=T, controller="const",
                                                        const_basal=0.02, reward_kind="neg_risk"), {}, True),
    ]
    max_abs_err = 0.0
    for name, cfg, extra, stochastic in ladder:
        key = (11, 29)
        plain = tr.rollout_reference(cfg, packed, key, **extra)
        kern = tr.rollout(cfg, packed, key, **extra)
        errs = compare(name, cfg, kern, plain, stochastic)
        if not stochastic:
            max_abs_err = max(max_abs_err, errs["BG_abs"])
        if name == "det_pid":  # the state carried into a second call
            plain2 = tr.rollout_reference(cfg, packed, key, state=(plain["state_f"], plain["state_i"]),
                                          init=0, step_offset=T)
            kern2 = tr.rollout(cfg, packed, key, state=(kern["state_f"], kern["state_i"]), init=0,
                               step_offset=T)
            bad2, _ = lane_disagreement(cfg, kern2, plain2)
            check(not bad2.any(), "det_pid: the continued call disagrees")
            check(torch.equal(kern2["state_i"], plain2["state_i"]), "det_pid: int state planes differ")

    # a horizon cut into two calls equals the single call, on the card too
    cfg = tr.RolloutConfig(n_steps=T, controller="pid", fixed_start_min=1380, bg_done_high=180.0)
    half = tr.RolloutConfig(n_steps=T // 2, controller="pid", fixed_start_min=1380, bg_done_high=180.0)
    one = tr.rollout(cfg, packed, (5, 6))
    a = tr.rollout(half, packed, (5, 6))
    b = tr.rollout(half, packed, (5, 6), state=(a["state_f"], a["state_i"]), init=0, step_offset=T // 2)
    for k in ("BG", "CGM", "CHO", "insulin", "reward", "done"):
        check(torch.equal(torch.cat([a[k], b[k]]), one[k]), f"chunked kernel run differs in {k}")
    check(torch.equal(b["state_f"], one["state_f"]), "chunked kernel state differs")
    say("chunked: two kernel calls equal one, bit for bit")

    # the Quest sentinel: BB without Quest goes NaN at the first bolus
    nq = tr.RolloutConfig(n_steps=2, deterministic=True, controller="bb", det_meal_times=(0,),
                          det_meal_amounts=(30.0,))
    ins = tr.rollout(nq, packed_for(names, quest=False), 0)["insulin"]
    check(torch.isfinite(ins[0]).all() and torch.isnan(ins[1]).all(), "BB without Quest did not go NaN")
    say("quest sentinel: BB without Quest goes NaN at the first bolus")

    # ---- 4. headline config and sensor gates ----
    say("== 4 headline: B=4096, T=4096, PID, auto-reset, Dexcom")
    Bh, Th = HEADLINE_B, HEADLINE_T
    packed_h = packed_for(tables.cohort_names(Bh), quest=False)
    head = tr.RolloutConfig(n_steps=Th, controller="pid")
    traj = tr.rollout(head, packed_h, (0, 0))  # warm-up
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(5)]
    for i, (start, end) in enumerate(events):
        start.record()
        traj = tr.rollout(head, packed_h, (i + 1, 0))
        end.record()
    torch.cuda.synchronize()
    call_ms = sorted(start.elapsed_time(end) for start, end in events)
    rate = Bh * Th / (call_ms[len(call_ms) // 2] / 1e3)
    stats = law_stats(traj, head.sample_time)
    say(f"kernel: ms per call over {len(call_ms)} calls {call_ms}; "
        f"env_steps_per_sec (median call) {rate:.6g}")
    say("laws:", json.dumps(stats))
    gate("headline", stats, HEADLINE_BANDS)
    check(torch.isfinite(traj["BG"]).all(), "headline BG not finite")
    again = tr.rollout(head, packed_h, (len(events), 0))  # the last timed call's key
    check(bit_identical(traj, again), "two K1a runs of the headline differ")
    say("headline: two kernel runs bit-identical")

    for sensor, bands in SENSOR_BANDS.items():
        scfg = tr.config_for_sensor(sensor, controller="pid", n_steps=SENSOR_T)
        rows = packed_h[:, : SENSOR_B // 128].contiguous()
        st = law_stats(tr.rollout(scfg, rows, (11, 0)), scfg.sample_time)
        say(f"{sensor} (B={SENSOR_B}, T={SENSOR_T}) laws:", json.dumps(st))
        gate(sensor, st, bands)

    # kernel and plain version at one shape, in turns; then their outputs
    # held against each other (a stochastic config)
    short = tr.RolloutConfig(n_steps=PLAIN_T, controller="pid")
    times, outs = {"kernel": [], "plain": []}, {}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = tr.rollout_reference if which == "plain" else tr.rollout
        torch.cuda.synchronize()
        tic = time.perf_counter()
        outs[which] = fn(short, packed_h, (3, 0))
        torch.cuda.synchronize()
        times[which].append(1e3 * (time.perf_counter() - tic))
    kern_ms, plain_ms = min(times["kernel"]), min(times["plain"])
    say(f"B={Bh}, T={PLAIN_T}: kernel {kern_ms:.3f} ms ({Bh * PLAIN_T / kern_ms * 1e3:.6g} env-steps/s), "
        f"plain version {plain_ms:.3f} ms ({Bh * PLAIN_T / plain_ms * 1e3:.6g} env-steps/s)")
    compare(f"headline_pid B={Bh} T={PLAIN_T}", short, outs["kernel"], outs["plain"], stochastic=True)

    # ---- 5. simulate_cohort on the card: the main path ----
    say("== 5 simulate_cohort(device='cuda')")
    # the kernel against its plain version at the first run's exact config
    # and packing (30 patients padded to 128 lanes, 480 steps)
    names30 = tables.patient_names()
    cfg30 = engine.kernel_config("Dexcom", "Insulet", None, 480, 0, False)
    packed30 = packed_for([names30[i % 30] for i in range(128)])
    check(cfg30.n_steps == 480 and cfg30.controller == "bb" and not cfg30.autoreset, f"config {cfg30}")
    plain = tr.rollout_reference(cfg30, packed30, (1, 2))
    kern = tr.rollout(cfg30, packed30, (1, 2))
    errs = compare("simulate_bb_30x24h B=128 T=480", cfg30, kern, plain, stochastic=True,
                   atol_glucose=ATOL_GLUCOSE_LONG)
    max_abs_err = max(max_abs_err, errs["BG_abs"])
    say(f"  lowest BG: kernel {kern['BG'].min().item():.4f}, plain {plain['BG'].min().item():.4f} mg/dL")

    tr.LAUNCHES["rollout"] = 0
    runs = [
        ("30 patients x 24 h, BB, random meals", dict(sim_time=timedelta(days=1), scenario_seed=1, cgm_seed=2),
         30, 480, True),
        ("30 patients x 24 h, PID, custom scenario",
         dict(sim_time=timedelta(days=1), controller=("PID", dict(P=2e-4, I=1e-7)),
              scenario=[(7, 45), (12, 70), (18, 80)], cgm_seed=3),
         30, 480, False),
        ("128 patients x 9 days, BB, random meals (chunked)",
         dict(sim_time=timedelta(days=9), patient_names=tables.cohort_names(128), scenario_seed=4, cgm_seed=5),
         128, 9 * 480, True),
    ]
    for label, kw, nb, nt, random_meals in runs:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        res = simulate_cohort(device="cuda", **kw)
        wall = time.perf_counter() - tic
        bg, cgm, cho = res.traj.BG, res.traj.CGM, res.traj.CHO
        check(bg.shape == (nt, nb) and res.reward.shape == (nt, nb) and res.reset.BG.shape == (nb,),
              f"{label}: shapes {bg.shape} {res.reward.shape} {res.reset.BG.shape}")
        for f, v in zip(res.traj._fields, res.traj):
            check(bool((v == v).all()) and abs(v).max() < 1e6, f"{label}: {f} not finite")
        bg_mean, resid = float(bg.mean()), float((cgm - bg).std())
        cho_day = float(cho.mean()) * 3 * 480
        say(f"{label}: {wall:.3f} s to results; BG mean {bg_mean:.2f}, min {bg.min():.1f}, "
            f"max {bg.max():.1f}; CGM-BG std {resid:.3f}; CHO/day {cho_day:.1f} g")
        # BB therapy takes child#008 to BG ~0 in the model itself: the JAX
        # package's simulate(engine="xla") on the CPU, 30 patients x 24 h BB
        # with random meals, gives it a lowest BG of -0.001 mg/dL (seeds 1, 2)
        # and 3.72 (seeds 2, 3).  The gate is the cohort's mean and bounds.
        check(80.0 < bg_mean < 250.0 and bg.min() > -1.0 and bg.max() < 600.0, f"{label}: BG not sane")
        check(5.0 < resid < 20.0, f"{label}: sensor noise scale off")
        check((160.0 < cho_day < 280.0) if random_meals else abs(cho_day - 195.0) < 1e-2,
              f"{label}: CHO/day {cho_day}")
    launches = tr.LAUNCHES["rollout"]
    check(launches >= 4, f"the main path launched the rollout kernel {launches} times")
    say(f"rollout kernel launches on the main path: {launches}")

    # the last run's horizon went as two calls; one uncut call is the same
    cap, engine.MAX_STEPS_PER_CALL = engine.MAX_STEPS_PER_CALL, 1 << 30
    whole = simulate_cohort(device="cuda", **runs[-1][1])
    engine.MAX_STEPS_PER_CALL = cap
    check(all(bool((a == b).all()) for a, b in zip(res.traj + res.reset, whole.traj + whole.reset))
          and bool((res.reward == whole.reward).all()), "chunked simulate differs from one uncut call")
    say("chunked simulate: two calls equal one uncut call, bit for bit")

    k3_case, fused_kernels = phase_fused(dev, tables, tr, packed_for)
    plane_case, plane_kernels = phase_plane(dev, tables, tr, packed_for)
    roofline_kernels = phase_roofline(dev, smi)
    phase_eval(dev, tables, tr)
    phase_env(dev, smi, tables, tr)
    bf16_kernels = phase_bf16(dev, smi, tables, k3_case, plane_case)
    phase_api(dev, smi, tables, tr)
    phase_multidevice(dev, smi, tables)
    phase_tools(dev, smi, tables, tr)

    say(smi)
    k1a = kernel_entry("rollout_k1a", "rollout.cu", "simglucose_tpu/ops/pallas_rollout.py:646", launches,
                       max_abs_err, kern_ms, plain_ms, rollout_bound(short, Bh), f"B={Bh},T={PLAIN_T}",
                       launch=rollout_launch(tr, build, "rollout_kernel", Bh))
    say(json.dumps({"kernels": [k1a] + fused_kernels + plane_kernels + roofline_kernels
                    + bf16_kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def phase_env(dev, smi, tables, tr):
    """Phase 10: the general env path on the card."""
    import torch

    from simglucose_tpu_torch.compat.noise import reference_cgm_noise
    from simglucose_tpu_torch.controllers.functional import bb_params, bb_policy, pid_controller
    ero = importlib.import_module("simglucose_tpu_torch.envs.rollout")
    from simglucose_tpu_torch.envs.build import make_env
    from simglucose_tpu_torch.envs.functional import env_reset, env_step
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.sim.engine import simulate_cohort

    say("== 10 general env path (eager, on the card)")
    say(smi)
    tr.LAUNCHES["rollout"] = 0

    # ---- the reference oracle on the card ----
    names30 = tables.patient_names()
    oracle = dict(sim_time=timedelta(days=1), scenario_seed=1, cgm_seed=1,
                  start_time=datetime(2018, 1, 1), device=dev)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    res = simulate_cohort(compat_mode=True, **oracle)
    compat_s = time.perf_counter() - tic
    check(tr.LAUNCHES["rollout"] == 0, "compat_mode launched the rollout kernel")
    check(res.traj.BG.dtype == np.float64 and res.traj.BG.shape == (480, 30), "compat planes")
    g = np.load(os.path.join(ROOT, "tests", "golden", "cohort_golden.npz"))
    worst = dict(BG=0.0, CGM=0.0, insulin_flips=0)
    for b, name in enumerate(names30):
        row = lambda f: np.concatenate([[getattr(res.reset, f)[b]], getattr(res.traj, f)[:, b]])
        bg, ref = row("BG"), g[f"{name}/BG"]
        check(bg.shape == ref.shape, f"oracle {name}: {bg.shape} rows, golden {ref.shape}")
        check(np.allclose(bg, ref, rtol=1e-5, atol=0), f"oracle {name}: BG beyond rtol 1e-5")
        check(np.allclose(row("CGM"), g[f"{name}/CGM"], rtol=0, atol=1e-3), f"oracle {name}: CGM")
        check(np.allclose(res.traj.CHO[:, b], g[f"{name}/CHO"][:-1], rtol=1e-12, atol=0),
              f"oracle {name}: CHO")
        ins, ref_ins = res.traj.insulin[:, b], g[f"{name}/insulin"][:-1]
        check(np.allclose(ins, ref_ins, rtol=1e-12, atol=0.05 / 6000 * 1.01), f"oracle {name}: insulin")
        check(np.allclose(row("risk"), g[f"{name}/Risk"], rtol=1e-4, atol=1e-3), f"oracle {name}: risk")
        worst["BG"] = max(worst["BG"], float(np.max(np.abs(bg - ref) / np.abs(ref))))
        worst["CGM"] = max(worst["CGM"], float(np.max(np.abs(row("CGM") - g[f"{name}/CGM"]))))
        worst["insulin_flips"] += int((~np.isclose(ins, ref_ins, rtol=1e-12, atol=0)).sum())
    say(f"reference oracle, 30 x 24 h compat float64 on the card: {compat_s:.3f} s; "
        f"max BG rel err {worst['BG']:.3g}, max CGM abs err {worst['CGM']:.3g} mg/dL, "
        f"doses one increment apart {worst['insulin_flips']}")

    # ---- 30 x 24 h: the eager path in float32 beside K1a ----
    walls = {}
    for label, kw in (("eager f32", dict(engine="xla")), ("K1a f32", dict(engine="auto"))):
        before = tr.LAUNCHES["rollout"]
        torch.cuda.synchronize()
        tic = time.perf_counter()
        r = simulate_cohort(**oracle, **kw)
        walls[label] = time.perf_counter() - tic
        check(np.isfinite(r.traj.BG).all() and r.traj.BG.shape == (480, 30), f"{label}: planes")
        launched = tr.LAUNCHES["rollout"] - before
        check(launched == (1 if label.startswith("K1a") else 0), f"{label}: {launched} K1a launches")
        bg_mean, resid = float(r.traj.BG.mean()), float((r.traj.CGM - r.traj.BG).std())
        check(80.0 < bg_mean < 250.0 and 5.0 < resid < 20.0, f"{label}: BG mean {bg_mean}, resid {resid}")
    say(f"simulate_cohort 30 x 24 h BB random meals, wall: eager float32 {walls['eager f32']:.3f} s, "
        f"compat float64 {compat_s:.3f} s, K1a float32 {walls['K1a f32']:.4f} s ({smi})")

    # ---- the eager path against K1a at full size ----
    B, T = ENV_B, ENV_T
    names = tables.cohort_names(B)
    noise = reference_cgm_noise(tables.sensor_record("Dexcom"), 1, T + 2).astype(np.float32)
    plane = lambda a: torch.from_numpy(a).to(dev)[:, None, None].expand(len(a), B // 128, 128).contiguous()
    kcfg = tr.RolloutConfig(n_steps=T, scenario_kind="static", exogenous_noise=True, autoreset=False,
                            random_init_bg=False, fixed_start_min=0, controller="bb", **ENV_MEALS)
    patient = tables.load_patient_params(names, device=dev)
    quest = tables.load_quest_params(names, device=dev)
    kern = tr.rollout(kcfg, tr.pack_params(patient, basal_rate(patient), quest=quest), (1, 1),
                      reset_noise=plane(noise[:2]), step_noise=plane(noise[2:]))
    cfg, params = make_env(names, batch=True, device=dev, noise_seq=noise,
                           custom_times=np.asarray(kcfg.det_meal_times, np.int32),
                           custom_amounts=np.asarray(kcfg.det_meal_amounts, np.float32),
                           scenario_mode="custom")
    bb = bb_params(params.patient, quest)
    policy = bb_policy(cfg.sample_time)
    keys = env_keys((1, 1), B, device=dev)

    before = tr.LAUNCHES["rollout"]
    torch.cuda.synchronize()
    tic = time.perf_counter()
    _, res0, traj = ero.rollout(cfg, params, keys, bb, policy, T, start_min=0)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - tic
    check(tr.LAUNCHES["rollout"] == before, "the eager path launched the rollout kernel")
    eager = dict(BG=traj.BG, CGM=traj.CGM, reward=traj.reward, CHO=traj.CHO, insulin=traj.insulin,
                 done=traj.done.float(), BG0=res0.BG, CGM0=res0.CGM)
    say(f"eager path B={B}, T={T}, BB, static meals, reference noise: {eager_s:.3f} s, "
        f"{B * T / eager_s:.6g} env-steps/s ({smi})")
    bad, errs = lane_disagreement(kcfg, kern, eager, ATOL_GLUCOSE_LONG, rtol_glucose=RTOL_ENGINES)
    bad_k, _ = lane_disagreement(kcfg, kern, eager, ATOL_GLUCOSE_LONG)
    flips = ((kern["insulin"] - eager["insulin"]).abs() > 0.5 * kcfg.inc_bolus / 6000.0)
    say(f"eager vs K1a: doses one increment apart {flips.float().mean().item():.3g} of "
        f"{flips.numel()}, lanes with a flip {flips.any(0).float().mean().item():.3g}; lanes out of "
        f"rtol {RTOL_ENGINES:g} {int(bad.sum())}/{B}, of the kernel's tolerance (rtol "
        f"{RTOL_GLUCOSE:g} + {ATOL_GLUCOSE_LONG:g} mg/dL) {int(bad_k.sum())}/{B}; on the others max rel "
        f"err BG {errs['BG']:.3g} CGM {errs['CGM']:.3g}, reward abs {errs['reward']:.3g}, CHO rel "
        f"{errs['CHO']:.3g}")
    check(bad.float().mean().item() <= MAX_DIVERGED_LANES,
          f"eager vs K1a: {bad.float().mean().item():.3%} of lanes out of tolerance")
    check(float(traj.CHO.sum()) > 0, "eager vs K1a: no meal eaten")

    # ---- native streams at full size: the headline's law bands ----
    cfg_n, params_n = make_env(names, batch=True, device=dev, random_init_bg=True)
    init, pid = pid_controller(cfg_n.sample_time, P=-1e-4, I=-1e-7, D=0.0, device=dev)
    run = ero.make_batch_rollout_fn(cfg_n, pid, T)
    nkeys = env_keys((7, 8), B, device=dev)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    state, res0 = ero.batch_reset(cfg_n, params_n, nkeys)
    state, last, ntraj = run(params_n, state, ero.broadcast_ctrl_state(init, B), res0)
    torch.cuda.synchronize()
    native_s = time.perf_counter() - tic
    stats = law_stats(dict(BG=ntraj.BG, CGM=ntraj.CGM, CHO=ntraj.CHO, done=ntraj.done), cfg_n.sample_time)
    say(f"eager path native streams B={B}, T={T}, PID, random meals, auto-reset: {native_s:.3f} s, "
        f"{B * T / native_s:.6g} env-steps/s ({smi}); laws: {json.dumps(stats)}")
    check(torch.isfinite(ntraj.BG).all(), "native run: BG not finite")
    gate("eager native", stats, HEADLINE_BANDS)
    check(int(state.key[:, 3].ne(0).sum()) > 0, "native run: no episode was reset")

    # ---- no host synchronization in a step or a loop iteration ----
    state, prev = env_reset(cfg_n, params_n, nkeys, start_min=0)
    ctrl = ero.broadcast_ctrl_state(init, B)
    ctrl, action = pid(ctrl, prev)
    state, prev = env_step(cfg_n, params_n, state, action)  # warm the caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, prev = env_step(cfg_n, params_n, state, action)
        ctrl, action = pid(ctrl, prev)
        state, res, prev = ero.autoreset_step(cfg_n, params_n, state, action)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say("no host sync: one env_step and one auto-reset loop iteration ran under "
        "set_sync_debug_mode('error')")

    # ---- kernel launches per env step, by torch.profiler ----
    from torch.profiler import ProfilerActivity, profile

    n = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ctrl, action = pid(ctrl, prev)
            state, prev = env_step(cfg_n, params_n, state, action)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")
    per_step = kernels / n if kernels else "not measured (the profiler recorded no kernel)"
    say(f"eager path: CUDA kernel launches per env step (native, PID, Dexcom, B={B}): {per_step}")


def phase_api(dev, smi, tables, tr):
    """Phase 12: the single-device user API on the card (no kernel of its
    own: batch_sim runs K1a, the resumed trainers K1b/K2/K3 and K4, the Gym
    adapters the eager env)."""
    import tempfile

    import torch

    from simglucose_tpu_torch.envs import T1DSimGymEnv, T1DSimVectorEnv
    from simglucose_tpu_torch.envs.build import make_env
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import ppo_learner as lrn
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.rl import policy as pol
    from simglucose_tpu_torch.rl import ppo
    from simglucose_tpu_torch.rl.fused import init_fused_state, make_fused_train_step
    from simglucose_tpu_torch.sim import engine
    from simglucose_tpu_torch.utils.checkpoint import CheckpointManager, restore_state, save_state

    ero = importlib.import_module("simglucose_tpu_torch.envs.rollout")
    say("== 12 the user API: batch_sim, checkpoints, the Gym adapters")
    say(smi)

    same = same_tree

    def planes_equal(a, b):
        return (all(np.array_equal(x, y) for x, y in zip(a.reset + a.traj, b.reset + b.traj))
                and np.array_equal(a.reward, b.reward))

    # ---- batch_sim: a fusable batch is one cohort call ----
    names30 = tables.patient_names()
    day = dict(sim_time=timedelta(days=1), start_time=datetime(2018, 1, 1), device=dev)
    objs = [engine.SimObj(n, controller="BB", seed=API_SEED, cgm_seed=API_SEED + 1, **day)
            for n in names30]
    direct = engine.simulate_cohort(patient_names=names30, controller="BB", scenario_seed=API_SEED,
                                    cgm_seed=API_SEED + 1, **day)
    batch_s = []
    for _ in range(2):
        tr.LAUNCHES["rollout"] = 0
        torch.cuda.synchronize()
        tic = time.perf_counter()
        groups = engine._batch_cohorts(objs)
        batch_s.append(time.perf_counter() - tic)
        k1a = tr.LAUNCHES["rollout"]
        check([idx for _, idx in groups] == [list(range(30))],
              f"batch_sim made {len(groups)} cohort calls of 30 fusable SimObjs")
        check(k1a == 1, f"batch_sim: {k1a} K1a launches for one 480-step cohort")
        res = groups[0][0]
        check(res.traj.BG.shape == (480, 30) and bool(np.isfinite(res.traj.BG).all()),
              "batch_sim: BG planes")
        check(planes_equal(res, direct), "batch_sim's cohort differs from simulate_cohort on its arguments")
    say(f"batch_sim, 30 patients x 24 h, BB, random meals: one cohort call, {k1a} K1a launch, "
        f"{batch_s[0]:.4f} / {batch_s[1]:.4f} s to results (two runs); planes bit-identical to "
        f"simulate_cohort ({smi})")
    pid, bb = ("PID", dict(P=-1e-4, I=-1e-7)), ("BB", dict(target=120.0))
    pair = [engine.SimObj("adolescent#001", controller=pid, seed=API_SEED, **day),
            engine.SimObj("adult#001", controller=bb, seed=API_SEED, **day)]
    groups = engine._batch_cohorts(pair)
    check([idx for _, idx in groups] == [[0], [1]], f"a PID and a BB SimObj: groups {groups}")
    for (r, _), o in zip(groups, pair):
        alone = engine.simulate_cohort(patient_names=[o.patient_name], controller=o.controller,
                                       scenario_seed=API_SEED, **day)
        check(planes_equal(r, alone), f"batch_sim {o.controller}: differs from its own simulate_cohort")
    say("batch_sim, a PID and a BB SimObj: two cohort calls, each bit-identical to its own "
        "simulate_cohort")

    # ---- fused PPO: checkpoint, restore, resume ----
    pcfg = ppo.PPOConfig(rollout_steps=FUSED_T, epochs=2, minibatches=4, pallas_learner=True,
                         shuffle_block=2048)
    Bf = FUSED_B
    patient = tables.load_patient_params(tables.cohort_names(Bf), device=dev)
    packed = tr.pack_params(patient, basal_rate(patient))
    opt = ppo.make_optimizer(pcfg)

    def fresh(seed):
        p = pol.init_policy(torch.Generator().manual_seed(seed), hidden=FUSED_H, act="relu",
                            init_mu_bias=-2.2, device=dev)
        return init_fused_state(p, opt.init(p), Bf, torch.Generator().manual_seed(seed + 100))

    step = make_fused_train_step(pcfg, Bf, hidden=FUSED_H)
    counters = ((tr.LAUNCHES, "rollout_nn"), (lrn.LAUNCHES, "gae"), (lrn.LAUNCHES, "ppo_grad"))
    for counts, k in counters:
        counts[k] = 0
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, max_to_keep=1)
        ts = fresh(1)
        save_ms = []
        for it in (1, 2):
            ts, _ = step(packed, ts)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            mgr.save(it, ts)
            save_ms.append(1e3 * (time.perf_counter() - tic))
        files = sorted(os.listdir(tmp))
        check(files == ["ckpt_000000000002.npz"], f"CheckpointManager(max_to_keep=1) kept {files}")
        nbytes = os.path.getsize(os.path.join(tmp, files[0]))
        like = fresh(7)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        restored = mgr.restore(like=like)
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - tic)
    check(same(ts, restored) and restored.generator is not ts.generator,
          "the restored fused state differs from the saved one")
    a, ma = step(packed, ts)
    b, mb = step(packed, restored)
    launches = {k: counts[k] for counts, k in counters}
    n_mb = pcfg.epochs * pcfg.minibatches
    check(launches == {"rollout_nn": 4, "gae": 4, "ppo_grad": 4 * n_mb},
          f"fused resume: launches {launches}")
    check(same(a, b) and all(torch.equal(ma[k], mb[k]) for k in ma),
          "a resumed fused iteration differs from the uninterrupted one")
    say(f"fused PPO (kernel_prep, B={Bf}, T={FUSED_T}, relu H={FUSED_H}): 2 iterations saved "
        f"through CheckpointManager(max_to_keep=1), one file of {nbytes} bytes left; save "
        f"{save_ms[0]:.3f} / {save_ms[1]:.3f} ms, restore {restore_ms:.3f} ms ({smi}); the "
        f"restored state and the next iteration from it bit-identical in every leaf (params, "
        f"Adam moments, state_f, state_i, generator); launches {json.dumps(launches)}")

    # ---- make_train_step: checkpoint, restore, resume ----
    Bt, Tt = API_TRAIN_B, API_TRAIN_T
    env_cfg, env_params = make_env(tables.cohort_names(Bt), batch=True, random_init_bg=True,
                                   device=dev)
    tcfg = ppo.PPOConfig(rollout_steps=Tt, epochs=2, minibatches=4, pallas_learner="step")
    train = ppo.make_train_step(tcfg, env_cfg)

    def after_one(seed):
        state, r0 = ero.batch_reset(env_cfg, env_params, env_keys(seed, Bt, device=dev))
        p = pol.init_policy(torch.Generator().manual_seed(seed), hidden=FUSED_H, device=dev)
        ts = ppo.TrainState(p, ppo.make_optimizer(tcfg).init(p), state, r0,
                            env_keys((seed, 1), Bt, device=dev), torch.Generator().manual_seed(seed + 2))
        return train(env_params, ts)[0]

    lrn.LAUNCHES["ppo_grad12"] = 0
    ts = after_one(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_state.npz")
        save_state(path, ts)
        restored = restore_state(path, after_one(3))
    check(same(ts, restored), "the restored make_train_step state differs from the saved one")
    a, ma = train(env_params, ts)
    b, mb = train(env_params, restored)
    k4 = lrn.LAUNCHES["ppo_grad12"]
    check(k4 == 4 * n_mb, f"make_train_step resume: {k4} K4 launches")
    check(same(a, b) and all(torch.equal(ma[k], mb[k]) for k in ma),
          "a resumed make_train_step iteration differs from the uninterrupted one")
    say(f"make_train_step (B={Bt}, T={Tt}, tanh H={FUSED_H}, 'step' learner): the restored state "
        f"and the next iteration from it bit-identical in every leaf; {k4} K4 launches")

    ckpt = os.path.join(ROOT, "examples", "checkpoints", "ppo_cohort_residual_bb.npz")
    meta = dict(act="relu", action_scale=1.1, decoder="residual_bb")
    like = pol.init_policy(torch.Generator().manual_seed(0), hidden=64, device=dev, **meta)
    got, want = restore_state(ckpt, like), pol.load_policy_npz(ckpt, device=dev, **meta)
    check(same(got, want) and got.decoder == want.decoder, "restore_state(residual-BB) != load_policy_npz")
    say("restore_state(examples/checkpoints/ppo_cohort_residual_bb.npz) equals load_policy_npz, "
        "bit for bit")

    # ---- T1DSimVectorEnv: step_n with no host sync in the loop ----
    tr.LAUNCHES["rollout"] = 0
    B, T = API_VEC_B, API_VEC_T
    venv = T1DSimVectorEnv(B, seed=API_SEED, horizon_days=1, device=dev)
    check(venv.horizon_steps == T, f"horizon {venv.horizon_steps} steps")
    basal = torch.full((B, 1), API_BASAL, device=dev)
    policy = lambda obs: basal
    venv.reset()
    venv.step_n(2, policy)  # warm the caches
    venv.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    tic = time.perf_counter()
    try:
        obs, rew, term, trunc, infos = venv.step_n(T, policy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    stepn_s = time.perf_counter() - tic
    ended = term | trunc
    bgs = np.concatenate([infos["bg"].ravel(), infos["final_info"]["bg"][ended]])
    check(obs.shape == (T, B, 1) and rew.shape == (T, B) and bool(np.isfinite(rew).all()),
          f"step_n: shapes {obs.shape} {rew.shape}")
    check(bool(np.isfinite(bgs).all()) and bgs.min() > 0.0 and bgs.max() <= 600.0,
          f"step_n: BG in [{bgs.min()}, {bgs.max()}]")
    say(f"T1DSimVectorEnv B={B}, Dexcom, one-day horizon, constant basal {API_BASAL} U/min: "
        f"step_n({T}) ran under set_sync_debug_mode('error') (the loop and its one pinned copy; "
        f"the wait for the copy is an event); {int(term.sum())} terminated, {int(trunc.sum())} "
        f"truncated; BG in [{bgs.min():.2f}, {bgs.max():.2f}]; {stepn_s:.3f} s, "
        f"{B * T / stepn_s:.6g} env-steps/s ({smi})")
    venv.reset()
    act = np.full((B, 1), API_BASAL, np.float32)
    venv.step(act)  # warm
    n = API_VEC_CHECK_T
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        venv.step(act)
    step_s = time.perf_counter() - tic
    say(f"T1DSimVectorEnv B={B}: step() {n} calls in {step_s:.3f} s, {B * n / step_s:.6g} "
        f"env-steps/s ({smi})")

    Bc = API_VEC_CHECK_B
    mixed = torch.cat([torch.full((Bc // 2,), API_BASAL), torch.full((Bc // 2,), 30.0)])[:, None]
    runs = []
    for use_step_n in (True, False):
        env = T1DSimVectorEnv(Bc, seed=API_SEED + 1, horizon_days=1, device=dev)
        env.reset()
        if use_step_n:
            o, r, t, tc, inf = env.step_n(n, lambda x: mixed.to(dev))
            runs.append((o[:, :, 0].astype(np.float32), r, t, tc, inf["bg"]))
        else:
            steps = [env.step(mixed.numpy()) for _ in range(n)]
            runs.append((np.stack([s[0][:, 0] for s in steps]),)
                        + tuple(np.stack([s[k] for s in steps]) for k in (1, 2, 3))
                        + (np.stack([s[4]["bg"] for s in steps]),))
    check(all(np.array_equal(x, y) for x, y in zip(*runs)), "step_n differs from step() calls")
    check(bool(runs[0][2].any()), "step_n vs step(): no episode ended")
    say(f"T1DSimVectorEnv B={Bc}: step_n({n}) bit-identical to {n} step() calls from the same "
        f"reset ({int(runs[0][2].sum())} terminations)")

    # ---- T1DSimGymEnv ----
    env = T1DSimGymEnv(seed=0, horizon_days=1, device=dev)
    env.reset()
    first = env.start_time
    env.seed(0)
    env.reset()
    check(first == env.start_time == datetime(2018, 1, 1, 23, 0, 0),
          f"seed 0 started at {first} / {env.start_time}, not 2018-01-01 23:00")

    def episode(device, compat, n_steps):
        e = T1DSimGymEnv(patient_name="adolescent#001", seed=0, compat_mode=compat, horizon_days=1,
                         device=device)
        e.reset()
        tic = time.perf_counter()
        resets = 0
        for _ in range(n_steps):
            _, reward, terminated, truncated, _ = e.step(np.asarray([API_BASAL]))
            check(np.isfinite(reward), f"single env ({device}, compat={compat}): reward {reward}")
            if terminated or truncated:
                e.reset()
                resets += 1
        wall = time.perf_counter() - tic
        hist = np.asarray([[h[k] for k in ("BG", "CGM", "CHO", "insulin")] for h in e._history])
        return hist, wall, resets

    card, card_s, _ = episode(dev, True, API_GYM_COMPAT_T)
    host, host_s, _ = episode("cpu", True, API_GYM_COMPAT_T)
    check(card.shape == host.shape == (API_GYM_COMPAT_T + 1, 4), f"compat histories {card.shape}")
    rel = lambda j: float(np.max(np.abs(card[:, j] - host[:, j]) / np.maximum(np.abs(host[:, j]), 1e-300)))
    err = dict(BG=rel(0), CGM=rel(1), CHO=float(np.max(np.abs(card[:, 2] - host[:, 2]))), insulin=rel(3))
    check(np.allclose(card[:, 0], host[:, 0], rtol=RTOL_GYM_BG, atol=0), f"compat BG {err}")
    check(np.allclose(card[:, 2:], host[:, 2:], rtol=RTOL_GYM_DOSE, atol=0), f"compat CHO/insulin {err}")
    native, native_s, resets = episode(dev, False, API_GYM_NATIVE_T)
    check(bool(np.isfinite(native).all()), "native single-env episode not finite")
    say(f"T1DSimGymEnv: seed 0 starts at {env.start_time}; compat episode of {API_GYM_COMPAT_T} "
        f"steps on the card vs the CPU: max rel err BG {err['BG']:.3g} (rtol {RTOL_GYM_BG:g} "
        f"held), CGM {err['CGM']:.3g}, CHO abs {err['CHO']:.3g}, insulin {err['insulin']:.3g} "
        f"(rtol {RTOL_GYM_DOSE:g} held); {API_GYM_COMPAT_T / card_s:.4g} steps/s on the card, "
        f"{API_GYM_COMPAT_T / host_s:.4g} on the CPU; native day of {API_GYM_NATIVE_T} steps "
        f"finite ({resets} resets), {API_GYM_NATIVE_T / native_s:.4g} steps/s ({smi})")
    check(tr.LAUNCHES["rollout"] == 0, "the Gym adapters launched the rollout kernel")


def md_sim_runs(tables):
    """Phase 13's simulate_cohort runs: (label, kwargs)."""
    return [("sim30", dict(sim_time=timedelta(days=1), scenario_seed=1, cgm_seed=2)),
            (f"sim{MD_SIM_B}", dict(sim_time=timedelta(days=1), scenario_seed=3, cgm_seed=4,
                                    patient_names=tables.cohort_names(MD_SIM_B)))]


def md_residual_bb(dev):
    from simglucose_tpu_torch.rl import policy as pol

    return pol.load_policy_npz(os.path.join(ROOT, "examples", "checkpoints",
                                            "ppo_cohort_residual_bb.npz"), device=dev, act="relu",
                               action_scale=1.1, decoder="residual_bb")


def md_train_setup(dev, tables, learner, bf16):
    """make_train_step's config and a fresh global state at phase 13's
    shape (the same on every rank)."""
    import torch

    from simglucose_tpu_torch.envs.build import make_env
    from simglucose_tpu_torch.envs.rollout import batch_reset
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.rl import policy as pol
    from simglucose_tpu_torch.rl import ppo

    env_cfg, env_params = make_env(tables.cohort_names(MD_TRAIN_B), batch=True,
                                   random_init_bg=True, device=dev)
    cfg = ppo.PPOConfig(rollout_steps=MD_TRAIN_T, epochs=MD_EPOCHS, minibatches=MD_MINIBATCHES,
                        pallas_learner=learner, learner_bf16=bf16)
    state, r0 = batch_reset(env_cfg, env_params, env_keys(21, MD_TRAIN_B, device=dev))
    p = pol.init_policy(torch.Generator().manual_seed(22), hidden=FUSED_H, device=dev)
    ts = ppo.TrainState(p, ppo.make_optimizer(cfg).init(p), state, r0,
                        env_keys((23, 24), MD_TRAIN_B, device=dev), torch.Generator().manual_seed(25))
    return cfg, env_cfg, env_params, ts


def md_fused_setup(dev, tables, mesh=None):
    """The fused trainer at phase 6's config on the plane path ('step'),
    its global packed planes and a fresh state (this rank's rows)."""
    import torch

    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.rl import fused
    from simglucose_tpu_torch.rl import policy as pol
    from simglucose_tpu_torch.rl import ppo

    cfg = ppo.PPOConfig(rollout_steps=FUSED_T, epochs=MD_EPOCHS, minibatches=MD_MINIBATCHES,
                        pallas_learner="step", shuffle_block=2048)
    names = tables.cohort_names(FUSED_B)
    p = tables.load_patient_params(names, device=dev)
    packed = tr.pack_params(p, basal_rate(p))
    params = pol.init_policy(torch.Generator().manual_seed(1), hidden=FUSED_H, act="relu",
                             init_mu_bias=-2.2, device=dev)
    ts = fused.init_fused_state(params, ppo.make_optimizer(cfg).init(params), FUSED_B,
                                torch.Generator().manual_seed(3), mesh=mesh)
    return cfg, packed, ts


def md_expected_launches(tables, one_rank):
    """The kernel launches a rank of phase 13 must count: K1a once per call
    of each simulate_cohort run, K1b once for the evaluation and once per
    fused iteration, K4 once per minibatch of every 'step' update (f32: the
    fused iterations and make_train_step; bf16: make_train_step).  A
    one-rank group also runs one fused iteration with and one without a
    mesh, and make_train_step without a mesh per learner.  K5 never runs:
    a mesh runs 'epoch' as the autograd learner, and that is held to the
    autograd learner (False) without a mesh."""
    from simglucose_tpu_torch.sim import engine

    updates = MD_EPOCHS * MD_MINIBATCHES
    fused_iters = MD_FUSED_ITERS + (2 if one_rank else 0)
    step_runs = 2 if one_rank else 1  # make_train_step with 'step', per dtype
    return {"rollout": sum(len(engine._call_steps(int(kw["sim_time"].total_seconds()) // 180))
                           for _, kw in md_sim_runs(tables)),
            "rollout_nn": 1 + fused_iters,
            "ppo_grad12": updates * (fused_iters + step_runs),
            "ppo_grad12_bf16": updates * step_runs}


def rank_main(mode, rank, world, workdir):
    """One rank of phase 13, in a process of its own, ``mode`` one of
    :data:`MD_MODES` (its backend; 'gloo' two ranks sharing the card, the
    others one rank).  It drives every multi-device path, writes its planes and params to
    ``workdir/{mode}{rank}.npz`` and its launch counts and wall times as
    the last line of its output; any failure exits non-zero."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.ops import ppo_learner as lrn
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.parallel.multihost import process_group
    from simglucose_tpu_torch.parallel.sharding import make_mesh, replicate, shard_batch
    from simglucose_tpu_torch.rl import evaluate as ev
    from simglucose_tpu_torch.rl import fused
    from simglucose_tpu_torch.rl import ppo
    from simglucose_tpu_torch.sim.engine import simulate_cohort

    global say
    plain_say = say
    say = lambda *parts: plain_say(f"[{mode} rank {rank}]", *parts)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    backend = dict((m, b) for m, _, b in MD_MODES)[mode]
    with process_group(f"file://{os.path.join(workdir, mode + '_store')}", world_size=world,
                       rank=rank, backend=backend):
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh()
        check(mesh.dp == world and mesh.rank == rank, f"mesh {mesh}")
        say(f"backend {dist.get_backend_config()}, device {dev}, mesh dp={mesh.dp}")
        out, walls = {}, {}
        for counts in (tr.LAUNCHES, lrn.LAUNCHES):
            for k in counts:
                counts[k] = 0

        def timed(label, fn):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - tic
            return r

        # ---- simulate_cohort and evaluate_policy_kernel, sharded ----
        for label, kw in md_sim_runs(tables):
            res = timed(label, lambda: simulate_cohort(device=dev, mesh=mesh, **kw))
            for f, v in zip(res.traj._fields, res.traj):
                out[f"{label}_{f}"] = v
            out[f"{label}_reward"], out[f"{label}_BG0"] = res.reward, res.reset.BG
        resid = md_residual_bb(dev)
        names = tables.cohort_names(MD_EVAL_B)
        res = timed("eval", lambda: ev.evaluate_policy_kernel(resid, names, hours=24.0,
                                                              seed=EVAL_SCALE_SEED, device=dev,
                                                              mesh=mesh))
        for k in ("BG", "CGM", "insulin_mean", "risk_index"):
            out[f"eval_{k}"] = res[k]

        # ---- the fused mesh trainer; the first K4 call held to its plain version ----
        real_k4 = lrn.ppo_grad_step_gather
        first = {}

        def k4_checked(*args, **kw):
            got = real_k4(*args, **kw)
            if not first:
                want = lrn.ppo_grad_step_gather_reference(*args, **kw)
                first["err"] = grad_step_err("K4 (first call of the mesh trainer)", lrn, got, want,
                                             kw["loss_rows"])
                first["rows"] = kw["loss_rows"]
            return got

        lrn.ppo_grad_step_gather = k4_checked
        try:
            cfg, packed, ts = md_fused_setup(dev, tables, mesh)
            ts = ts._replace(params=replicate(ts.params, mesh), opt_state=replicate(ts.opt_state, mesh),
                             generator=replicate(ts.generator, mesh))
            step = fused.make_fused_train_step(cfg, FUSED_B, hidden=FUSED_H, mesh=mesh)
            for i in range(MD_FUSED_ITERS):
                ts, m = timed(f"fused_{i}", lambda: step(packed, ts))
                check(all(bool(torch.isfinite(v)) for v in m.values()), f"fused metrics {m}")
                out[f"fused_{i}_params"] = ppo.flatten_params(ts.params).cpu().numpy()
        finally:
            lrn.ppo_grad_step_gather = real_k4
        check("err" in first, "the mesh trainer made no K4 call")
        out["k4_err"] = first["err"]

        # ---- make_train_step(mesh=), one iteration per learner ----
        for learner, bf16 in MD_LEARNERS:
            label = f"train_{learner}{'_bf16' if bf16 else ''}"
            tcfg, env_cfg, env_params, ts = md_train_setup(dev, tables, learner, bf16)
            sharded = ts._replace(env_state=shard_batch(ts.env_state, mesh),
                                  prev_res=shard_batch(ts.prev_res, mesh),
                                  key=shard_batch(ts.key, mesh), params=replicate(ts.params, mesh),
                                  opt_state=replicate(ts.opt_state, mesh),
                                  generator=replicate(ts.generator, mesh))
            train = ppo.make_train_step(tcfg, env_cfg, mesh=mesh)
            ts2, m = timed(label, lambda: train(shard_batch(env_params, mesh), sharded))
            check(all(bool(torch.isfinite(v)) for v in m.values()), f"{label} metrics {m}")
            out[label + "_params"] = ppo.flatten_params(ts2.params).cpu().numpy()
            out[label + "_BG"] = ts2.prev_res.BG.cpu().numpy()
            if world == 1:
                # the one-rank group against the call without a mesh, which
                # runs 'epoch' on K5: a mesh runs it as the autograd learner
                # (JAX: use_pallas = ... and mesh is None), so it is held to False
                alone = False if learner == "epoch" else learner
                acfg, _, _, fresh = md_train_setup(dev, tables, alone, bf16)
                nomesh, m1 = ppo.make_train_step(acfg, env_cfg)(env_params, fresh)
                check(same_tree(nomesh, ts2) and all(torch.equal(m[k], m1[k]) for k in m),
                      f"{label}: the one-rank group differs from the call without a mesh "
                      f"(pallas_learner={alone!r})")
                say(f"{label}: the one-rank group equals the call without a mesh "
                    f"(pallas_learner={alone!r}), bit for bit")
        if world == 1:
            cfg, packed, ts = md_fused_setup(dev, tables, mesh)
            a = fused.make_fused_train_step(cfg, FUSED_B, hidden=FUSED_H, mesh=mesh)(packed, ts)
            cfg, packed, ts = md_fused_setup(dev, tables)
            b = fused.make_fused_train_step(cfg, FUSED_B, hidden=FUSED_H, kernel_prep=False)(packed, ts)
            check(same_tree(a, b), "fused: the one-rank group differs from the call without a mesh")
            say("fused ('step', plane path): the one-rank group equals the call without a mesh, "
                "bit for bit")

        launches = {k: v for k, v in {**tr.LAUNCHES, **lrn.LAUNCHES}.items() if v}
        np.savez(os.path.join(workdir, f"{mode}{rank}.npz"), **out)
    plain_say(json.dumps({"rank": rank, "launches": launches, "walls": walls,
                          "k4_rows": first["rows"]}))


def phase_multidevice(dev, smi, tables):
    """Phase 13, multi-device: two gloo ranks sharing the card and two
    one-rank groups (NCCL alone, and the default backend), each rank a
    fresh process running :func:`rank_main`; their results against the
    one-process results, bit for bit, the ranks' params against each other
    and their launch counts against :func:`md_expected_launches`."""
    import tempfile

    import torch

    from simglucose_tpu_torch.rl import evaluate as ev
    from simglucose_tpu_torch.sim.engine import simulate_cohort

    say("== 13 multi-device (torch.distributed, one rank per device)")
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = {}
    for label, kw in md_sim_runs(tables):
        res = simulate_cohort(device=dev, **kw)
        for f, v in zip(res.traj._fields, res.traj):
            ref[f"{label}_{f}"] = v
        ref[f"{label}_reward"], ref[f"{label}_BG0"] = res.reward, res.reset.BG
    res = ev.evaluate_policy_kernel(md_residual_bb(dev), tables.cohort_names(MD_EVAL_B), hours=24.0,
                                    seed=EVAL_SCALE_SEED, device=dev)
    for k in ("BG", "CGM", "insulin_mean", "risk_index"):
        ref[f"eval_{k}"] = res[k]

    with tempfile.TemporaryDirectory() as workdir:
        results = {}
        for mode, world, _ in MD_MODES:
            tic = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", mode,
                                       str(r), str(world), workdir],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for r in range(world)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=MD_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                fail(f"phase 13: a {mode} rank ran past {MD_TIMEOUT_S} s")
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for r, (p, log) in enumerate(zip(procs, logs)):
                for line in log.splitlines()[:-1]:
                    say(line)
                check(p.returncode == 0, f"phase 13: {mode} rank {r} exited {p.returncode}: "
                      f"{log.splitlines()[-1] if log else ''}")
                summary = json.loads(log.splitlines()[-1])
                with np.load(os.path.join(workdir, f"{mode}{r}.npz")) as f:
                    results[(mode, r)] = (summary, dict(f))
            say(f"{mode}: {world} rank(s) in {time.perf_counter() - tic:.1f} s of wall, process "
                f"start and the library load included")

    label_note = "2 ranks sharing one H100: not a scaling number"
    for (mode, r), (summary, got) in results.items():
        for k, v in ref.items():
            check(np.array_equal(got[k], v), f"phase 13: {mode} rank {r}: {k} differs from the "
                  f"one-process result")
        launches = summary["launches"]
        want = md_expected_launches(tables, mode != "gloo")
        check(launches == want, f"phase 13: {mode} rank {r} launches {launches}, not {want}")
        walls = {k: round(v, 4) for k, v in summary["walls"].items()}
        say(f"{mode} rank {r} ({label_note if mode == 'gloo' else 'one rank'}; {smi}): "
            f"launches {json.dumps(launches)}; wall s {json.dumps(walls)}; first K4 call "
            f"({summary['k4_rows']} loss rows) max abs err {float(got['k4_err']):.3g}")
    say("simulate_cohort (30 x 24 h, %d x 24 h) and evaluate_policy_kernel (%d x 24 h) on every "
        "rank equal the one-process results, bit for bit" % (MD_SIM_B, MD_EVAL_B))
    g0, g1 = results[("gloo", 0)][1], results[("gloo", 1)][1]
    keys = [k for k in g0 if k.endswith("_params")]
    for k in keys:
        check(np.array_equal(g0[k], g1[k]), f"phase 13: the gloo ranks' {k} differ")
    moved = [not np.array_equal(g0[f"fused_{i}_params"], g0[f"fused_{i + 1}_params"])
             for i in range(MD_FUSED_ITERS - 1)]
    check(all(moved), "phase 13: the mesh trainer's params did not move")
    say(f"the two gloo ranks' params bit-identical after every update ({len(keys)} checks: "
        f"{MD_FUSED_ITERS} fused iterations, make_train_step per learner)")


def cli_expected_launches(blocks, iters, epochs=2, minibatches=4):
    """Launches of ``tools/train_ppo.py`` over ``blocks`` x ``iters``
    iterations with an evaluation after every block: per iteration one K1b
    rollout, one K2 and ``epochs`` x ``minibatches`` K3 grad steps; the BB
    baseline one K1a call and each evaluation (the initial policy's and one
    per block) one K1b call of 24 h."""
    n = blocks * iters
    return {"rollout": 1, "rollout_nn": n + 1 + blocks, "gae": n, "ppo_grad": n * epochs * minibatches}


def phase_tools(dev, smi, tables, tr):
    """Phase 14: the port's tools and examples on the card.  The trainer
    CLI at full width (its launches exact, its checkpoint restored), the
    fused benches, the profiling helpers against CUDA events, and the
    examples whose imports the card has."""
    import pkgutil
    import tempfile

    import torch

    import simglucose_tpu_torch.examples as examples
    from simglucose_tpu_torch.models import patient as tpatient
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import ppo_learner as lrn
    from simglucose_tpu_torch.rl.ppo import flatten_params
    from simglucose_tpu_torch.tools import bench_ppo_fused, profile_fused_ppo, train_ppo
    from simglucose_tpu_torch.utils.checkpoint import restore_state
    from simglucose_tpu_torch.utils.profiling import Throughput

    say("== 14 tools, profiling and examples")
    phase_tic = time.perf_counter()
    counts = (tr.LAUNCHES, lrn.LAUNCHES)

    def zero_counts():
        for c in counts:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counts for k, v in c.items() if v}

    ckpt_dir = os.path.join(ROOT, "examples", "checkpoints")
    committed = {n: (os.stat(os.path.join(ckpt_dir, n)).st_mtime_ns,
                     open(os.path.join(ckpt_dir, n), "rb").read()) for n in os.listdir(ckpt_dir)}

    # ---- the main path: the trainer CLI at full width ----
    blocks, iters = TOOLS_CLI_SHAPE
    with tempfile.TemporaryDirectory() as tmp:
        env = {"PPO_CKPT": os.path.join(tmp, "best.npz"), "PPO_EVAL_EVERY": "1"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            zero_counts()
            tic = time.perf_counter()
            out = train_ppo.main([str(blocks), str(iters)], device=dev)
            wall = time.perf_counter() - tic
            got = read_counts()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        want = cli_expected_launches(blocks, iters)
        check(got == want, f"trainer CLI launches {got}, not {want}")
        check(all(np.isfinite([out["ri_start"], out["ri_best"], out["train_ms_per_iter"]])),
              f"trainer CLI summary {out}")
        fresh = train_ppo.initial_policy(train_ppo.ppo_config(), train_ppo.HIDDEN, device=dev)
        best = restore_state(env["PPO_CKPT"], like=fresh)
        check(best.w1.device.type == "cuda" and not torch.equal(flatten_params(best),
                                                                flatten_params(fresh)),
              "the trainer CLI's checkpoint restores to the initial policy")
    say(f"trainer CLI (B={train_ppo.B}, H={train_ppo.HIDDEN}, T={train_ppo.T}, {blocks} blocks x "
        f"{iters} iterations, an evaluation after each block; {smi}): launches {json.dumps(got)} "
        f"(exact); train {out['train_ms_per_iter']:.3f} ms/iteration after the first block (the "
        f"card synchronized), "
        f"evaluations {out['eval_s']:.3f} s (BB baseline + {blocks + 1} policy evaluations of "
        f"30 x 24 h), {wall:.2f} s in all; checkpoint restores and differs from the initial policy")

    # ---- the fused benches at B=8192 ----
    zero_counts()
    bench = bench_ppo_fused.main(n_iters=TOOLS_BENCH_ITERS, device=dev)
    check(bench["value"] > 0 and read_counts().get("rollout_nn", 0) == 3 * TOOLS_BENCH_ITERS,
          f"bench_ppo_fused {bench} launches {read_counts()}")
    say(f"bench_ppo_fused ({TOOLS_BENCH_ITERS} iterations a round; {smi}): "
        f"{bench['value']} env-steps/s, {bench['iters_per_sec']} it/s")
    tic = time.perf_counter()
    rows = profile_fused_ppo.main(["quick"], iters=TOOLS_BENCH_ITERS, device=dev)
    check(all(isinstance(v, str) or v > 0 for v in rows.values()), f"profile_fused_ppo {rows}")
    say(f"profile_fused_ppo quick ({TOOLS_BENCH_ITERS} iterations a call, CUDA events; {smi}) "
        f"in {time.perf_counter() - tic:.1f} s")

    # ---- Throughput against CUDA events on one K1a headline call ----
    patients = tables.load_patient_params(tables.cohort_names(HEADLINE_B), device=dev)
    packed_h = tr.pack_params(patients, basal_rate(patients))
    head = tr.RolloutConfig(n_steps=HEADLINE_T, controller="pid")
    tr.rollout(head, packed_h, (0, 0))
    meter = Throughput(HEADLINE_B, HEADLINE_T, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    meter.start()
    start.record()
    tr.rollout(head, packed_h, (1, 0))
    end.record()
    meter.stop()
    ev_ms, meter_ms = start.elapsed_time(end), meter.elapsed * 1e3
    check(abs(meter_ms / ev_ms - 1.0) < 0.02, f"Throughput {meter_ms:.4f} ms vs CUDA events "
          f"{ev_ms:.4f} ms on the headline call")
    say(f"Throughput on one K1a headline call: {meter_ms:.4f} ms ({meter.steps_per_sec:.6g} "
        f"env-steps/s) vs CUDA events {ev_ms:.4f} ms ({smi})")

    # ---- device_trace names the rollout kernel: in a fresh process, since
    # torch.profiler traces the card in a process's first session only
    # (phase 10 has had this one's) ----
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace"],
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"the device_trace process exited {run.returncode}: "
          f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
    names = json.loads(run.stdout.strip().splitlines()[-1])
    check(any("rollout_kernel" in n for n in names), f"device_trace's trace has no rollout_kernel "
          f"among {len(names)} kernel names")
    say(f"device_trace (a fresh process): the Chrome trace names {[n for n in names if 'rollout_kernel' in n]}")

    # ---- the examples whose imports the card has ----
    modules = {m.name for m in pkgutil.iter_modules(examples.__path__)}
    check(modules == set(EXAMPLES_ON_CARD) | set(EXAMPLES_LEFT),
          f"examples {sorted(modules)} against the lists")
    for name, kw in EXAMPLES_ON_CARD.items():
        tic = time.perf_counter()
        importlib.import_module(f"simglucose_tpu_torch.examples.{name}").main(device=dev, **kw)
        say(f"example {name} {json.dumps(kw)}: {time.perf_counter() - tic:.2f} s")
    tic = time.perf_counter()
    bg = tpatient._demo(device=dev)
    check(bg.shape == (1000,) and np.isfinite(bg).all(), "the patient demo's BG")
    say(f"models.patient._demo (1000 minutes): {time.perf_counter() - tic:.2f} s")
    say("left to tier-1: " + "; ".join(f"{k} ({v})" for k, v in EXAMPLES_LEFT.items()))
    now = {n: (os.stat(os.path.join(ckpt_dir, n)).st_mtime_ns,
               open(os.path.join(ckpt_dir, n), "rb").read()) for n in os.listdir(ckpt_dir)}
    check(now == committed, "a file under examples/checkpoints/ changed")
    say(f"phase 14 in {time.perf_counter() - phase_tic:.1f} s")


def trace_main():
    """The ``--trace`` process of phase 14: one K1a call at the headline
    width under ``utils.profiling.device_trace``; prints the names of the
    trace's kernel events as its last line."""
    import tempfile

    import torch

    sys.path.insert(0, ROOT)
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.utils.profiling import device_trace

    build.load_library()
    patients = tables.load_patient_params(tables.cohort_names(HEADLINE_B), device="cuda")
    packed = tr.pack_params(patients, basal_rate(patients))
    cfg = tr.RolloutConfig(n_steps=PLAIN_T, controller="pid")
    tr.rollout(cfg, packed, (0, 0))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            tr.rollout(cfg, packed, (2, 0))
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    print(json.dumps(sorted({e["name"] for e in events if e.get("cat", "").lower() == "kernel"})))


def same_tree(a, b):
    """Every leaf of two trees holds the same bits (generators by their
    state)."""
    import torch

    from simglucose_tpu_torch.utils.checkpoint import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Generator):
            ok = torch.equal(x.get_state(), y.get_state())
        elif isinstance(x, torch.Tensor):
            ok = x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        else:
            ok = type(x) is type(y) and x == y
        if not ok:
            return False
    return True


def bit_identical(a, b):
    """Two rollout results hold the same bits in every tensor."""
    import torch

    torch.cuda.synchronize()
    return a.keys() == b.keys() and all(torch.equal(v, b[k]) for k, v in a.items() if torch.is_tensor(v))


def cuda_ms(fn, n):
    """Per-call device times (ms, sorted) of ``fn(i)`` for i < n, by CUDA
    events, after one warm-up call."""
    import torch

    fn(n)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    for i, (start, end) in enumerate(events):
        start.record()
        fn(i)
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in events)


def queued_ms(fn, n):
    """Device time per call (ms) of ``n`` calls of ``fn()`` issued back to
    back between one pair of CUDA events, after one warm-up call: the card's
    time for a wrapper's launches, without the host gaps that a pair of
    events around each call also holds where the call's host work outlasts
    its kernel."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n):
    """Device time per call (ms) of ``n`` calls of ``fn()`` issued while the
    card sleeps (``torch.cuda._sleep``, long enough for the host to queue
    them all), between one pair of CUDA events recorded after the sleep:
    the kernels' own time back to back, with no gap where a call's host
    work outlasts its kernels (as :func:`queued_ms` may hold)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - tic
    torch.cuda._sleep(int(2e9 * (0.002 + 2 * n * host_s)))  # ~1.5-2 GHz: longer than the queueing
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn, n):
    """Fastest of ``n`` calls of ``fn()`` (ms) on the host's clock, the card
    drained around each: for the plain versions, which launch one small
    kernel per operation."""
    import torch

    best = float("inf")
    for _ in range(n):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, 1e3 * (time.perf_counter() - tic))
    return best


def phase_fused(dev, tables, tr, packed_for):
    """Phase 6, fused PPO training: the new kernels against their plain
    versions, then the bench config's training loop.  Returns the kernels'
    entries of the summary line."""
    import torch

    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.ops import ppo_learner as lrn
    from simglucose_tpu_torch.rl import policy as pol
    from simglucose_tpu_torch.rl import ppo
    from simglucose_tpu_torch.rl.fused import (
        fused_rollout_config,
        init_fused_state,
        make_fused_train_loop,
        make_fused_train_step,
    )

    # the plain versions' matmuls in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def full_f32():
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    say("== 6 fused PPO training")
    ckpt = os.path.join(ROOT, "examples", "checkpoints")
    relu64 = pol.load_policy_npz(os.path.join(ckpt, "ppo_cohort_relu64.npz"), device=dev,
                                 act="relu", action_scale=10.0, scale_by_basal=True)
    resid = pol.load_policy_npz(os.path.join(ckpt, "ppo_cohort_residual_bb.npz"), device=dev,
                                act="relu", action_scale=1.1, decoder="residual_bb")
    fresh = pol.init_policy(torch.Generator().manual_seed(1), hidden=FUSED_H, act="relu",
                            init_mu_bias=-2.2, device=dev)
    # init_policy's default width: K1b's shared-memory opt-in, K3's 32-row tiles
    wide = pol.init_policy(torch.Generator().manual_seed(2), hidden=WIDE_H, act="relu",
                           init_mu_bias=-2.2, device=dev)

    # ---- K1b vs its plain version (B=256, T=48) ----
    B, T = 256, 48
    packed = packed_for(tables.cohort_names(B))
    meals = dict(det_meal_times=(3, 10, 60), det_meal_amounts=(30.0, 25.0, 50.0))

    def nn(policy, n_steps=T, **kw):
        return tr.RolloutConfig(n_steps=n_steps, controller="nn", nn_hidden=policy.b1.shape[0],
                                nn_action_scale=policy.action_scale,
                                nn_scale_by_basal=policy.scale_by_basal,
                                nn_decoder=policy.decoder, **kw)

    ladder = [
        # (name, policy, config, stochastic)
        ("nn_det_emit_sigmoid", fresh, nn(fresh, deterministic=True, nn_emit_learner_rows=True,
                                          **meals), False),
        ("nn_det_planes_sigmoid_basal", relu64, nn(relu64, deterministic=True, **meals), False),
        ("nn_det_emit_residual_bb", resid, nn(resid, deterministic=True, nn_emit_learner_rows=True,
                                              **meals), False),
        ("nn_det_planes_residual_bb", resid, nn(resid, deterministic=True, **meals), False),
        ("nn_stoch_emit_sampled", fresh, nn(fresh, nn_emit_learner_rows=True, fixed_start_min=1380,
                                            bg_done_high=180.0), True),
        ("nn_relu64_eval", relu64, nn(relu64, nn_sample_actions=False, autoreset=False), True),
        (f"nn_det_emit_sigmoid_h{WIDE_H}", wide, nn(wide, deterministic=True, nn_emit_learner_rows=True,
                                                     **meals), False),
        (f"nn_det_planes_sigmoid_h{WIDE_H}", wide, nn(wide, deterministic=True, **meals), False),
    ]
    full_f32()
    k1b_err = 0.0
    for name, policy, cfg, stochastic in ladder:
        w = tr.pack_policy_weights(policy)
        plain = tr.rollout_reference(cfg, packed, (11, 29), weights=w)
        kern = tr.rollout(cfg, packed, (11, 29), weights=w)
        errs = compare(name, cfg, kern, plain, stochastic)
        if not stochastic:
            k1b_err = max(k1b_err, *(v for k, v in errs.items() if k.startswith("nn:")))
    cfg = ladder[4][2]
    half = dataclasses.replace(cfg, n_steps=T // 2)
    w = tr.pack_policy_weights(fresh)
    one = tr.rollout(cfg, packed, (5, 6), weights=w)
    a = tr.rollout(half, packed, (5, 6), weights=w)
    b = tr.rollout(half, packed, (5, 6), weights=w, state=(a["state_f"], a["state_i"]), init=0,
                   step_offset=T // 2)
    for k in ("BG", "CGM", "insulin", "reward", "done"):
        check(torch.equal(torch.cat([a[k], b[k]]), one[k]), f"chunked K1b run differs in {k}")
    cut = torch.cat([a["learner"].view(10, T // 2, B), b["learner"].view(10, T // 2, B)], dim=1)
    check(torch.equal(cut, one["learner"].view(10, T, B)) and torch.equal(b["tail_value"], one["tail_value"]),
          "chunked K1b learner rows differ")
    say("chunked K1b: two kernel calls equal one, bit for bit (learner rows included)")

    # ---- K1b, K2, K3 at the bench config's shapes ----
    pcfg = ppo.PPOConfig(rollout_steps=FUSED_T, epochs=2, minibatches=4, pallas_learner=True,
                         shuffle_block=2048)
    Bf, Tf = FUSED_B, FUSED_T
    packed_f = packed_for(tables.cohort_names(Bf), quest=False)
    rcfg = fused_rollout_config(pcfg, hidden=FUSED_H)
    wf = tr.pack_policy_weights(fresh)
    k1b_ms = cuda_ms(lambda i: tr.rollout(rcfg, packed_f, (i, 1), weights=wf), 5)[2]
    full_f32()
    plain_out = {}
    k1b_plain_ms = host_ms(lambda: plain_out.update(
        tr.rollout_reference(rcfg, packed_f, (0, 1), weights=wf)), 1)
    traj = tr.rollout(rcfg, packed_f, (0, 1), weights=wf)
    compare(f"nn_bench B={Bf} T={Tf}", rcfg, traj, plain_out, stochastic=True)
    check(bit_identical(traj, tr.rollout(rcfg, packed_f, (0, 1), weights=wf)), "two K1b runs differ")
    k1b_launch = rollout_launch(tr, build, "rollout_nn_kernel", Bf)
    say(f"K1b B={Bf}, T={Tf}: kernel {k1b_ms:.3f} ms ({Bf * Tf / k1b_ms * 1e3:.6g} env-steps/s), "
        f"plain version {k1b_plain_ms:.3f} ms; two runs bit-identical; launch {json.dumps(k1b_launch)}")
    # the bench shape at H=WIDE_H
    rcfg_w = fused_rollout_config(pcfg, hidden=WIDE_H)
    ww = tr.pack_policy_weights(wide)
    full_f32()
    traj_w = tr.rollout(rcfg_w, packed_f, (0, 1), weights=ww)
    compare(f"nn_bench B={Bf} T={Tf} H={WIDE_H}", rcfg_w, traj_w,
            tr.rollout_reference(rcfg_w, packed_f, (0, 1), weights=ww), stochastic=True)
    check(bit_identical(traj_w, tr.rollout(rcfg_w, packed_f, (0, 1), weights=ww)),
          f"two K1b runs at H={WIDE_H} differ")
    k1b_wide_ms = cuda_ms(lambda i: tr.rollout(rcfg_w, packed_f, (i, 1), weights=ww), 5)[2]
    say(f"K1b B={Bf}, T={Tf}, H={WIDE_H}: kernel {k1b_wide_ms:.3f} ms; two runs bit-identical")

    reward, done = traj["reward"], traj["done"].to(torch.float32)
    value, tail = traj["value"], traj["tail_value"]
    gl = dict(gamma=pcfg.gamma, lam=pcfg.lam)
    advret = lrn.gae_pack(reward, done, value, tail, **gl)
    ref = lrn.gae_pack_reference(reward, done, value, tail, **gl)
    d = (advret - ref).abs()
    check(bool((d <= ATOL_GAE + RTOL_GAE * ref.abs()).all()), f"K2 disagrees: max abs err {d.max():.3g}")
    k2_err = float(d.max())
    k2_ms = cuda_ms(lambda i: lrn.gae_pack(reward, done, value, tail, **gl), 10)[5]
    k2_queued_ms = queued_ms(lambda: lrn.gae_pack(reward, done, value, tail, **gl), 20)
    k2_plain_ms = host_ms(lambda: lrn.gae_pack_reference(reward, done, value, tail, **gl), 3)
    say(f"K2 B={Bf}, T={Tf}: max abs err {k2_err:.3g} (advantages up to {ref.abs().max():.3g}); "
        f"kernel {k2_ms:.4f} ms ({k2_queued_ms:.4f} ms back to back), plain version "
        f"{k2_plain_ms:.3f} ms")

    main_fm = traj["learner"]
    N = Tf * Bf
    bs, n_blocks, mb_size = ppo._shuffle_blocking(pcfg, N)
    adv_b = advret[0].view(n_blocks, bs)
    perm_mb = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(5))[
        : n_blocks // pcfg.minibatches].to(dev)
    mean, std = ppo.minibatch_adv_stats(adv_b.sum(1), (adv_b * adv_b).sum(1), perm_mb, mb_size)
    p = fresh
    gargs = (main_fm, advret, perm_mb, bs, p.w1, p.b1, p.w2, p.b2,
             torch.cat([p.w_mu, p.w_v], dim=1), torch.cat([p.b_mu, p.b_v]), p.log_std[0], mean, std)
    got = lrn.ppo_grad_step_gather2(*gargs)
    full_f32()
    want = lrn.ppo_grad_step_gather2_reference(*gargs)
    k3_err = grad_step_err("K3", lrn, got, want, mb_size)
    k3_ms = cuda_ms(lambda i: lrn.ppo_grad_step_gather2(*gargs), 10)[5]
    k3_queued_ms = queued_ms(lambda: lrn.ppo_grad_step_gather2(*gargs), 20)
    k3_plain_ms = host_ms(lambda: lrn.ppo_grad_step_gather2_reference(*gargs), 3)
    say(f"K3 minibatch {mb_size} rows ({perm_mb.numel()} blocks of {bs}, "
        f"{lrn._grad_split(perm_mb.numel(), dev)} CUDA blocks each), H={FUSED_H}: "
        f"kernel {k3_ms:.3f} ms with events around each call ({k3_queued_ms:.3f} ms back to "
        f"back), plain version {k3_plain_ms:.3f} ms")
    # H=WIDE_H (init_policy's default width; 32-row tiles and the shared
    # memory opt-in) on the same minibatch
    wargs =(main_fm, advret, perm_mb, bs, wide.w1, wide.b1, wide.w2, wide.b2,
             torch.cat([wide.w_mu, wide.w_v], dim=1), torch.cat([wide.b_mu, wide.b_v]),
             wide.log_std[0], mean, std)
    grad_step_err(f"K3 H={WIDE_H}", lrn, lrn.ppo_grad_step_gather2(*wargs),
                  lrn.ppo_grad_step_gather2_reference(*wargs), mb_size)
    say(f"K3 H={WIDE_H}, same minibatch: kernel "
        f"{queued_ms(lambda: lrn.ppo_grad_step_gather2(*wargs), 10):.3f} ms back to back")

    # the epoch-0 ratio: K1b's behaviour log-prob against the learner's
    # recomputation at the same params
    full_f32()
    mu, log_std, v = pol.policy_apply(fresh, main_fm[0:7].T)
    ratio = torch.exp(pol.gaussian_logprob(mu, log_std, main_fm[8]) - main_fm[9])
    r_err = float((ratio - 1.0).abs().max())
    v_err = float((v - main_fm[7]).abs().max())
    say(f"epoch-0 ratio: max |ratio - 1| {r_err:.3g}; value row vs recomputed {v_err:.3g}")
    check(r_err <= ATOL_RATIO, f"epoch-0 ratio off by {r_err:.3g} > {ATOL_RATIO}")

    # ---- the main path: the bench config's training loop ----
    gen = torch.Generator().manual_seed(0)
    opt = ppo.make_optimizer(pcfg)
    ts = init_fused_state(fresh, opt.init(fresh), Bf, gen)
    step = make_fused_train_step(pcfg, Bf, hidden=FUSED_H)
    ts, _ = step(packed_f, ts)  # warm-up iteration
    loop = make_fused_train_loop(pcfg, Bf, FUSED_ITERS, hidden=FUSED_H)
    before = [x.clone() for x in ts.params.leaves()]
    counters = (tr.LAUNCHES, "rollout_nn"), (lrn.LAUNCHES, "gae"), (lrn.LAUNCHES, "ppo_grad")
    for counts, k in counters:
        counts[k] = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    start.record()
    ts, m = loop(packed_f, ts)
    end.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - tic)
    launches = {k: counts[k] for counts, k in counters}
    loop_ms = start.elapsed_time(end)
    say(f"launches on the main path ({FUSED_ITERS} iterations): {json.dumps(launches)}")
    check(launches == {"rollout_nn": FUSED_ITERS, "gae": FUSED_ITERS,
                       "ppo_grad": FUSED_ITERS * pcfg.epochs * pcfg.minibatches},
          f"the training loop did not run through every kernel: {launches}")
    for k, v in m.items():
        check(v.shape == (FUSED_ITERS,) and bool(torch.isfinite(v).all()), f"metric {k} not finite: {v}")
    say("metrics (last iteration): " + json.dumps({k: float(v[-1]) for k, v in m.items()}))
    moved = max(float((a - b).abs().max()) for a, b in zip(ts.params.leaves(), before))
    check(moved > 0, "the params did not move")
    check(ts.init == 0 and ts.opt_state.count == (FUSED_ITERS + 1) * pcfg.epochs * pcfg.minibatches,
          f"state not carried: init {ts.init}, Adam count {ts.opt_state.count}")
    # an episode clock past one iteration's minutes exists only if episodes
    # carried across iterations
    one_iter_min = Tf * rcfg.sample_time
    carried = float((ts.state_i[0].float() > one_iter_min).float().mean())
    check(carried > 0.01, f"episodes did not carry across iterations ({carried:.3%} of lanes)")
    say(f"params moved by up to {moved:.3g}; {carried:.1%} of lanes in episodes older than one "
        f"iteration ({one_iter_min} min)")
    iters_per_sec = FUSED_ITERS / (loop_ms / 1e3)
    say(f"fused_ppo_iters_per_sec {iters_per_sec:.6g}; fused_ppo_steps_per_sec "
        f"{iters_per_sec * Bf * Tf:.6g} (B={Bf}, T={Tf}, {FUSED_ITERS} iterations: {loop_ms:.3f} ms "
        f"by CUDA events, {wall_ms:.3f} ms on the host's clock)")
    stage_ms = {}
    for stage in ("rollout", "forward", "full"):
        s = make_fused_train_step(pcfg, Bf, hidden=FUSED_H, stages=stage)
        stage_ms[stage] = cuda_ms(lambda i: s(packed_f, ts), 5)[2]
    say(f"per-iteration stages (median ms by CUDA events): rollout {stage_ms['rollout']:.3f}, "
        f"GAE (forward - rollout) {stage_ms['forward'] - stage_ms['rollout']:.3f}, "
        f"learner (full - forward) {stage_ms['full'] - stage_ms['forward']:.3f}, "
        f"full {stage_ms['full']:.3f}")

    # K2 reads reward, done, value [T, B] and the tail value and writes
    # [2, T*B]; ~9 FLOP per lane-step.  K3 reads its minibatch's 10 + 2
    # rows per column.
    k2_bound = bound(9 * N, 4 * (5 * N + Bf))
    k3_bound = bound(grad_step_flop(mb_size, FUSED_H), 4 * 12 * mb_size)
    k3_case = dict(args=gargs, wide_args=wargs, mb_size=mb_size, block=bs, pcfg=pcfg,
                   policy=fresh, main_fm=main_fm, advret=advret)
    return k3_case, [
        dict(kernel_entry("rollout_k1b", "rollout.cu", "simglucose_tpu/ops/pallas_rollout.py:804",
                          launches["rollout_nn"], k1b_err, k1b_ms, k1b_plain_ms,
                          rollout_bound(rcfg, Bf, FUSED_H), f"B={Bf},T={Tf},H={FUSED_H}",
                          launch=k1b_launch),
             **{f"ms_h{WIDE_H}": k1b_wide_ms,
                f"bound_ms_h{WIDE_H}": rollout_bound(rcfg_w, Bf, WIDE_H)[0]}),
        kernel_entry("gae_k2", "ppo_learner.cu", "simglucose_tpu/ops/pallas_ppo_learner.py:644",
                     launches["gae"], k2_err, k2_ms, k2_plain_ms, k2_bound, f"B={Bf},T={Tf}",
                     queued_ms=k2_queued_ms),
        kernel_entry("ppo_grad_k3", "ppo_learner.cu", "simglucose_tpu/ops/pallas_ppo_learner.py:250",
                     launches["ppo_grad"], k3_err, k3_ms, k3_plain_ms, k3_bound,
                     f"rows={mb_size},block={bs},H={FUSED_H}", queued_ms=k3_queued_ms),
    ]


def phase_plane(dev, tables, tr, packed_for):
    """Phase 7, fused PPO training on the observation-plane path: K4 and K5
    against their plain versions on the learner buffer of a real plane-mode
    rollout, then the bench config's training loop with each learner.
    Returns the new kernels' entries of the summary line."""
    import torch

    from simglucose_tpu_torch.ops import ppo_learner as lrn
    from simglucose_tpu_torch.rl import fused
    from simglucose_tpu_torch.rl import policy as pol
    from simglucose_tpu_torch.rl import ppo

    say("== 7 fused PPO training, observation-plane path (kernel_prep=False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    Bf, Tf, H = FUSED_B, FUSED_T, FUSED_H
    N = Bf * Tf
    pcfg = ppo.PPOConfig(rollout_steps=Tf, epochs=2, minibatches=4, pallas_learner="step",
                         shuffle_block=2048)
    fresh = pol.init_policy(torch.Generator().manual_seed(1), hidden=H, act="relu",
                            init_mu_bias=-2.2, device=dev)
    packed_f = packed_for(tables.cohort_names(Bf), quest=False)

    # ---- the learner's 12-row buffer, built as the path builds it ----
    rcfg = fused.fused_rollout_config(pcfg, hidden=H, kernel_prep=False)
    traj = tr.rollout(rcfg, packed_f, (0, 1), weights=tr.pack_policy_weights(fresh))
    check("octrl" in traj and "learner" not in traj, "the rollout did not run in plane mode")
    transition, last_value = fused.plane_transition(pcfg, fresh, traj, tr.packed_basal(packed_f),
                                                    traj["reward"], traj["done"].to(torch.float32))
    obs, logp = transition.obs, transition.logp
    advs, rets = ppo._gae(pcfg, transition, last_value)
    packed12 = lrn.pack_minibatch_rows(obs.reshape(N, 7), traj["raw"].reshape(N),
                                       logp.reshape(N), advs.reshape(N), rets.reshape(N))
    check(packed12.shape == (12, N) and bool(torch.isfinite(packed12).all()),
          "the 12-row learner buffer is not finite")
    bs, n_blocks, mb_size = ppo._shuffle_blocking(pcfg, N)
    bpm = n_blocks // pcfg.minibatches
    gen = torch.Generator().manual_seed(7)
    perm_all = torch.cat([torch.randperm(n_blocks, generator=gen)
                          for _ in range(pcfg.epochs)]).to(dev)
    adv_b = advs.reshape(n_blocks, bs)
    mean, std = ppo.minibatch_adv_stats(adv_b.sum(1), (adv_b * adv_b).sum(1),
                                        perm_all.view(-1, bpm), mb_size)

    # ---- K4 on one minibatch ----
    p = fresh
    gargs = (packed12, perm_all[:bpm], bs, p.w1, p.b1, p.w2, p.b2,
             torch.cat([p.w_mu, p.w_v], dim=1), torch.cat([p.b_mu, p.b_v]), p.log_std[0],
             mean[0], std[0])
    got = lrn.ppo_grad_step_gather(*gargs)
    want = lrn.ppo_grad_step_gather_reference(*gargs)
    k4_err = grad_step_err("K4", lrn, got, want, mb_size)
    k4_ms = cuda_ms(lambda i: lrn.ppo_grad_step_gather(*gargs), 10)[5]
    k4_queued_ms = queued_ms(lambda: lrn.ppo_grad_step_gather(*gargs), 20)
    k4_plain_ms = host_ms(lambda: lrn.ppo_grad_step_gather_reference(*gargs), 3)
    say(f"K4 minibatch {mb_size} rows ({bpm} blocks of {bs}), H={H}: kernel {k4_ms:.3f} ms with "
        f"events around each call ({k4_queued_ms:.3f} ms back to back), plain version "
        f"{k4_plain_ms:.3f} ms")

    # ---- K5 over the whole learner ----
    opt = ppo.make_optimizer(pcfg)
    eargs = (pcfg, opt, p, opt.init(p), packed12, perm_all, bs, mean, std)
    k5_errs = epoch_err(f"K5 H={H}", lrn, ppo, pcfg, eargs)
    say("K5 vs plain version (2 epochs x 4 minibatches of %d blocks): max abs err %s; two runs "
        "bit-identical" % (bpm, json.dumps(k5_errs)))

    # ---- K4 and K5 at H=WIDE_H on the same buffer ----
    wide = pol.init_policy(torch.Generator().manual_seed(2), hidden=WIDE_H, act="relu",
                           init_mu_bias=-2.2, device=dev)
    wargs = (packed12, perm_all[:bpm], bs, wide.w1, wide.b1, wide.w2, wide.b2,
             torch.cat([wide.w_mu, wide.w_v], dim=1), torch.cat([wide.b_mu, wide.b_v]),
             wide.log_std[0], mean[0], std[0])
    grad_step_err(f"K4 H={WIDE_H}", lrn, lrn.ppo_grad_step_gather(*wargs),
                  lrn.ppo_grad_step_gather_reference(*wargs), mb_size)
    wide_e = (pcfg, opt, wide, opt.init(wide), packed12, perm_all, bs, mean, std)
    wide_errs = epoch_err(f"K5 H={WIDE_H}", lrn, ppo, pcfg, wide_e)
    say(f"H={WIDE_H}: K4 kernel {queued_ms(lambda: lrn.ppo_grad_step_gather(*wargs), 10):.3f} ms; "
        f"K5 kernel {cuda_ms(lambda i: lrn.ppo_epoch_update(*wide_e), 3)[1]:.3f} ms, max abs err "
        f"{json.dumps(wide_errs)}, two runs bit-identical")

    # ---- K5 with PPOConfig's default 512-row shuffle blocks: 256 blocks a
    # minibatch, more work items than the card holds blocks at once ----
    cfg512 = dataclasses.replace(pcfg, shuffle_block=512)
    bs5, n_blocks5, _ = ppo._shuffle_blocking(cfg512, N)
    bpm5 = n_blocks5 // pcfg.minibatches
    perm5 = torch.cat([torch.randperm(n_blocks5, generator=gen)
                       for _ in range(pcfg.epochs)]).to(dev)
    adv5 = advs.reshape(n_blocks5, bs5)
    mean5, std5 = ppo.minibatch_adv_stats(adv5.sum(1), (adv5 * adv5).sum(1),
                                          perm5.view(-1, bpm5), mb_size)
    e512 = (cfg512, opt, p, opt.init(p), packed12, perm5, bs5, mean5, std5)
    errs512 = epoch_err(f"K5 {bpm5} blocks of {bs5}", lrn, ppo, cfg512, e512)
    say(f"K5 at {bpm5} blocks of {bs5} a minibatch ({bpm5 * lrn._grad_split(bpm5, dev)} work "
        f"items), H={H}: kernel {cuda_ms(lambda i: lrn.ppo_epoch_update(*e512), 3)[1]:.3f} ms, "
        f"max abs err {json.dumps(errs512)}, two runs bit-identical")
    k5_ms = cuda_ms(lambda i: lrn.ppo_epoch_update(*eargs), 5)[2]
    step_ms = cuda_ms(lambda i: ppo._grad_step_updates(
        pcfg, opt, p, eargs[3], packed12, perm_all, bs, mean, std, mb_size,
        lrn.ppo_grad_step_gather), 5)[2]
    k5_plain_ms = host_ms(lambda: lrn.ppo_epoch_update_reference(*eargs), 3)
    say(f"K5 whole learner: kernel {k5_ms:.3f} ms; the 'step' learner (8 x K4 + the optimizer) "
        f"{step_ms:.3f} ms; plain version {k5_plain_ms:.3f} ms")

    # ---- the main path: the bench config's loop with each learner ----
    counts = (tr.LAUNCHES, lrn.LAUNCHES)
    per_learner = {}
    for learner in ("step", "epoch", False):
        cfg = dataclasses.replace(pcfg, pallas_learner=learner)
        opt = ppo.make_optimizer(cfg)
        ts = fused.init_fused_state(fresh, opt.init(fresh), Bf, torch.Generator().manual_seed(0))
        kw = dict(hidden=H, kernel_prep=False)
        ts, _ = fused.make_fused_train_step(cfg, Bf, **kw)(packed_f, ts)  # warm-up iteration
        loop = fused.make_fused_train_loop(cfg, Bf, FUSED_ITERS, **kw)
        before = [x.clone() for x in ts.params.leaves()]
        for c in counts:
            for k in c:
                c[k] = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        ts, m = loop(packed_f, ts)
        end.record()
        torch.cuda.synchronize()
        launches = {k: v for c in counts for k, v in c.items()}
        loop_ms = start.elapsed_time(end)
        n_steps = FUSED_ITERS * cfg.epochs * cfg.minibatches
        want = dict(rollout=0, rollout_nn=FUSED_ITERS, gae=0, ppo_grad=0,
                    ppo_grad12=n_steps if learner == "step" else 0,
                    ppo_epoch=FUSED_ITERS if learner == "epoch" else 0,
                    ppo_grad_bf16=0, ppo_grad12_bf16=0, ppo_epoch_bf16=0)
        say(f"learner {learner!r}: launches on the main path ({FUSED_ITERS} iterations): "
            f"{json.dumps(launches)}")
        check(launches == want, f"learner {learner!r}: the loop's launches {launches} != {want}")
        for k, v in m.items():
            check(v.shape == (FUSED_ITERS,) and bool(torch.isfinite(v).all()),
                  f"learner {learner!r}: metric {k} not finite: {v}")
        moved = max(float((a - b).abs().max()) for a, b in zip(ts.params.leaves(), before))
        check(moved > 0, f"learner {learner!r}: the params did not move")
        check(ts.init == 0 and ts.opt_state.count == n_steps + cfg.epochs * cfg.minibatches,
              f"learner {learner!r}: state not carried (Adam count {ts.opt_state.count})")
        carried = float((ts.state_i[0].float() > Tf * rcfg.sample_time).float().mean())
        check(carried > 0.01, f"learner {learner!r}: episodes did not carry ({carried:.3%})")
        iters_per_sec = FUSED_ITERS / (loop_ms / 1e3)
        stages = ("rollout", "forward", "full") if learner == "step" else ("full",)
        stage_ms = {}
        for stage in stages:
            st = fused.make_fused_train_step(cfg, Bf, stages=stage, **kw)
            stage_ms[stage] = cuda_ms(lambda i: st(packed_f, ts), 5)[2]
        per_learner[learner] = dict(launches=launches, stage_ms=stage_ms)
        say(f"learner {learner!r}: fused_ppo_iters_per_sec {iters_per_sec:.6g}; "
            f"fused_ppo_steps_per_sec {iters_per_sec * Bf * Tf:.6g} ({loop_ms:.3f} ms by CUDA "
            f"events); params moved by up to {moved:.3g}; {carried:.1%} of lanes in episodes "
            f"older than one iteration; metrics (last iteration) "
            + json.dumps({k: float(v[-1]) for k, v in m.items()}))
    base = per_learner["step"]["stage_ms"]
    say(f"per-iteration stages (median ms by CUDA events): rollout {base['rollout']:.3f}, "
        f"prep + GAE (forward - rollout) {base['forward'] - base['rollout']:.3f}; learner "
        f"(full - forward): " + ", ".join(
            f"{learner!r} {v['stage_ms']['full'] - base['forward']:.3f}"
            for learner, v in per_learner.items()))

    # K4 reads its minibatch's 12 rows per column; K5 every minibatch's,
    # and the parameters and Adam moments once each way
    P = ppo.flatten_params(p).numel()
    n_mb = pcfg.epochs * pcfg.minibatches
    k4_bound = bound(grad_step_flop(mb_size, H), 4 * 12 * mb_size)
    k5_bound = bound(n_mb * grad_step_flop(mb_size, H), 4 * (12 * n_mb * mb_size + 6 * P))
    src = "simglucose_tpu/ops/pallas_ppo_learner.py"
    plane_case = dict(k4_args=gargs, k4_wide_args=wargs, k5_args=eargs, k5_wide_args=wide_e,
                      k5_512_args=e512, mb_size=mb_size, block=bs, pcfg=pcfg, policy=fresh,
                      packed=packed_f, traj=traj, packed12=packed12)
    return plane_case, [
        kernel_entry("ppo_grad_k4", "ppo_learner.cu", f"{src}:177",
                     per_learner["step"]["launches"]["ppo_grad12"], k4_err, k4_ms, k4_plain_ms,
                     k4_bound, f"rows={mb_size},block={bs},H={H}", queued_ms=k4_queued_ms),
        kernel_entry("ppo_epoch_k5", "ppo_learner.cu", f"{src}:726",
                     per_learner["epoch"]["launches"]["ppo_epoch"], max(k5_errs.values()), k5_ms,
                     k5_plain_ms, k5_bound,
                     f"epochs={pcfg.epochs},minibatches={pcfg.minibatches},rows={mb_size},"
                     f"block={bs},H={H}"),
    ]


def phase_roofline(dev, smi):
    """Phase 8, the roofline probe K6: each op against its plain version,
    then the main path of ``tools/roofline_rollout.py``: the rate table and
    K1a's ceilings.  Returns K6's entries of the summary line, one per op."""
    import torch

    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.ops import roofline as rf
    from simglucose_tpu_torch.tools import roofline_rollout as rr

    say("== 8 roofline probe K6")
    x = rf.probe_tile(dev)
    shapes = rr.launch_shapes()
    errs = {}
    for op in rf.OPS:
        errs[op], worst_rel = 0.0, 0.0
        for P in rf.KERNEL_P:
            want = {K: rf.chain_reference(op, x, K, P) for K in (0,) + CHAIN_SMALL_K + (CHAIN_CHECK_K,)}
            check(all(bool((w > 0).all()) for w in want.values()), f"K6 {op}: a plain chain left (0, inf)")
            moved = [K for K in CHAIN_SMALL_K if float(((want[K] - want[K - 1]).abs() / want[K]).max())
                     > (rtol_chain(K) + rtol_chain(K - 1) if op == "fma" else 0.0)]
            check(set(CHAIN_SMALL_K[:2] if op == "exp" else CHAIN_SMALL_K) <= set(moved),
                  f"K6 {op}, P={P}: the plain chain stands still at K in {CHAIN_SMALL_K}: {moved}")
            for shape, (n, tpb) in shapes.items():
                for K in CHAIN_SMALL_K + (CHAIN_CHECK_K,):
                    got = rf.chain(op, x, K, P, n, tpb)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()), f"K6 {op}: not finite")
                    reps = got[: n // rf.TILE * rf.TILE].view(-1, rf.TILE)
                    check(torch.equal(reps, reps[:1].expand_as(reps))
                          and torch.equal(got[reps.numel():], reps[0, : n - reps.numel()]),
                          f"K6 {op}, P={P}, {shape} shape: the tile's replicas differ")
                    d = (reps[0] - want[K]).abs()
                    rel = float((d / want[K]).max())
                    errs[op], worst_rel = max(errs[op], float(d.max())), max(worst_rel, rel / rtol_chain(K))
                    ok = rel <= rtol_chain(K) if op == "fma" else torch.equal(reps[0], want[K])
                    check(ok, f"K6 {op} (P={P}, K={K}, {n} threads in blocks of {tpb}) disagrees with "
                              f"its plain version: rel err {rel:.3g}")
        say(f"K6 {op}: K in {CHAIN_SMALL_K + (CHAIN_CHECK_K,)} x P in {rf.KERNEL_P} x "
            + " and ".join(f"{n} threads in blocks of {tpb}" for n, tpb in shapes.values())
            + f": every replica equal; max abs err {errs[op]:.3g}; largest rel err "
            f"{worst_rel:.3g} x (2 ulp per step)" + ("" if op == "fma" else ", bit for bit as held"))
    sass = rr.sass_opcodes(build.BUILD_INFO["path"])
    for line in rr.sass_lines(sass):
        say(line)
    check(sass is None or (sass[("fma", 1)]["FFMA"] > 0 and sass[("mul", 1)]["FMUL"] > 0),
          "the fma chain is not FFMA or the mul chain not FMUL")

    # ---- the main path: the rate table and K1a's ceilings ----
    rf.LAUNCHES["chain"] = 0
    rows = rr.rate_table(lambda r: say(rr.rate_line(r, smi)))
    launches = rf.LAUNCHES["chain"]
    per_op = {op: sum(r["launches"] for r in rows if r["op"] == op) for op in rf.OPS}
    say(f"K6 launches on the main path: {launches} {json.dumps(per_op)}")
    check(launches == sum(per_op.values()) and min(per_op.values()) > 0,
          f"the rate table did not launch K6 for every op: {per_op}, {launches} in all")
    check(all(r["rate"] > 0 and r["sm_clock_mhz"] for r in rows), "a rate or its SM clock is missing")
    # each row's K was sized from the rate of a launch at a shorter K: a
    # launch that takes the target time grows with K, so runs every step
    # (exp's and div's outputs stop telling long chains apart)
    slow = [(r["op"], r["P"], r["shape"], r["ms"]) for r in rows
            if not 0.5 * rr.TARGET_MS <= r["ms"] <= 2 * rr.TARGET_MS]
    check(not slow, f"a launch at the calibrated K is off its target {rr.TARGET_MS} ms: {slow}")
    lines, _ = rr.ceiling_report(rows, rr.k1a_rate(), smi)
    for line in lines:
        say(line)

    # K6 reads the 1024-float tile and writes one float per thread; its
    # operations are n * K * P applications of the op
    entries = []
    for op in rf.OPS:
        r = next(r for r in rows if r["op"] == op and r["shape"] == "card" and r["P"] == 16)
        n, K = r["n_threads"], r["K"]
        plain_ms = host_ms(lambda: rf.chain_reference(op, x, K, 16).repeat(-(-n // rf.TILE))[:n], 1)
        elem = n * K * 16
        nbytes = 4 * (rf.TILE + n)
        b = bound(0.0, nbytes, sfu=elem) if op in rr.SFU_OPS else bound(elem * rr.FLOP_PER_OP[op], nbytes)
        say(f"K6 {op} at the card shape (P=16): kernel {r['ms']:.4f} ms, plain version "
            f"{plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]})")
        entries.append(kernel_entry(f"roofline_k6_{op}", "roofline.cu", "tools/roofline_rollout.py:69",
                                    per_op[op], errs[op], r["ms"], plain_ms, b,
                                    f"n={n},block={r['threads_per_block']},K={K},P=16"))
    return entries


def phase_eval(dev, tables, tr):
    """Phase 9, evaluation: K1b in evaluate_policy_kernel's config against
    its plain version, then the checkpoint gates of tests/test_ppo_eval.py
    and the paired comparison at 4096 lanes through the evaluation entry
    points, with the launch counts of that path."""
    import torch

    from simglucose_tpu_torch.rl import evaluate as ev
    from simglucose_tpu_torch.rl import policy as pol

    say("== 9 evaluation")
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt = os.path.join(ROOT, "examples", "checkpoints")
    relu64 = pol.load_policy_npz(os.path.join(ckpt, "ppo_cohort_relu64.npz"), device=dev,
                                 act="relu", action_scale=10.0, scale_by_basal=True)
    resid = pol.load_policy_npz(os.path.join(ckpt, "ppo_cohort_residual_bb.npz"), device=dev,
                                act="relu", action_scale=1.1, decoder="residual_bb")
    names30 = tables.patient_names()

    # ---- K1b at evaluate_policy_kernel's exact config and packing ----
    cfg = ev.policy_config(resid, "Dexcom", EVAL_CHECK_T)
    packed = ev.packed_cohort([names30[i % 30] for i in range(EVAL_CHECK_B)], dev)
    w = tr.pack_policy_weights(resid)
    plain = tr.rollout_reference(cfg, packed, 1234, weights=w)
    kern = tr.rollout(cfg, packed, 1234, weights=w)
    compare(f"eval_residual_bb B={EVAL_CHECK_B} T={EVAL_CHECK_T}", cfg, kern, plain, stochastic=True,
            atol_glucose=ATOL_GLUCOSE_LONG)

    # ---- the main path: the gates and the paired comparison at scale ----
    for k in tr.LAUNCHES:
        tr.LAUNCHES[k] = 0
    m = lambda res, k: float(res[k].mean())

    def summary(res):
        return (f"RI {m(res, 'risk_index'):.4f}, TIR {m(res, 'percent_in_70_180'):.3f}%, "
                f"hypo<70 {m(res, 'percent_below_70'):.3f}%, <50 {m(res, 'percent_below_50'):.3f}%")

    ppo = ev.evaluate_policy_kernel(relu64, names30, hours=6.0, seed=1234)
    pid = ev.evaluate_controller("PID", names30, hours=6.0, seed=1234)
    say(f"relu-64 vs PID, 30 x 6 h, seed 1234: policy {summary(ppo)}; PID {summary(pid)}")
    check(np.isfinite(ppo["BG"]).all() and ppo["BG"].shape == (30, 120), "relu-64 BG not finite")
    check(m(ppo, "risk_index") <= m(pid, "risk_index"), "relu-64 gate: RI worse than PID")
    check(m(ppo, "percent_below_50") < 1.0 and m(ppo, "percent_in_70_180") > 50.0,
          "relu-64 gate: below-50 or TIR")

    def residual_gate(label, ppo, bb):
        say(f"{label}: policy {summary(ppo)}; BB {summary(bb)}")
        check(np.isfinite(ppo["BG"]).all(), f"{label}: BG not finite")
        check(m(ppo, "risk_index") <= 1.05 * m(bb, "risk_index"), f"{label}: RI above 1.05 x BB")
        check(m(ppo, "percent_in_70_180") >= m(bb, "percent_in_70_180") - 2.0, f"{label}: TIR below BB - 2")
        check(m(ppo, "percent_below_70") <= m(bb, "percent_below_70") + 0.5, f"{label}: hypo above BB + 0.5")

    for seed in (1234, 77):
        residual_gate(f"residual-BB vs BB, 30 x 24 h, seed {seed}",
                      ev.evaluate_policy_kernel(resid, names30, hours=24.0, seed=seed),
                      ev.evaluate_controller("BB", names30, hours=24.0, seed=seed))

    names = tables.cohort_names(EVAL_SCALE_B)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        big = ev.evaluate_policy_kernel(resid, names, hours=24.0, seed=EVAL_SCALE_SEED)
        walls.append(time.perf_counter() - tic)
    bb = ev.evaluate_controller("BB", names, hours=24.0, seed=EVAL_SCALE_SEED)
    check(big["BG"].shape == (EVAL_SCALE_B, 480), f"4096-lane BG shape {big['BG'].shape}")
    residual_gate(f"residual-BB vs BB, {EVAL_SCALE_B} lanes x 24 h, seed {EVAL_SCALE_SEED}", big, bb)
    say(f"evaluate_policy_kernel, {EVAL_SCALE_B} lanes x 24 h: time to results "
        + ", ".join(f"{w:.4f}" for w in walls) + " s (first call, then two more)")
    launches = dict(tr.LAUNCHES)
    say(f"rollout launches on the evaluation path: {json.dumps(launches)}")
    check(launches == {"rollout": 4, "rollout_nn": 6},
          f"the evaluation path did not run through K1a and K1b as expected: {launches}")


def phase_bf16(dev, smi, tables, k3_case, plane_case):
    """Phase 11, the bf16 learner and the XLA-path trainer: K3, K4 and K5 at
    ``compute_dtype=bfloat16`` against their plain bf16 versions on the
    buffers of phases 6 and 7, then the paths that run them (K3's
    ``_update_packed``, the observation-plane trainer with each learner,
    ``make_train_step`` at tools/bench_ppo.py's config) and the policy
    evaluated on the eager env path.  Returns the bf16 kernels' entries of
    the summary line."""
    import torch

    ero = importlib.import_module("simglucose_tpu_torch.envs.rollout")
    from simglucose_tpu_torch.envs.build import make_env
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import build
    from simglucose_tpu_torch.ops import ppo_learner as lrn
    from simglucose_tpu_torch.ops import rollout as tr
    from simglucose_tpu_torch.ops.streams import env_keys
    from simglucose_tpu_torch.rl import evaluate as ev
    from simglucose_tpu_torch.rl import fused
    from simglucose_tpu_torch.rl import policy as pol
    from simglucose_tpu_torch.rl import ppo

    say("== 11 the bf16 learner (learner_bf16) and the XLA-path trainer make_train_step")
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = dict(compute_dtype=torch.bfloat16)

    # ---- the tensor cores: HMMA instructions of the bf16 grad-step kernels
    # (their three H x H products), none in the float32 ones; registers,
    # spills and shared memory of each ----
    sites = sass_sites(build.BUILD_INFO["path"])
    check(sites is not None, "the toolkit has no cuobjdump: the bf16 kernels' SASS is not readable")
    ptxas = build.BUILD_INFO["ptxas"]
    lib = build.load_library()
    kinfo = {}
    for kname, label in (("ppo_grad_kernelILb1E", "bf16 K3/K4"), ("ppo_epoch_kernelILb1E", "bf16 K5"),
                         ("ppo_grad_kernelILb0E", "float32 K3/K4"),
                         ("ppo_epoch_kernelILb0E", "float32 K5")):
        found = [v for k, v in sites.items() if kname in k]
        check(len(found) == 1, f"{kname}: {len(found)} kernels in the SASS")
        kinfo[kname] = dict(hmma=found[0]["hmma"], sass_instructions=found[0]["total"],
                            registers=ptxas_registers(ptxas, kname),
                            spill_bytes=ptxas_spills(ptxas, kname),
                            smem_bytes={f"H{h}": lib.sgt_ppo_smem_bytes(h, int("ILb1" in kname))
                                        for h in (FUSED_H, WIDE_H)})
        say(f"{label} ({kname}): {json.dumps(kinfo[kname])}")
    for kname in ("ppo_grad_kernelILb1E", "ppo_epoch_kernelILb1E"):
        check(kinfo[kname]["hmma"] > 0, f"{kname}: no HMMA instruction, the tensor cores are not used")
    counts = (tr.LAUNCHES, lrn.LAUNCHES)

    def zero_counts():
        for c in counts:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counts for k, v in c.items() if v}

    def gap(f32_out, bf_out):
        """The plain bf16 grad step's largest distance from the float32 one,
        relative to each leaf's largest magnitude."""
        return max(float((getattr(f32_out, f) - getattr(bf_out, f)).abs().max())
                   / float(getattr(bf_out, f).abs().max()) for f in ("dw1", "dw2", "dw_head"))

    # ---- K3 and K4 at bf16 against their plain versions, each timed beside
    # its float32 instantiation ----
    entries = {}
    for name, step, plain, args, wide, mb_size, block in (
        ("K3", lrn.ppo_grad_step_gather2, lrn.ppo_grad_step_gather2_reference, k3_case["args"],
         k3_case["wide_args"], k3_case["mb_size"], k3_case["block"]),
        ("K4", lrn.ppo_grad_step_gather, lrn.ppo_grad_step_gather_reference,
         plane_case["k4_args"], plane_case["k4_wide_args"], plane_case["mb_size"],
         plane_case["block"]),
    ):
        want = plain(*args, **bf)
        got = step(*args, **bf)
        err = grad_step_err(f"{name} bf16", lrn, got, want, mb_size, rtol=RTOL_GRAD_BF16)
        again = step(*args, **bf)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{name} bf16: two runs are not bit-identical")
        err_w = grad_step_err(f"{name} bf16 H={WIDE_H}", lrn, step(*wide, **bf),
                              plain(*wide, **bf), mb_size, rtol=RTOL_GRAD_BF16)
        ms = cuda_ms(lambda i: step(*args, **bf), 10)[5]
        q_bf, q_f32 = (queued_ms(lambda: step(*args, **kw), 20) for kw in (bf, {}))
        qw_bf, qw_f32 = (queued_ms(lambda: step(*wide, **kw), 10) for kw in (bf, {}))
        d_bf, d_f32 = (device_ms(lambda: step(*args, **kw), 20) for kw in (bf, {}))
        dw_bf, dw_f32 = (device_ms(lambda: step(*wide, **kw), 10) for kw in (bf, {}))
        plain_ms = host_ms(lambda: plain(*args, **bf), 3)
        g = gap(plain(*args), want)
        check(g > RTOL_GRAD_BF16, f"{name}: the bf16 and float32 plain steps differ by only {g:.3g}")
        say(f"{name} bf16, {mb_size} rows ({block}-row blocks): two runs bit-identical; max abs "
            f"err {err:.3g} (H={WIDE_H}: "
            f"{err_w:.3g}); the plain bf16 step is {g:.3g} of each leaf's "
            f"largest magnitude from the float32 one.  Kernel H={FUSED_H}: {ms:.3f} ms with events "
            f"around each call, {q_bf:.3f} ms back to back (float32 {q_f32:.3f} ms), {d_bf:.4f} ms "
            f"queued behind a sleep of the card (float32 {d_f32:.4f} ms); H={WIDE_H}: {qw_bf:.3f} ms "
            f"back to back (float32 {qw_f32:.3f} ms), {dw_bf:.4f} behind a sleep (float32 "
            f"{dw_f32:.4f}); plain bf16 version {plain_ms:.3f} ms")
        entries[name] = dict(err=max(err, err_w), ms=ms, queued_ms=q_bf, f32_queued_ms=q_f32,
                             plain_ms=plain_ms, wide_queued_ms=qw_bf, wide_f32_queued_ms=qw_f32,
                             device_ms=d_bf, f32_device_ms=d_f32, wide_device_ms=dw_bf,
                             wide_f32_device_ms=dw_f32, mb_size=mb_size, block=block)

    # ---- K5 at bf16: H=64 and H=128, two runs bit-identical ----
    eargs, wide_e = plane_case["k5_args"], plane_case["k5_wide_args"]
    pcfg = plane_case["pcfg"]
    k5_errs = epoch_err("K5 bf16", lrn, ppo, pcfg, eargs, torch.bfloat16)
    k5_werrs = epoch_err(f"K5 bf16 H={WIDE_H}", lrn, ppo, pcfg, wide_e, torch.bfloat16)
    k5_ms = cuda_ms(lambda i: lrn.ppo_epoch_update(*eargs, **bf), 5)[2]
    k5_f32_ms = cuda_ms(lambda i: lrn.ppo_epoch_update(*eargs), 5)[2]
    k5w_ms = cuda_ms(lambda i: lrn.ppo_epoch_update(*wide_e, **bf), 3)[1]
    k5w_f32_ms = cuda_ms(lambda i: lrn.ppo_epoch_update(*wide_e), 3)[1]
    k5_plain_ms = host_ms(lambda: lrn.ppo_epoch_update_reference(*eargs, **bf), 3)
    e512 = plane_case["k5_512_args"]  # phase 7's 256 shuffle blocks of 512 rows a minibatch
    k5_512_errs = epoch_err("K5 bf16 at 512-row blocks", lrn, ppo, e512[0], e512, torch.bfloat16)
    say(f"K5 bf16 at {e512[5].numel() // (e512[0].epochs * e512[0].minibatches)} blocks of "
        f"{e512[6]} a minibatch: "
        f"kernel {cuda_ms(lambda i: lrn.ppo_epoch_update(*e512, **bf), 3)[1]:.3f} ms, max abs err "
        f"{json.dumps(k5_512_errs)}, two runs bit-identical")
    say(f"K5 bf16: max abs err {json.dumps(k5_errs)} (H={WIDE_H}: {json.dumps(k5_werrs)}); two "
        f"runs bit-identical at each width.  Kernel H={FUSED_H} {k5_ms:.3f} ms (float32 "
        f"{k5_f32_ms:.3f} ms), H={WIDE_H} {k5w_ms:.3f} ms (float32 {k5w_f32_ms:.3f} ms); plain "
        f"bf16 version {k5_plain_ms:.3f} ms")

    # ---- K3's bf16 path: _update_packed with learner_bf16 ----
    cfg3 = dataclasses.replace(k3_case["pcfg"], learner_bf16=True)
    opt3, p3 = ppo.make_optimizer(cfg3), k3_case["policy"]
    zero_counts()
    p3b, _, aux3 = ppo._update_packed(cfg3, opt3, p3, opt3.init(p3), k3_case["main_fm"],
                                      k3_case["advret"], generator=torch.Generator().manual_seed(3))
    torch.cuda.synchronize()
    k3_launches = read_counts()
    n_mb = cfg3.epochs * cfg3.minibatches
    check(k3_launches == {"ppo_grad_bf16": n_mb},
          f"_update_packed(learner_bf16) launched {k3_launches}, not {n_mb} bf16 K3 steps")
    check(all(bool(torch.isfinite(a).all()) for a in aux3), "_update_packed(bf16): aux not finite")
    moved3 = max(float((a - b).abs().max()) for a, b in zip(p3b.leaves(), p3.leaves()))
    check(moved3 > 0, "_update_packed(bf16) did not move the params")
    say(f"_update_packed(learner_bf16): launches {json.dumps(k3_launches)}; params moved by up to "
        f"{moved3:.3g}")

    # ---- the observation-plane path with learner_bf16 ----
    fresh, packed_f = plane_case["policy"], plane_case["packed"]
    Bf, Tf, H = FUSED_B, FUSED_T, FUSED_H
    # the epoch-0 ratio: the log-probs that the path recomputes
    # (fused.plane_transition, the train step's own, [T, B] rows) against
    # the learner's forward at bf16 (learner_logp, K4/K5's plain version)
    # at unchanged params; the path's float32 recomputation must miss it
    traj = plane_case["traj"]
    done = traj["done"].to(torch.float32)
    ratio_err = {}
    for use_bf16 in (True, False):
        cfg = dataclasses.replace(pcfg, learner_bf16=use_bf16)
        tran, _ = fused.plane_transition(cfg, fresh, traj, tr.packed_basal(packed_f),
                                         traj["reward"], done)
        logp = lrn.learner_logp(
            tran.obs.reshape(-1, 7).T, traj["raw"].reshape(-1), fresh.w1, fresh.b1, fresh.w2,
            fresh.b2, torch.cat([fresh.w_mu, fresh.w_v], 1), torch.cat([fresh.b_mu, fresh.b_v]),
            fresh.log_std[0], act="relu", **bf)
        ratio_err[use_bf16] = float((torch.exp(logp - tran.logp.reshape(-1)) - 1).abs().max())
    r_err = ratio_err[True]
    say(f"epoch-0 ratio with learner_bf16 (the path's recomputed log-probs against the "
        f"learner's bf16 forward): max |ratio - 1| {r_err:.3g}; the path's float32 "
        f"recomputation would give {ratio_err[False]:.3g}")
    check(r_err <= ATOL_RATIO, f"bf16 epoch-0 ratio off by {r_err:.3g} > {ATOL_RATIO}")
    check(ratio_err[False] > ATOL_RATIO,
          f"the float32 recomputation is only {ratio_err[False]:.3g} from the bf16 learner")
    plane_iters = PLANE_BF16_ITERS
    plane_launch = {}
    for learner in ("step", "epoch", False):
        cfg = dataclasses.replace(pcfg, pallas_learner=learner, learner_bf16=True)
        opt = ppo.make_optimizer(cfg)
        ts = fused.init_fused_state(fresh, opt.init(fresh), Bf, torch.Generator().manual_seed(0))
        kw = dict(hidden=H, kernel_prep=False)
        ts, _ = fused.make_fused_train_step(cfg, Bf, **kw)(packed_f, ts)  # warm-up iteration
        loop = fused.make_fused_train_loop(cfg, Bf, plane_iters, **kw)
        before = [x.clone() for x in ts.params.leaves()]
        zero_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        ts, m = loop(packed_f, ts)
        end.record()
        torch.cuda.synchronize()
        launches = read_counts()
        n_steps = plane_iters * cfg.epochs * cfg.minibatches
        want = {"rollout_nn": plane_iters}
        if learner == "step":
            want["ppo_grad12_bf16"] = n_steps
        elif learner == "epoch":
            want["ppo_epoch_bf16"] = plane_iters
        check(launches == want, f"plane path bf16 {learner!r}: launches {launches} != {want}")
        for k, v in m.items():
            check(bool(torch.isfinite(v).all()), f"plane path bf16 {learner!r}: {k} not finite")
        moved = max(float((a - b).abs().max()) for a, b in zip(ts.params.leaves(), before))
        check(moved > 0, f"plane path bf16 {learner!r}: the params did not move")
        ms = start.elapsed_time(end)
        plane_launch[learner] = launches
        say(f"plane path, learner {learner!r}, learner_bf16: launches ({plane_iters} iterations) "
            f"{json.dumps(launches)}; {plane_iters / (ms / 1e3):.6g} iterations/s "
            f"({ms:.3f} ms by CUDA events); params moved by up to {moved:.3g}; metrics (last) "
            + json.dumps({k: float(v[-1]) for k, v in m.items()}))

    # ---- make_train_step at tools/bench_ppo.py's config ----
    Bp, Tp = TRAIN_B, TRAIN_T
    env_cfg, env_params = make_env(tables.cohort_names(Bp), batch=True, random_init_bg=True,
                                   device=dev)
    env_state, reset_res = ero.batch_reset(env_cfg, env_params, env_keys(0, Bp, device=dev))
    policy = pol.init_policy(torch.Generator().manual_seed(1), device=dev)  # tanh, H=128
    timed = TRAIN_ITERS
    for label, learner, use_bf16 in (("autograd f32", False, False), ("step bf16", "step", True),
                                     ("epoch bf16", "epoch", True)):
        cfg = ppo.PPOConfig(rollout_steps=Tp, epochs=2, minibatches=4, pallas_learner=learner,
                            learner_bf16=use_bf16)
        opt = ppo.make_optimizer(cfg)
        ts = ppo.TrainState(policy, opt.init(policy), env_state, reset_res,
                            env_keys((0, 1), Bp, device=dev), torch.Generator().manual_seed(0))
        step = ppo.make_train_step(cfg, env_cfg)
        ts, _ = step(env_params, ts)  # warm-up iteration
        before = [x.clone() for x in ts.params.leaves()]
        zero_counts()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(timed):
            ts, m = step(env_params, ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        launches = {k: v / timed for k, v in read_counts().items()}
        n_mb = cfg.epochs * cfg.minibatches
        want = {}
        if learner == "step":
            want["ppo_grad12_bf16"] = n_mb
        elif learner == "epoch":
            want["ppo_epoch_bf16"] = 1
        check(launches == want, f"make_train_step {label}: launches per iteration {launches}")
        for k, v in m.items():
            check(bool(torch.isfinite(v)), f"make_train_step {label}: {k} not finite")
        moved = max(float((a - b).abs().max()) for a, b in zip(ts.params.leaves(), before))
        check(moved > 0 and ts.step == Tp * (timed + 1), f"make_train_step {label}: no progress")
        say(f"make_train_step {label} (B={Bp}, T={Tp}, tanh H=128): {timed * Bp * Tp / wall:.6g} "
            f"env-steps/s ({wall / timed:.3f} s per iteration on the host's clock); kernel "
            f"launches per iteration {json.dumps(launches)}; params moved by up to {moved:.3g}; "
            f"metrics (last) " + json.dumps({k: float(v) for k, v in m.items()}))
    short = dataclasses.replace(cfg, rollout_steps=2)
    basal = basal_rate(env_params.patient)
    args = (short, env_cfg, env_params, ts.params, ts.env_state, ts.prev_res, ts.cgm_prev, ts.iob,
            basal, ts.key)
    ppo._rollout(*args, ts.step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ppo._rollout(*args, ts.step + 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say("no host sync: two steps of make_train_step's rollout ran under "
        "set_sync_debug_mode('error')")

    # ---- the policy evaluated on the eager env path ----
    names = tables.patient_names()
    relu64 = pol.load_policy_npz(os.path.join(ROOT, "examples", "checkpoints",
                                              "ppo_cohort_relu64.npz"), device=dev, act="relu",
                                 action_scale=10.0, scale_by_basal=True)
    patient = tables.load_patient_params(names, device=dev)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    eager = ev.evaluate_controller(ev.policy_controller(relu64, basal_rate(patient)), names,
                                   hours=24.0, seed=5, device=dev)
    wall = time.perf_counter() - tic
    kern = ev.evaluate_policy_kernel(relu64, names, hours=24.0, seed=5, device=dev)
    laws = {}
    # sanity bounds: the relu64 policy leaves a child's BG unclipped up to
    # 613 mg/dL in the plain K1b run on the CPU (seed 5); the sensor clips
    # at 400, the model does not
    for label, res in (("eager policy_controller", eager), ("evaluate_policy_kernel", kern)):
        bg = res["BG"]
        check(bg.shape == (30, 480) and bool(np.isfinite(bg).all()), f"{label}: BG {bg.shape}")
        check(80.0 < bg.mean() < 250.0 and bg.min() > -1.0 and bg.max() < 1000.0,
              f"{label}: BG not sane (mean {bg.mean():.1f}, min {bg.min():.1f})")
        laws[label] = {k: float(np.mean(res[k])) for k in
                       ("percent_in_70_180", "percent_below_70", "risk_index", "BG_mean")}
    say(f"relu64, 30 patients x 24 h, seed 5 (laws on different streams, not bits): "
        f"{json.dumps(laws)}; the eager evaluation took {wall:.3f} s to results")

    # ---- the summary line's entries; the bound at the bf16 tensor peak ----
    src = "simglucose_tpu/ops/pallas_ppo_learner.py"
    out = []
    for name, kname, replaces, launches in (
        ("K3", "ppo_grad_k3_bf16", f"{src}:250", k3_launches.get("ppo_grad_bf16", 0)),
        ("K4", "ppo_grad_k4_bf16", f"{src}:177", plane_launch["step"].get("ppo_grad12_bf16", 0)),
    ):
        e = entries[name]
        out.append(kernel_entry(
            kname, "ppo_learner.cu", replaces, launches, e["err"], e["ms"], e["plain_ms"],
            bound(grad_step_flop(e["mb_size"], FUSED_H), 4 * 12 * e["mb_size"],
                  flop_per_s=BF16_FLOP_PER_S),
            f"rows={e['mb_size']},block={e['block']},H={FUSED_H},compute_dtype=bfloat16",
            queued_ms=e["queued_ms"]))
        out[-1].update(f32_queued_ms=e["f32_queued_ms"], device_ms=e["device_ms"],
                       f32_device_ms=e["f32_device_ms"], **{
                           f"queued_ms_h{WIDE_H}": e["wide_queued_ms"],
                           f"f32_queued_ms_h{WIDE_H}": e["wide_f32_queued_ms"],
                           f"device_ms_h{WIDE_H}": e["wide_device_ms"],
                           f"f32_device_ms_h{WIDE_H}": e["wide_f32_device_ms"]},
                       **kinfo["ppo_grad_kernelILb1E"])
    mb = plane_case["mb_size"]
    P = ppo.flatten_params(fresh).numel()
    n_mb = pcfg.epochs * pcfg.minibatches
    out.append(dict(kernel_entry(
        "ppo_epoch_k5_bf16", "ppo_learner.cu", f"{src}:726",
        plane_launch["epoch"].get("ppo_epoch_bf16", 0),
        max(max(k5_errs.values()), max(k5_werrs.values())), k5_ms, k5_plain_ms,
        bound(n_mb * grad_step_flop(mb, FUSED_H), 4 * (12 * n_mb * mb + 6 * P),
              flop_per_s=BF16_FLOP_PER_S),
        f"epochs={pcfg.epochs},minibatches={pcfg.minibatches},rows={mb},"
        f"block={plane_case['block']},H={FUSED_H},compute_dtype=bfloat16"),
        f32_ms=k5_f32_ms, **{f"ms_h{WIDE_H}": k5w_ms, f"f32_ms_h{WIDE_H}": k5w_f32_ms},
        **kinfo["ppo_epoch_kernelILb1E"]))
    say(smi)
    return out


def grad_step_err(name, lrn, got, want, mb_size, rtol=RTOL_GRAD):
    """Hold a grad step's output against its plain version's (``rtol`` of
    each leaf's largest magnitude; the loss sums as the means the trainer
    reports, since the pg sum cancels to ~0 over normalised advantages).
    Returns the largest abs error."""
    worst = 0.0
    for f in lrn.PPOGradOut._fields:
        g, r = getattr(got, f), getattr(want, f)
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        if f in ("pg_sum", "v_sum"):
            err, scale = err / mb_size, scale / mb_size
            ok = err <= ATOL_LOSS + rtol * scale
        else:
            ok = err <= rtol * scale + 1e-12
        say(f"  {name} {f}: max abs err {err:.3g} of max |x| {scale:.3g}")
        check(ok, f"{name} disagrees in {f}: {err:.3g} against {scale:.3g}")
        worst = max(worst, err)
    return worst


def epoch_err(name, lrn, ppo, pcfg, eargs, compute_dtype=None):
    """Run K5 twice on ``eargs`` (bit-identical) and hold it against its
    plain version with the JAX package's tolerances, at ``compute_dtype``
    (float32 when None); at bfloat16 also Adam's first moment leaf by leaf
    (RTOL_GRAD_BF16).  Returns the max abs error of params, mu, nu and
    aux."""
    import torch

    cd = dict(compute_dtype=compute_dtype or torch.float32)
    runs = [lrn.ppo_epoch_update(*eargs, **cd) for _ in range(2)]
    torch.cuda.synchronize()
    flat = [[ppo.flatten_params(r[0]), r[1].mu, r[1].nu, r[2]] for r in runs]
    check(all(torch.equal(a, b) for a, b in zip(*flat)), f"{name}: two runs are not bit-identical")
    ref_p, ref_s, ref_aux = lrn.ppo_epoch_update_reference(*eargs, **cd)
    check(runs[0][1].count == ref_s.count == eargs[3].count + pcfg.epochs * pcfg.minibatches,
          f"{name}: Adam count {runs[0][1].count}")
    errs = {}
    for f, g, r, rtol, atol in (
        ("params", flat[0][0], ppo.flatten_params(ref_p), RTOL_PARAMS, ATOL_PARAMS),
        ("mu", flat[0][1], ref_s.mu, RTOL_PARAMS, ATOL_PARAMS),
        ("nu", flat[0][2], ref_s.nu, RTOL_NU, ATOL_NU),
        ("aux", flat[0][3], ref_aux, RTOL_AUX, ATOL_AUX),
    ):
        d = (g - r).abs()
        errs[f] = float(d.max())
        check(bool((d <= atol + rtol * r.abs()).all()), f"{name} disagrees in {f}: {d.max():.3g}")
    if cd["compute_dtype"] == torch.bfloat16:
        # Adam's normalisation hides the rounding in the params, but the
        # first moment is a running mean of the gradients: held leaf by
        # leaf within RTOL_GRAD_BF16 of its largest magnitude as K3/K4 are,
        # a bound that the float32 plain learner must miss
        def mu_gap(mu):
            pairs = zip(ppo.unflatten_params(mu, eargs[2]).leaves(),
                        ppo.unflatten_params(ref_s.mu, eargs[2]).leaves())
            return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                       for a, b in pairs)

        rel, f32_rel = mu_gap(flat[0][1]), mu_gap(lrn.ppo_epoch_update_reference(*eargs)[1].mu)
        say(f"  {name} mu: {rel:.3g} of each leaf's largest magnitude from the plain bf16 "
            f"version (the plain float32 version: {f32_rel:.3g})")
        check(rel <= RTOL_GRAD_BF16, f"{name} disagrees in mu: {rel:.3g} of a leaf")
        check(f32_rel > RTOL_GRAD_BF16,
              f"{name}: the float32 plain learner is only {f32_rel:.3g} from the bf16 one")
    say(f"  {name} aux (pg loss, v loss, entropy, |g|) of the last minibatch: {runs[0][2][-1].tolist()}")
    return errs


def nn_checks(cfg, kern, plain):
    """(name, kernel, plain, atol, rtol) for the 'nn' controller's outputs,
    the lane last."""
    T, B = kern["BG"].shape
    if cfg.nn_emit_learner_rows:
        lk, lp = kern["learner"].view(10, T, B), plain["learner"].view(10, T, B)
        return [("features", lk[:7], lp[:7], ATOL_FEATURES, 0.0),
                ("value/raw/logp", lk[7:], lp[7:], ATOL_NN, RTOL_NN),
                ("tail_value", kern["tail_value"], plain["tail_value"], ATOL_NN, RTOL_NN)]
    inc = cfg.inc_basal / 6000.0
    out = [("raw", kern["raw"], plain["raw"], ATOL_NN, RTOL_NN)]
    for pre in ("", "tail_"):
        for k, atol, rtol in (("octrl", 0.0, RTOL_GLUCOSE), ("oprev", 0.0, RTOL_GLUCOSE),
                              ("ocho", 0.0, RTOL_CHO), ("oins", 1.001 * inc, 1e-6),
                              ("oiob", IOB_FLIPS * 1.001 * inc * cfg.sample_time, 1e-5)):
            out.append((pre + k, kern[pre + k], plain[pre + k], atol, rtol))
    return out


def compare(name, cfg, kern, plain, stochastic, atol_glucose=0.0):
    """Hold a kernel call against its plain version: every lane finite;
    every lane within tolerance (deterministic configs) or all but
    MAX_DIVERGED_LANES of them (stochastic ones).  Returns the errors."""
    import torch

    torch.cuda.synchronize()
    bad, errs = lane_disagreement(cfg, kern, plain, atol_glucose)
    for k in ("BG", "CGM", "reward", "insulin"):
        check(torch.isfinite(kern[k]).all(), f"{name}: kernel {k} not finite")
    share = bad.float().mean().item()
    say(f"{name}: lanes out of tolerance {int(bad.sum())}/{bad.numel()}; on the others max rel "
        f"err BG {errs['BG']:.3g} CGM {errs['CGM']:.3g}, max abs err BG {errs['BG_abs']:.3g}, "
        f"reward {errs['reward']:.3g}, insulin {errs['insulin']:.3g}, CHO rel {errs['CHO']:.3g}")
    nn_errs = {k: v for k, v in errs.items() if k.startswith("nn:")}
    if nn_errs:
        say("  max abs err " + ", ".join(f"{k[3:]} {v:.3g}" for k, v in nn_errs.items()))
    if stochastic:
        check(share <= MAX_DIVERGED_LANES, f"{name}: {share:.3%} of lanes diverged (> {MAX_DIVERGED_LANES:.0%})")
    else:
        check(share == 0.0, f"{name}: kernel and plain version disagree beyond tolerance")
    return errs


def lane_disagreement(cfg, kern, plain, atol_glucose=0.0, rtol_glucose=RTOL_GLUCOSE):
    """[B] mask of lanes where the kernel leaves the plain version's
    tolerance, and the largest errors on the other lanes.  BG/CGM may
    differ by ``rtol_glucose`` relatively plus ``atol_glucose``."""
    import torch

    inc = (cfg.inc_bolus if cfg.controller == "bb" else cfg.inc_basal) / 6000.0
    rel = lambda k: ((kern[k] - plain[k]).abs() / plain[k].abs().clamp(min=1e-30)).nan_to_num(0.0)
    bad = torch.zeros(kern["BG"].shape[1], dtype=torch.bool, device=kern["BG"].device)
    for k in ("BG", "CGM"):
        d = (kern[k] - plain[k]).abs()
        bad |= (d > rtol_glucose * plain[k].abs() + atol_glucose).any(0)
    bad |= ((kern["reward"] - plain["reward"]).abs() > ATOL_REWARD).any(0)
    bad |= (rel("CHO") > RTOL_CHO).any(0)
    ins_d = (kern["insulin"] - plain["insulin"]).abs()
    bad |= (ins_d > 1.001 * inc + 1e-6 * plain["insulin"].abs()).any(0)
    bad |= (kern["done"] != plain["done"]).any(0)
    for k in ("BG0", "CGM0"):
        bad |= (kern[k] - plain[k]).abs() > rtol_glucose * plain[k].abs()
    nn = nn_checks(cfg, kern, plain) if cfg.controller == "nn" else []
    B = bad.numel()
    for _, k, p, atol, rtol in nn:
        bad |= ((k - p).abs() > atol + rtol * p.abs()).reshape(-1, B).any(0)
    ok = ~bad
    m = lambda x: float(x[..., ok].max()) if ok.any() else 0.0
    errs = dict(BG=m(rel("BG")), CGM=m(rel("CGM")), CHO=m(rel("CHO")), insulin=m(ins_d),
                reward=m((kern["reward"] - plain["reward"]).abs()),
                BG_abs=m((kern["BG"] - plain["BG"]).abs()))
    for name, k, p, _, _ in nn:
        errs["nn:" + name] = m((k - p).abs())
    return bad, errs


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    elif sys.argv[1:2] == ["--trace"]:
        trace_main()
    else:
        main()
