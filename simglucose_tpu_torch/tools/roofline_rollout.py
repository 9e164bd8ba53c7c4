"""The rollout kernel's roofline on the card.

Counterpart of ``tools/roofline_rollout.py`` (the TPU's version).  It
measures, with the roofline probe K6 (``csrc/roofline.cu``), the card's
rate for each of the seven elementwise ops of the TPU probe, at two launch
shapes and for 1, 4 and 16 independent chains per thread (the rates rise
with the instruction-level parallelism):

* ``card``: full occupancy, every SM filled with 128-thread blocks up to
  its thread limit (132 x 16 blocks on an H100);
* ``k1a``: the rollout kernel K1a's own launch at the headline cohort,
  B=4096 patients of ``K1A_GROUP`` lanes each in blocks of
  ``K1A_THREADS`` (:func:`k1a_launch_shape`; one lane per patient in
  32-thread blocks: 128 blocks of one warp).

It then counts K1a's operations per env step by op class (:data:`MIX`,
from ``csrc/rollout_math.cuh``), computes the ceiling those rates put on
K1a, ``1 / sum_c MIX[c] / rate_c`` env-steps/s at each shape, and runs K1a
at the headline config (B=4096, PID, auto-reset, Dexcom) to print its
measured env-steps/s beside both ceilings.  Every rate line carries the
card's name and power limit and the SM clock read right after its timed
launches.

Run on a machine with an NVIDIA GPU and the CUDA toolkit::

    python -m simglucose_tpu_torch.tools.roofline_rollout

It first prints the floating-point and MUFU instructions of each op's
one-chain kernel (``cuobjdump -sass`` of the built library, where the
toolkit has it).  Without CUDA the tool fails: a rate is only ever the
card's.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import statistics
import subprocess
import sys

import torch

from simglucose_tpu_torch.core.device import card_label, smi_query
from simglucose_tpu_torch.ops import roofline as rf

# ---------------------------------------------------------------------------
# K1a's operations per env step
# ---------------------------------------------------------------------------
#
# Counted from csrc/rollout_math.cuh for the PID headline config (st=3 RK4
# minutes per step, auto-reset, Dexcom, random meals), one count per float
# operation the source writes, each put in the class of the probe op that
# costs the same: "fma" a multiply-add nvcc contracts (2 FLOP), "mul" a lone
# add, subtract, multiply or rintf (1 FLOP), "div" an IEEE division or
# sqrtf (a reciprocal plus Newton steps), "select" a compare with or
# without a select, "exp" expf or sinf/cosf (a MUFU op after range
# reduction), "log" logf; powf counts one log and one exp.  Expressions of
# the patient's or the config's constants alone are computed once per
# call and not counted; expressions of a minute's Dbar, shared by its four
# RHS evaluations, count once per minute.  Integer clock and index
# arithmetic (the INT pipe) is not counted.  A warp issues a branch when
# any of its 32 lanes takes it, so the gastric branch of model_rhs, taken
# once an episode's first meal is eaten, counts as taken.  Not counted:
# auto-resets and midnight meal-plan draws (each under 2% of lane-steps at
# the headline config), and the issue slots lost to lanes of a warp taking
# different branches; both are part of what separates the measured rate
# from the ceiling.
#
# One simulated minute (:636-708, run sample_time times per step):
#   model_rhs (:213-258), 4 per minute: 27 mul, 19 fma, 3 div (Rat, Uidt,
#     It), 9 select (Et, max(EGPt), seven x >= 0 guards), 2 tanh;
#   the gastric constants of the minute's Dbar (:219-221): 2 div, 2 mul,
#     1 select (Dbar > 0);
#   RK4 stage arithmetic (:262-285): 65 fma, 26 mul;
#   meal lookup (:637-650): 6 select; eating machine (:652-666): 4 mul,
#     12 select; d_mg 1 mul, Dbar 1 fma (:668-670); BG 1 div (:674); the
#     three step means 3 fma (:705-707).
MIX_PER_MINUTE = dict(fma=145, mul=141, div=15, select=55, tanh=8)
# Once per step, besides the controller and the noise lattice: the insulin
# rate (:669, loop-invariant in the minute loop) 1 mul, 1 div; the CGM
# sample (:682-684, :697-698) 1 div, Catmull-Rom (:169-176) 11 mul, 6 fma,
# the noise added 1 mul, the clip 2 select; risk (:182-186) 1 select,
# logf + powf (2 log, 1 exp), 4 mul; reward 1 mul; done 2 select, its
# store 1 select (:711-720).
MIX_PER_STEP = dict(fma=6, mul=18, div=2, select=6, exp=1, log=2)
# One point of the 15-minute noise lattice (:685-696), every 15 / st steps:
# Box-Muller (:124-129; the unused sine is dead code) 1 log, 1 sqrt (div),
# 1 cos (exp), 2 uniforms (2 mul, 2 select), 3 mul; the AR(1) step 2 mul;
# Johnson-SU (:163-167) 1 exp, 2 div, 2 mul, 1 fma.
MIX_PER_LATTICE_POINT = dict(fma=1, mul=9, div=3, select=2, exp=2, log=1)
# The PID controller and the pump (:606-611, quantize :178-180).
MIX_PID = dict(fma=3, mul=6, div=3, select=2)
MDL_SAMPLE_TIME = 15  # the lattice spacing, min

FLOP_PER_OP = dict(fma=2, mul=1, div=1, select=1)
SFU_OPS = ("tanh", "exp", "log")


def k1a_mix(sample_time: int = 3, controller: str = "pid") -> dict:
    """K1a's operations per env step by probe op class (fractional where a
    cost recurs every few steps): ``sample_time`` minutes, the step's own
    work, the lattice points it needs, and the PID controller if asked."""
    mix = collections.Counter()
    for part, n in ((MIX_PER_MINUTE, sample_time), (MIX_PER_STEP, 1),
                    (MIX_PER_LATTICE_POINT, sample_time / MDL_SAMPLE_TIME),
                    (MIX_PID, 1 if controller == "pid" else 0)):
        for c, v in part.items():
            mix[c] += n * v
    return {c: mix[c] for c in rf.OPS if mix[c]}


# the headline config's mix: the one count of K1a's work in the repo
MIX = k1a_mix()


def mix_flop(mix: dict) -> float:
    """Float32 FLOP per env step: 2 per fma, 1 per mul, div and select."""
    return sum(FLOP_PER_OP[c] * v for c, v in mix.items() if c in FLOP_PER_OP)


def mix_sfu(mix: dict) -> float:
    """Transcendentals (tanh, exp, log) per env step."""
    return sum(v for c, v in mix.items() if c in SFU_OPS)


def ceiling(mix: dict, rates: dict) -> float:
    """Env-steps/s if every op of ``mix`` issued at its measured rate
    (element-ops/s) and nothing else cost time: ``1 / sum_c mix[c] /
    rates[c]``."""
    return 1.0 / sum(v / rates[c] for c, v in mix.items())


# ---------------------------------------------------------------------------
# Measurement on the card
# ---------------------------------------------------------------------------

K1A_B = 4096  # the headline cohort
K1A_T, K1A_CALLS = 1024, 3  # steps per timed K1a call, and the calls timed


def k1a_launch_shape() -> tuple:
    """(n_threads, threads_per_block) of K1a's launch at the headline
    cohort: K1A_GROUP lanes per patient in blocks of K1A_THREADS
    (``ops/rollout.py``, mirroring ``csrc/rollout_math.cuh``)."""
    from simglucose_tpu_torch.ops import rollout as tr

    return K1A_B * tr.K1A_GROUP, tr.K1A_THREADS


def launch_shapes() -> dict:
    """{shape: (n_threads, threads_per_block)} for ``card`` (every SM
    filled with 128-thread blocks) and ``k1a`` (K1a's launch at B=4096)."""
    props = torch.cuda.get_device_properties(0)
    per_sm = props.max_threads_per_multi_processor // 128 * 128
    return {"card": (props.multi_processor_count * per_sm, 128), "k1a": k1a_launch_shape()}


def nvidia_smi() -> str:
    """The timed card's ``name, power.limit`` as nvidia-smi gives them (the
    current card, asked by its UUID)."""
    return card_label()


def sm_clock_mhz() -> float:
    """The timed card's SM clock (MHz) as nvidia-smi reads it now."""
    return float(smi_query("clocks.sm", units=False).split()[0])


def calibrate_k(op: str, P: int, n_threads: int, threads_per_block: int, target_ms: float) -> int:
    """A chain length K at which one launch takes about ``target_ms``.  A
    short launch is all launch overhead, so K grows (16x at most a round)
    until a launch takes a quarter of the target, whose rate then sizes it."""
    K = 64
    while True:
        rate = rf.measure(op, P, n_threads, threads_per_block, K, launches=1)
        want = max(64, int(rate * target_ms / 1e3 / (n_threads * P)))
        if 1e3 * n_threads * K * P / rate >= target_ms / 4 or want <= K:
            return want
        K = min(want, 16 * K)


TARGET_MS, TIMED_LAUNCHES = 10.0, 10  # one timed launch's length, and their number


def rate_table(on_row) -> list:
    """Each op's rate at each launch shape and chain count: rows of op, P,
    shape, n_threads, threads_per_block, K, rate (element-ops/s), ms per
    launch, the SM clock read right after the timed launches, and the
    launches of K6 the row made.  ``on_row(row)`` is called as each row
    completes."""
    rows = []
    for shape, (n, tpb) in launch_shapes().items():
        for op in rf.OPS:
            for P in rf.KERNEL_P:
                before = rf.LAUNCHES["chain"]
                K = calibrate_k(op, P, n, tpb, TARGET_MS)
                rate = rf.measure(op, P, n, tpb, K, launches=TIMED_LAUNCHES)
                row = dict(op=op, P=P, shape=shape, n_threads=n, threads_per_block=tpb, K=K,
                           rate=rate, ms=1e3 * n * K * P / rate, sm_clock_mhz=sm_clock_mhz(),
                           launches=rf.LAUNCHES["chain"] - before)
                rows.append(row)
                on_row(row)
    return rows


def rates_at(rows: list, shape: str, P: int) -> dict:
    """{op: rate} of one shape and chain count."""
    return {r["op"]: r["rate"] for r in rows if r["shape"] == shape and r["P"] == P}


def k1a_rate() -> float:
    """K1a's env-steps/s at the headline config (PID, auto-reset, Dexcom,
    random meals; K1A_B patients of the cycled cohort, K1A_T steps per
    call): the median of K1A_CALLS calls by CUDA events after a warm-up."""
    from simglucose_tpu_torch import params as tables
    from simglucose_tpu_torch.models.uva_padova import basal_rate
    from simglucose_tpu_torch.ops import rollout as tr

    p = tables.load_patient_params(tables.cohort_names(K1A_B), device="cuda")
    packed = tr.pack_params(p, basal_rate(p))
    cfg = tr.RolloutConfig(n_steps=K1A_T, controller="pid")
    tr.rollout(cfg, packed, (0, 0))
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(K1A_CALLS)]
    for i, (start, end) in enumerate(events):
        start.record()
        tr.rollout(cfg, packed, (i + 1, 0))
        end.record()
    torch.cuda.synchronize()
    ms = statistics.median(start.elapsed_time(end) for start, end in events)
    return K1A_B * K1A_T / (ms / 1e3)


_SASS_FN = re.compile(r"Function : \S*chain_kernelILi(\d+)ELi(\d+)E")
_SASS_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)")
_SASS_TARGET = re.compile(r"^\s*`?\(?(0x[0-9a-f]+)")


def sass_text(lib_path: str):
    """``cuobjdump -sass`` of the built library (the toolkit's, beside
    nvcc); None where the toolkit has no cuobjdump."""
    from simglucose_tpu_torch.ops.build import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    return subprocess.run([cuobjdump, "-sass", lib_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout


def parse_sass_code(sass: str) -> dict:
    """{(op, P): [(address, opcode, predicated, branch target or None)]}
    of the K6 kernels in a SASS listing, in address order."""
    out, key = {}, None
    for line in sass.splitlines():
        m = _SASS_FN.search(line)
        if m:
            key = (rf.OPS[int(m.group(1))], int(m.group(2)))
            out[key] = []
            continue
        if "Function :" in line:
            key = None
        m = _SASS_INS.search(line)
        if key is not None and m:
            opcode = m.group(3)
            target = _SASS_TARGET.match(m.group(4)) if opcode.startswith("BRA") else None
            out[key].append((int(m.group(1), 16), opcode, bool(m.group(2)) and "PT" not in m.group(2),
                             int(target.group(1), 16) if target else None))
    return out


def parse_sass(sass: str) -> dict:
    """{(op, P): Counter of opcodes} of the K6 kernels in a SASS listing."""
    return {k: collections.Counter(ins[1] for ins in code)
            for k, code in parse_sass_code(sass).items()}


# ---------------------------------------------------------------------------
# The instructions an application issues
# ---------------------------------------------------------------------------
#
# The rates above count what each op computes (FLOP, transcendentals).  The
# kernels compute the IEEE and libm forms K1a uses, and those issue more:
# tanhf, expf and logf are MUFU plus FFMA range reduction, `/` a MUFU.RCP
# with Newton steps and a range check, select both arms and a compare.  So
# each op's least time for the same bits is the issue of its sequence, read
# from the SASS of its P=16 kernel: the instructions one trip of its main
# loop (the innermost loop holding the most applications: K >> the unroll)
# issues, divided by the applications of the trip.  Each application
# issues exactly one APP_MARKER instruction, which counts them.  A trip
# follows the path the data takes: a conditional branch over a subroutine
# call (the IEEE division's slow path, for a divisor outside the normal
# range; the probe's divisors lie in (1.7, 2.9)) is taken, any other falls
# through; predicated instructions issue either way.  The loop's own two or
# three instructions a trip are included (at most 4 of the 16 to 64
# applications of a trip).
APP_MARKER = dict(fma="FFMA", mul="FMUL", tanh="MUFU.EX2", exp="MUFU.EX2",
                  log="I2FP.F32.S32", div="MUFU.RCP", select="FSETP.GT.AND")

# The pipe of an opcode (before its first dot), by the rows of the CUDA C++
# Programming Guide's arithmetic-instruction throughput table for compute
# capability 9.0: fp32 add, multiply, multiply-add (128 a clock an SM; the
# half-precision HFMA2 that loads constants counted so too); int: 32-bit
# integer add, multiply-add, shift, logic, compare, min/max, and the
# compares, selects and moves (64); mufu: the special-function unit (16);
# conv: type conversions (16).  Branches, convergence barriers and uniform
# datapath instructions take no pipe of these: they count in the issue
# bound alone.
PIPES = dict(fp32=("FFMA", "FMUL", "FADD", "HFMA2"),
             int=("IADD3", "VIADD", "IMAD", "LOP3", "SHF", "LEA", "ISETP", "IMNMX", "FSETP",
                  "FSEL", "SEL", "FMNMX", "PLOP3", "MOV"),
             mufu=("MUFU",),
             conv=("I2F", "I2FP", "F2I", "F2IP", "F2F", "FRND"))


def pipe_of(opcode: str):
    """The pipe of ``opcode`` in :data:`PIPES`, or None."""
    base = opcode.split(".")[0]
    return next((p for p, names in PIPES.items() if base in names), None)


def hot_trip(code: list, marker: str):
    """(Counter of the opcodes one trip of the main loop issues, the
    applications of the trip): the backward branch whose loop body holds
    the most ``marker`` instructions, walked as the data goes."""
    best = (collections.Counter(), 0)
    for addr, _, _, target in code:
        if target is None or target > addr:
            continue
        body = [ins for ins in code if target <= ins[0] <= addr]
        index = {ins[0]: i for i, ins in enumerate(body)}
        trip, i = collections.Counter(), 0
        while i < len(body):
            a, opcode, predicated, tgt = body[i]
            trip[opcode] += 1
            if i == len(body) - 1:
                break
            if tgt is not None and tgt > a and tgt in index:
                j = index[tgt]
                if not predicated or any(ins[1].startswith("CALL") for ins in body[i + 1:j]):
                    i = j
                    continue
            i += 1
        if trip[marker] > best[1]:
            best = (trip, trip[marker])
    return best


def app_counts(code: list, op: str, P: int) -> dict:
    """{opcode: instructions a K6 application of ``op`` issues} from its
    kernel's ``code`` (:func:`parse_sass_code`) at P chains; raises where
    the main loop's applications are not a whole number of iterations."""
    trip, apps = hot_trip(code, APP_MARKER[op])
    if apps == 0 or apps % P:
        raise ValueError(f"K6 {op} P={P}: the main loop holds {apps} {APP_MARKER[op]}, "
                         f"not a positive multiple of {P}")
    return {k: v / apps for k, v in sorted(trip.items())}


def pipe_counts(counts: dict) -> dict:
    """{pipe: instructions} of an opcode count, and ``issue``: all of
    them."""
    out = collections.Counter()
    for opcode, n in counts.items():
        pipe = pipe_of(opcode)
        if pipe:
            out[pipe] += n
        out["issue"] += n
    return dict(out)


def mix_pipe_counts(mix: dict, per_op: dict) -> dict:
    """{pipe: instructions} per env step of an op ``mix``, each op at its
    per-application pipe counts ``per_op`` (op -> :func:`pipe_counts`)."""
    out = collections.Counter()
    for c, v in mix.items():
        for pipe, n in per_op[c].items():
            out[pipe] += v * n
    return dict(out)


def float_opcodes(counts: collections.Counter) -> dict:
    """The floating-point and special-function opcodes of one kernel."""
    return {k: v for k, v in sorted(counts.items()) if k.startswith(("F", "MUFU"))}


def rate_line(r: dict, smi: str) -> str:
    """One row of :func:`rate_table` as a line, with the card beside it."""
    return (f"rate {r['shape']:4s} {r['op']:6s} P={r['P']:<2d} {r['rate']:.6g} element-ops/s "
            f"({r['n_threads']} threads in blocks of {r['threads_per_block']}, K={r['K']}, "
            f"{r['ms']:.4f} ms per launch); {smi}; clocks.sm {r['sm_clock_mhz']} MHz")


def ceiling_report(rows: list, measured: float, smi: str):
    """(lines, {"<shape>_P<P>": env-steps/s}): K1a's mix and its ceiling at
    each shape and chain count beside its measured env-steps/s."""
    lines = [f"K1a op mix per env step (PID, st=3, rk4; csrc/rollout_math.cuh): "
             f"{json.dumps({k: round(v, 3) for k, v in MIX.items()})}; "
             f"{mix_flop(MIX):.1f} FLOP and {mix_sfu(MIX):.1f} transcendentals"]
    ceilings = {}
    for shape in ("card", "k1a"):
        for P in rf.KERNEL_P:
            c = ceilings[f"{shape}_P{P}"] = ceiling(MIX, rates_at(rows, shape, P))
            lines.append(f"ceiling {shape:4s} P={P:<2d} {c:.6g} env-steps/s; K1a measured "
                         f"{measured:.6g} env-steps/s (B={K1A_B}) = {measured / c:.4f} of it; {smi}")
    return lines, ceilings


def sass_lines(sass) -> list:
    """The float and MUFU opcodes of each op's one-chain kernel, a line
    each."""
    if sass is None:
        return ["sass: the toolkit has no cuobjdump, not read"]
    return [f"sass {op} P=1: {json.dumps(float_opcodes(sass[(op, 1)]))}" for op in rf.OPS]


def per_app_counts(code) -> dict:
    """{op: {opcode: instructions an application issues}} from the P=16
    kernels (:func:`app_counts`); None where the SASS was not read."""
    if code is None:
        return None
    return {op: app_counts(code[(op, 16)], op, 16) for op in rf.OPS}


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("roofline_rollout measures the card: CUDA is not available")
    from simglucose_tpu_torch.ops import build

    build.load_library()
    smi = nvidia_smi()
    print(f"{smi}; torch {torch.__version__}; {torch.cuda.get_device_name(0)}", flush=True)
    sass = sass_text(build.BUILD_INFO["path"])
    print("\n".join(sass_lines(sass and parse_sass(sass))), flush=True)
    counts = per_app_counts(sass and parse_sass_code(sass))
    for op, c in (counts or {}).items():
        print(f"issue {op}: per application {json.dumps({k: round(v, 4) for k, v in c.items()})}; "
              f"by pipe {json.dumps({k: round(v, 4) for k, v in pipe_counts(c).items()})}", flush=True)
    rows = rate_table(lambda r: print(rate_line(r, smi), flush=True))
    measured = k1a_rate()
    lines, ceilings = ceiling_report(rows, measured, smi)
    print("\n".join(lines), flush=True)
    print(json.dumps(dict(device=smi, mix=MIX, k1a_env_steps_per_sec=measured, ceilings=ceilings,
                          rows=rows)), flush=True)


if __name__ == "__main__":
    main()
