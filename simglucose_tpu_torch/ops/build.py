"""Build and load the CUDA kernels of the port.

The ``.cu`` files of ``csrc/`` (the rollout kernels K1a/K1b in
``rollout.cu``, the learner kernels K2-K5 in ``ppo_learner.cu``, the
roofline probe K6 in ``roofline.cu``, with their ``.cuh`` headers) are
compiled by ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started
together, and linked into one shared library with a plain C interface,
loaded through ``ctypes`` — no PyTorch headers, so a build takes seconds.
The library is cached in ``simglucose_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources, the flags and
the nvcc version; a fresh checkout builds at first use.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("rollout.cu", "rollout_math.cuh", "ppo_learner.cu", "ppo_math.cuh", "roofline.cu",
           "roofline_math.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _declare(lib) -> None:
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.sgt_rollout_launch.argtypes = [vp] * 13
    lib.sgt_rollout_launch.restype = ctypes.c_int
    lib.sgt_philox_probe.argtypes = [vp, ctypes.c_int, u32, u32, u32, u32, vp]
    lib.sgt_philox_probe.restype = ctypes.c_int
    lib.sgt_rollout_nn_launch.argtypes = [vp] * 16
    lib.sgt_rollout_nn_launch.restype = ctypes.c_int
    i32, f32 = ctypes.c_int, ctypes.c_float
    lib.sgt_gae_launch.argtypes = [i32, i32, vp, vp, vp, vp, f32, f32, vp, vp]
    lib.sgt_gae_launch.restype = ctypes.c_int
    lib.sgt_ppo_grad_launch.argtypes = [vp, i32, vp, vp]
    lib.sgt_ppo_grad_launch.restype = ctypes.c_int
    lib.sgt_ppo_grad12_launch.argtypes = [vp, i32, vp, vp]
    lib.sgt_ppo_grad12_launch.restype = ctypes.c_int
    lib.sgt_ppo_epoch_launch.argtypes = [vp, vp]
    lib.sgt_ppo_epoch_launch.restype = ctypes.c_int
    lib.sgt_ppo_smem_bytes.argtypes = [i32, i32]
    lib.sgt_ppo_smem_bytes.restype = ctypes.c_int
    lib.sgt_chain_launch.argtypes = [i32, i32, vp, vp, i32, i32, i32, vp]
    lib.sgt_chain_launch.restype = ctypes.c_int


def load_library():
    """The kernels' ``ctypes`` library, built first if no cached build of
    the current sources exists.  Fills :data:`BUILD_INFO` with the build
    time, the nvcc version and ptxas' register/spill report."""
    global _LIB
    if _LIB is not None:
        return _LIB
    nvcc = _nvcc()
    version = subprocess.run(
        [nvcc, "--version"], check=True, capture_output=True, text=True
    ).stdout
    h = hashlib.sha256(version.encode() + repr(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"sgt_kernels_{tag}.so")
    log = so[:-3] + ".ptxas.txt"
    seconds = 0.0
    if not os.path.exists(so):
        tmp = f"{so}.tmp{os.getpid()}"
        tic = time.perf_counter()
        units = [n for n in SOURCES if n.endswith(".cu")]
        objs = [f"{tmp}.{n}.o" for n in units]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, n)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for n, obj in zip(units, objs)
        ]
        logs = []
        for n, p in zip(units, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {n} ({p.returncode}):\n{err}")
            logs.append(err)
        proc = subprocess.run(
            [nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True
        )
        seconds = time.perf_counter() - tic
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        for obj in objs:
            os.remove(obj)
        with open(log, "w") as f:
            f.write("".join(logs))
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _declare(lib)
    ptxas = ""
    if os.path.exists(log):
        with open(log) as f:
            ptxas = f.read()
    BUILD_INFO.update(
        path=so, build_seconds=seconds, nvcc=version.strip().splitlines()[-1],
        ptxas=ptxas,
    )
    _LIB = lib
    return lib
