"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use every ``csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/kernels/<hash>/`` at the repo root
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached library.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0. ``LAUNCHES`` holds one plain integer
per kernel, which each wrapper increments where it launches its kernel
and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_REPO = os.path.dirname(os.path.dirname(_HERE))
BUILD_ROOT = os.path.join(_REPO, "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: kernel name -> launches since the last ``reset_launches``
LAUNCHES = {"bilstm": 0, "mega_exec": 0}

_lib = None
#: what the last build printed (ptxas register/spill report) and took
BUILD_INFO = {"seconds": 0.0, "log": "", "cached": False}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    deps = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs, deps


def build():
    """Compile (or load the cached) kernel library; returns the CDLL."""
    global _lib
    if _lib is not None:
        return _lib
    srcs, deps = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + deps:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libstair_kernels.so")
    t0 = time.perf_counter()
    if os.path.exists(so):
        BUILD_INFO["cached"] = True
    else:
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-o", tmp, *srcs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_INFO["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed (%d):\n%s" % (proc.returncode, BUILD_INFO["log"])
            )
        os.replace(tmp, so)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.stair_bilstm_fwd.restype = I
    lib.stair_bilstm_fwd.argtypes = [
        P, P, P, P, P, P, P,       # xp_f, xp_b, mask, wh_f, wh_b, bias_f/b
        P, P, P,                   # tok_f, tok_b, sent
        I, I, I, I,                # B, L, h, bf16
        P,                         # stream
    ]
    lib.stair_mega_exec_fwd.restype = I
    lib.stair_mega_exec_fwd.argtypes = [
        P, I,                      # pointer table, its length
        P, P, P, P,                # rv, rf, ra, workspace
        I, I, I, I, I, I, I, I,    # B, T, Nv, Nf, Na, F, H, L
        I, I,                      # bf16, fsoft
        P,                         # stream
    ]
    _lib = lib
    return lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous, and not requiring grad (the CUDA
    kernels have no backward yet)."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.requires_grad:
        raise ValueError(f"{name}: the CUDA kernels have no backward yet")
