"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use every ``csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` process per source, all started together) and
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/kernels/<hash>/`` at the repo root
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached library.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0. ``LAUNCHES`` holds one plain integer
per kernel launch site, which each wrapper increments where it launches
its kernel and nowhere else:

- ``bilstm``, ``bilstm_train``: the BiLSTM forward, eval and training,
  on its general route (the shapes the cluster kernels refuse;
  ``csrc/bilstm.cu``);
- ``bilstm_tc``, ``bilstm_train_tc``: the BiLSTM forward, eval and
  training, on its cluster route (bf16, the main path's);
- ``bilstm_f32c``, ``bilstm_train_f32c``: the BiLSTM forward, eval and
  training, on its float32 cluster route (the float32 NMN's and the
  program parser's);
- ``bilstm_bwd``, ``bilstm_dwh``: its backward on the general route
  (the shapes the cluster kernels refuse), the reverse walk and the
  dwh/dbias reduction launch;
- ``bilstm_bwd_tc``, ``bilstm_dwh_tc``, ``bilstm_dwh_sum``: its backward on
  the cluster route (bf16, the main path's), the reverse walk on a
  thread-block cluster, the tensor-core dwh slices and their sum in split
  order with dbias;
- ``bilstm_bwd_f32c``, ``bilstm_dwh_f32c`` (and ``bilstm_dwh_sum``): its
  backward on the float32 cluster route (the float32 NMN's and the program
  parser's), the reverse walk on a thread-block cluster and the float32 dwh
  slices;
- ``mega_exec``, ``mega_exec_train``: the executor forward, eval and
  training, on its general route (``csrc/mega_exec.cu``
  ``mega_exec_kernel``: float32, and the widths the other refuses);
- ``mega_exec_tc``, ``mega_exec_train_tc``: the eval and training forward
  on its tensor-core route (bf16, the main paths'; ``mega_exec_tc_kernel``
  without and with dropout; above 64 frames an example on a thread-block
  cluster of frame-row slices, ``CLUSTERS`` counting them by size);
- ``mega_exec_fma32``, ``mega_exec_train_fma32``: the eval and training
  forward on its float32 "fma32" route (``mega_exec_kernel<float, true>``:
  the general kernel with its products on ``gemm32``, an example on a
  thread-block cluster while one CTA an example under-fills the card;
  ``CLUSTERS`` counts these launches by cluster size);
- ``mega_exec_bwd``, ``mega_exec_wgrad``: its backward on the general route
  (``csrc/mega_grad.cu``), the reverse walk and the weight-gradient
  reduction launch;
- ``mega_exec_bwd_tc``, ``mega_exec_wgrad_tc``: the backward on the
  tensor-core route (bf16, the main path's; ``csrc/mega_grad_tc.cu``; the
  walk on the forward's cluster, counted in ``CLUSTERS``);
- ``mega_exec_bwd_fma32``, ``mega_exec_wgrad_fma32``: the backward on the
  float32 "fma32" route (``csrc/mega_grad.cu`` ``mega_bwd_kernel<float,
  true>``; the weight gradients' call launches its row index, then
  ``mega_wgrad_fma32_kernel``);
- ``flash_attn``: the masked flash-attention forward
  (``csrc/flash_attn.cu``);
- ``flash_attn_bwd_dq``, ``flash_attn_bwd_dkv``: its backward
  (``csrc/flash_attn_bwd.cu``), the dQ launch and the dK/dV launch;
- ``executor_step``: one step of the scan executor on its general route
  (``csrc/executor_step.cu`` ``step_kernel``: the dtypes and widths the
  other two refuse);
- ``executor_step_tc``: one step on its tensor-core route (bf16, the main
  path's; ``executor_step_tc_kernel``: above 64 frames a tile on a
  thread-block cluster of frame-row slices, ``CLUSTERS`` counting them by
  size);
- ``executor_step_fma32``: one step on its float32 "fma32" route
  (``executor_step_fma32_kernel``: a small batch's tiles each on a
  thread-block cluster, its products on ``gemm32``; ``CLUSTERS`` counts
  these launches by cluster size);
- ``slot_set_many``, ``slot_zero_many``, ``slot_add_many``: several
  in-place register-slot updates of one kind in one launch
  (``csrc/regslots.cu``; the reversible executor's four sets, eight zeros
  and seven adds of a scan step);
- ``slot_set``, ``slot_zero``, ``slot_add``: a single update, the
  one-entry case of the same kernels.

``header_ints`` reads ``constexpr int`` values from a ``csrc`` source, so
a limit the kernels check has one home (``csrc/mega_limits.cuh``; the
BiLSTM cluster routes' ``TC_MAX_H``, ``F32_MAX_H`` and batch tiles in
``csrc/bilstm.cu``;
the attention backward's dK/dV tile in ``csrc/flash_attn_bwd.cu``).
``ptxas_report`` reads registers and spills per kernel from a build log.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_REPO = os.path.dirname(os.path.dirname(_HERE))
BUILD_ROOT = os.path.join(_REPO, "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: kernel name -> launches since the last ``reset_launches``
LAUNCHES = {
    "bilstm": 0, "bilstm_train": 0, "bilstm_tc": 0, "bilstm_train_tc": 0,
    "bilstm_f32c": 0, "bilstm_train_f32c": 0,
    "bilstm_bwd": 0, "bilstm_dwh": 0,
    "bilstm_bwd_tc": 0, "bilstm_dwh_tc": 0, "bilstm_dwh_sum": 0,
    "bilstm_bwd_f32c": 0, "bilstm_dwh_f32c": 0,
    "mega_exec": 0, "mega_exec_train": 0, "mega_exec_tc": 0,
    "mega_exec_train_tc": 0, "mega_exec_bwd": 0, "mega_exec_wgrad": 0,
    "mega_exec_bwd_tc": 0, "mega_exec_wgrad_tc": 0,
    "mega_exec_fma32": 0, "mega_exec_train_fma32": 0,
    "mega_exec_bwd_fma32": 0, "mega_exec_wgrad_fma32": 0, "flash_attn": 0,
    "flash_attn_bwd_dq": 0,
    "flash_attn_bwd_dkv": 0, "executor_step": 0, "executor_step_tc": 0,
    "executor_step_fma32": 0,
    "slot_set": 0, "slot_zero": 0, "slot_add": 0, "slot_set_many": 0,
    "slot_zero_many": 0, "slot_add_many": 0,
}

#: the "fma32" and tensor-core executor launches by cluster size
#: (``csrc/mega_common.cuh`` mega32_cluster, tc_cluster; ``csrc/
#: executor_step.cu`` step32_cluster, step_tc_pick; 1: one CTA an example
#: or tile) since the last ``reset_launches``: launch key -> {CTAs of an
#: example's or a tile's cluster: launches} (``mega_exec_fma32``,
#: ``mega_exec_train_fma32``, ``mega_exec_bwd_fma32``; ``mega_exec_tc``,
#: ``mega_exec_train_tc``, ``mega_exec_bwd_tc``; the step kernel's
#: ``executor_step_tc``, ``executor_step_fma32``; each also counted in
#: ``LAUNCHES``)
FMA32_CLUSTER_KEYS = ("mega_exec_fma32", "mega_exec_train_fma32",
                      "mega_exec_bwd_fma32")
TC_CLUSTER_KEYS = ("mega_exec_tc", "mega_exec_train_tc", "mega_exec_bwd_tc")
STEP_CLUSTER_KEYS = ("executor_step_tc", "executor_step_fma32")
CLUSTERS = {k: collections.Counter()
            for k in FMA32_CLUSTER_KEYS + TC_CLUSTER_KEYS + STEP_CLUSTER_KEYS}

_lib = None
#: what the last build printed (ptxas register/spill report) and took, in
#: all and by source (seconds from the start until its nvcc ended)
BUILD_INFO = {"seconds": 0.0, "log": "", "cached": False,
              "source_seconds": {}}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for c in CLUSTERS.values():
        c.clear()


def header_ints(name: str) -> dict:
    """``constexpr int NAME = value;`` definitions of ``csrc/<name>``."""
    with open(os.path.join(_CSRC, name)) as f:
        text = f.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr\s+int\s+(\w+)\s*=\s*(-?\d+)\s*;", text)}


def kernel_label(mangled: str) -> str:
    """A readable name for a mangled kernel symbol of the port:
    ``flash_bwd_dkv_mma<128, 4, 32, 2>`` for
    ``_ZN5stair17flash_bwd_dkv_mmaILi128ELi4ELi32ELi2EEEvNS_12...``;
    integer, ``bool``, ``float`` and named template arguments; anything
    else as it is."""
    if not mangled.startswith("_ZN"):
        return mangled
    pos, name = 3, None
    while pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group())
        pos += len(m.group())
        name = mangled[pos:pos + n]
        pos += n
    if name is None:
        return mangled
    if pos >= len(mangled) or mangled[pos] != "I":
        return name
    targs = []
    for tok in re.finditer(r"Li(-?\d+)E|Lb([01])E|(f)|(\d+)",
                           mangled[pos + 1:]):
        if tok.group(1) is not None:
            targs.append(tok.group(1))
        elif tok.group(2) is not None:
            targs.append("true" if tok.group(2) == "1" else "false")
        elif tok.group(3):
            targs.append("float")
        else:
            n = int(tok.group(4))
            start = pos + 1 + tok.end()
            targs.append(mangled[start:start + n])
            break
        if mangled[pos + 1 + tok.end():].startswith("E"):
            break
    return f"{name}<{', '.join(targs)}>"


def ptxas_report(log: str) -> list:
    """Per kernel compiled in an ``nvcc -Xptxas -v`` log: ``{"kernel":
    kernel_label, "registers", "spill_stores", "spill_loads"}`` (bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": kernel_label(m.group(1))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def pointers(tensors):
    """A ctypes array of the tensors' device pointers (a ``void* const*``
    argument)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


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
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
                for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        logs, secs = [None] * len(procs), {}

        def drain(i):
            logs[i] = procs[i].communicate()[0]
            secs[os.path.basename(srcs[i])] = round(
                time.perf_counter() - t0, 1)

        waits = [threading.Thread(target=drain, args=(i,))
                 for i in range(len(procs))]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        BUILD_INFO["log"] = "".join(logs)
        BUILD_INFO["source_seconds"] = secs
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n%s" % BUILD_INFO["log"])
        tmp = f"{so}.{tag}"
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        for obj in objs:
            os.remove(obj)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed:\n%s"
                               % (proc.stdout + proc.stderr))
        os.replace(tmp, so)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    U, Fl = ctypes.c_uint, ctypes.c_float
    bind_bilstm(lib)
    lib.stair_mega_exec_fwd.restype = I
    lib.stair_mega_exec_fwd.argtypes = [
        P, I,                      # pointer table, its length
        P, P, P, P,                # rv, rf, ra, workspace
        I, I, I, I, I, I, I, I,    # B, T, Nv, Nf, Na, F, H, L
        I, I,                      # bf16, fsoft
        I, I, I, U, Fl,            # dropout: on, seed0, seed1, thresh, scale
        P,                         # stream
    ]
    lib.stair_mega_exec_fwd_tc.restype = I
    lib.stair_mega_exec_fwd_tc.argtypes = [
        P, I,                      # pointer table, its length
        P, P, P, P,                # rv, rf, ra, workspace
        I, I, I, I, I, I, I, I,    # B, T, Nv, Nf, Na, F, H, L
        I,                         # fsoft
        I, P,                      # cluster (0: the launch's pick), &used
        P,                         # stream
    ]
    lib.stair_mega_exec_fwd_tc_train.restype = I
    lib.stair_mega_exec_fwd_tc_train.argtypes = [
        P, I,                      # pointer table, its length
        P, P, P, P,                # rv, rf, ra, workspace
        I, I, I, I, I, I, I, I,    # B, T, Nv, Nf, Na, F, H, L
        I,                         # fsoft
        I, I, I, U, Fl,            # dropout: on, seed0, seed1, thresh, scale
        I, P,                      # cluster (0: the launch's pick), &used
        P,                         # stream
    ]
    lib.stair_mega_exec_fwd_fma32.restype = I
    lib.stair_mega_exec_fwd_fma32.argtypes = [
        P, I,                      # pointer table, its length
        P, P, P, P,                # rv, rf, ra, workspace
        I, I, I, I, I, I, I, I,    # B, T, Nv, Nf, Na, F, H, L
        I,                         # fsoft
        I, I, I, U, Fl,            # dropout: on, seed0, seed1, thresh, scale
        I, P,                      # cluster (0: the launch's pick), &used
        P,                         # stream
    ]
    lib.stair_mega_exec_fma32_fit.restype = I
    lib.stair_mega_exec_fma32_fit.argtypes = [I]            # cluster size
    lib.stair_mega_exec_bwd_fma32_fit.restype = I
    lib.stair_mega_exec_bwd_fma32_fit.argtypes = [I, I, I]  # F, H, cluster
    lib.stair_mega_exec_fma32_cluster.restype = I
    lib.stair_mega_exec_fma32_cluster.argtypes = [I, I]     # B, H
    lib.stair_mega_exec_bwd_fma32_cluster.restype = I
    lib.stair_mega_exec_bwd_fma32_cluster.argtypes = [I, I, I]  # B, F, H
    Lg = ctypes.c_long
    lib.stair_mega_exec_fma32_smem.restype = Lg
    lib.stair_mega_exec_fma32_smem.argtypes = []
    lib.stair_mega_exec_bwd_smem.restype = Lg
    lib.stair_mega_exec_bwd_smem.argtypes = [I, I, I]       # F, H, fma32
    lib.stair_mega_f32_product_check.restype = I
    # A, W, M, K, N, nk, bn, reps, out_gemm, out_gemm32, clocks, stream
    lib.stair_mega_f32_product_check.argtypes = [P, P, I, I, I, I, I, I, P,
                                                 P, P, P]
    lib.stair_mega_exec_tc_smem.restype = Lg
    lib.stair_mega_exec_tc_smem.argtypes = [I, I, I]        # F, H, L
    lib.stair_mega_exec_tc_sliced_smem.restype = Lg
    lib.stair_mega_exec_tc_sliced_smem.argtypes = [I, I, I]  # F, H, L
    lib.stair_mega_exec_tc_slots.restype = I
    lib.stair_mega_exec_tc_slots.argtypes = [I, I, I]       # F, H, L
    lib.stair_mega_exec_tc_cluster.restype = I
    lib.stair_mega_exec_tc_cluster.argtypes = [I, I, I, I]  # B, F, H, L
    lib.stair_mega_exec_bwd_tc_cluster.restype = I
    lib.stair_mega_exec_bwd_tc_cluster.argtypes = [I, I, I]  # B, F, H
    lib.stair_mega_exec_bwd_tc_smem.restype = Lg
    lib.stair_mega_exec_bwd_tc_smem.argtypes = [I, I]       # F, H
    lib.stair_mega_recompute_check.restype = I
    # A, B, M, K, N, vec, chain, hbuf, out_fwd, out_walk, stream
    lib.stair_mega_recompute_check.argtypes = [P, P, I, I, I, I, I, P, P, P,
                                               P]
    for sfx in ("f32", "bf16", "tc", "fma32"):
        fn = getattr(lib, f"stair_mega_exec_bwd_{sfx}")
        fn.restype = I
        fn.argtypes = [
            P, I,                      # pointer table, its length
            P,                         # workspace
            I, I, I, I, I, I, I, I,    # B, T, Nv, Nf, Na, F, H, L
            I,                         # fsoft
            I, I, I, U, Fl,            # dropout: on, seed0, seed1, thresh,
                                       # scale
            # the "fma32" and tensor-core walks: cluster (0: the launch's
            # pick), &used
            *((I, P) if sfx in ("fma32", "tc") else ()),
            P,                         # stream
        ]
        fn = getattr(lib, f"stair_mega_exec_wgrad_{sfx}")
        fn.restype = I
        fn.argtypes = [P, I, I, I, I, I, P]  # pointers, n, B, T, F, H, stream
    lib.stair_flash_attn_fwd.restype = I
    lib.stair_flash_attn_fwd.argtypes = [P, P]   # FlashArgs*, stream
    for fn in (lib.stair_flash_attn_bwd_dq, lib.stair_flash_attn_bwd_dkv):
        fn.restype = I
        fn.argtypes = [P, P]                     # FlashBwdArgs*, stream
    bind_step(lib)
    lib.stair_slot_launch.restype = I
    # SlotLaunch* (regslots._Launch), step t, stream
    lib.stair_slot_launch.argtypes = [P, Lg, P]
    _lib = lib
    return lib


def bind_step(lib):
    """Set the argument types of ``csrc/executor_step.cu``'s entry points
    on ``lib`` (the whole library, or that source built alone)."""
    P, I, Lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.stair_executor_step.restype = I
    lib.stair_executor_step.argtypes = [
        P, I,                      # pointer table, its length
        P,                         # workspace
        I, I, I, I, I, I,          # B, Nv, Nf, Na, F, H
        I,                         # bf16
        P,                         # stream
    ]
    for fn in (lib.stair_executor_step_tc, lib.stair_executor_step_fma32):
        fn.restype = I
        fn.argtypes = [
            P, I,                  # pointer table, its length
            P,                     # workspace
            I, I, I, I, I, I,      # B, Nv, Nf, Na, F, H
            I, P,                  # cluster (0: the launch's pick), &used
            P,                     # stream
        ]
    lib.stair_executor_step_tc_smem.restype = Lg
    lib.stair_executor_step_tc_smem.argtypes = [I, I, I]    # F, H, sliced
    lib.stair_executor_step_tc_cluster.restype = I
    lib.stair_executor_step_tc_cluster.argtypes = [I, I, I]  # B, F, H
    lib.stair_executor_step_fma32_smem.restype = Lg
    lib.stair_executor_step_fma32_smem.argtypes = [I, I]    # F, H
    lib.stair_executor_step_fma32_cluster.restype = I
    lib.stair_executor_step_fma32_cluster.argtypes = [I, I, I]  # B, F, H


def bind_bilstm(lib):
    """Set the argument types of the BiLSTM entry points of ``lib`` (the
    whole library, or ``csrc/bilstm.cu`` built alone)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.stair_bilstm_fwd.restype = I
    lib.stair_bilstm_fwd.argtypes = [
        P, P, P, P, P, P, P,       # xp_f, xp_b, mask, wh_f, wh_b, bias_f/b
        P, P, P,                   # tok_f, tok_b, sent
        P,                         # state stacks (null in eval)
        I, I, I, I,                # B, L, h, bf16
        P,                         # stream
    ]
    for fn in (lib.stair_bilstm_fwd_tc, lib.stair_bilstm_fwd_f32c):
        fn.restype = I
        fn.argtypes = [
            P, P,                  # pointers, state stacks (null in eval)
            I, I, I, I,            # B, L, h, batch tile
            P,                     # stream
        ]
    for fn in (lib.stair_bilstm_bwd, lib.stair_bilstm_dwh):
        fn.restype = I
        fn.argtypes = [P, I, I, I, I, P]   # pointers, B, L, h, bf16, stream
    for fn in (lib.stair_bilstm_bwd_tc, lib.stair_bilstm_dwh_tc,
               lib.stair_bilstm_dwh_f32c):
        fn.restype = I
        fn.argtypes = [P, I, I, I, P]      # pointers, B, L, h, stream
    lib.stair_bilstm_bwd_f32c.restype = I
    # pointers, B, L, h, batch tile, stream
    lib.stair_bilstm_bwd_f32c.argtypes = [P, I, I, I, I, P]
    lib.stair_bilstm_dwh_sum.restype = I
    lib.stair_bilstm_dwh_sum.argtypes = [P, I, I, P]  # pointers, nb, h, stream
    for fn in (lib.stair_bilstm_fwd_tc_clusters,
               lib.stair_bilstm_fwd_f32c_clusters,
               lib.stair_bilstm_bwd_f32c_clusters):
        fn.restype = I
        fn.argtypes = [I, I, P]            # h, tile, &out


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_cpu(name, t) -> bool:
    """The wrappers' route: True for a CPU tensor (the plain version runs),
    False for a CUDA tensor (the kernel launches); any other device
    raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cpu"


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous, and detached. A kernel reads raw
    device pointers and records nothing for autograd; gradients go through
    the ``torch.autograd.Function``s around the forward and backward
    kernels (``lstm.BiLSTMTrain``, ``mega_grad.MegaExecTrain``,
    ``attention.FlashAttention``), which
    hand the kernels detached tensors."""
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
        raise ValueError(f"{name}: a kernel takes detached tensors; "
                         "differentiate through the autograd Functions")
