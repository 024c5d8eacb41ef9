"""Section clocks of the executor's kernels at the train step's shapes, on
one NVIDIA GPU: the share of #5 (the training forward) and of #6's walk
spent in each product helper, on each route; with ``--step``, the share of
the float32 step kernel (#10) spent in each of its sections.

    python -m stair_tpu_torch.scripts.executor_clocks [--routes tc,general,fma32]
        [--frames 64] [--batch 128] [--clusters 1,4]
    python -m stair_tpu_torch.scripts.executor_clocks --step [--routes general,fma32]

Routes (``mega_exec.fwd_route`` / ``mega_grad.bwd_route`` forced to each):

- ``tc``: bf16, ``mega_exec_tc_kernel<true>`` and ``mega_bwd_tc_kernel``;
  sections ``fwd_gemm``, ``walk_gemm``, ``vecmat_tc`` and the walk's
  gradient products (``grad_tc``);
- ``general``: float32, ``mega_exec_kernel<float, false>`` and
  ``mega_bwd_kernel<float, false>`` on ``stair::mega::gemm``; sections
  ``gemm`` with B as stored (stage 1, the projections, the keyword products
  and SUPF's two ``m1`` products) and with B transposed (the gradient
  products ``dY @ W^T`` and SUPF's ``w1 @ feat^T``), ``vecmat`` and
  ``mmT_vec``;
- ``fma32``: float32, ``mega_exec_kernel<float, true>`` and
  ``mega_bwd_kernel<float, true>``: the same sections with ``gemm32`` in
  ``gemm``'s place (SUPF's ``m1`` products stay on ``gemm``), on the
  cluster size each launch picks or, with ``--clusters 1,4``, on each size
  given; a cluster's CTAs wait for each other in ``cluster barriers`` (the
  shares are of every CTA's clocks: on a cluster the lead's passes show as
  the other CTAs' barrier time).

It copies ``ops/csrc`` into ``build/clocks/`` and patches the copy: each
block's thread 0 reads ``clock64()`` on entry to and return from each
helper and each kernel, and adds the difference into a ``__device__``
array. It builds the route's two sources alone from the copy, binds them in
place of the library's entry points and runs #5, then #6 (walk and weight
gradients), five times each on the inputs of
``scripts/bench_train_step.py``'s configuration (B 128, H 512, F 64,
dropout 0.25; weights from seed 0, the BiLSTM's plain version for the
token rows), or at ``--frames`` and ``--batch`` (the NMN CLIs' defaults:
``--frames 150 --batch 32``). It prints each kernel's time a call (CUDA events,
instrumented), each section's share of the kernel's clocks summed over
blocks (``rest``: what no section holds), and the device time of the
walk's and the weight-gradient kernels apart (``torch.profiler``; the
weight-gradient kernels hold no clock). The helpers that end in a barrier
(all but ``vecmat``) give the block's time in them. The repository's
sources are not touched.

``--step``: the fused step in float32 on the routes ``general``
(``step_kernel<float>``) and ``fma32`` (``executor_step_fma32_kernel``),
over the 16 launches of ``chip_smoke.py`` phase 15's float32 forward at F
64 (B 216, H 512; recorded on the CPU by
``scripts/step_fma32_variants.opcode_calls``). It patches a copy of
``csrc/executor_step.cu`` alone and builds it alone: each block's thread 0
reads ``clock64()`` at the end of each section and adds the time since the
last, less the time spent meanwhile in the products (``gemm`` /
``prod32``) and the cluster barriers, which have clocks of their own.
Sections: the products, the ExistsFrame cosine, pooled and HasItem, the
Localize cosines, the FilterFrame gate and the stage-2 operand, the stage-2
epilogue (LayerNorm, AttnVideo), the cluster barriers, and the schedule and
vector loads. It prints, per launch, the tiles with a product and the most
products a tile does, and per route the time of the 16 launches (CUDA
events, instrumented) and each section's share of the blocks' clocks.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import types

import torch

from stair_tpu_torch.ops import _build

#: clock slot -> section; slot KERNEL holds the whole kernel
SECTIONS = {0: "fwd_gemm", 1: "walk_gemm", 2: "vecmat_tc",
            3: "grad products", 5: "gemm (B as stored)",
            6: "gemm (B transposed)", 7: "vecmat", 8: "mmT_vec",
            9: "gemm32 (B as stored)", 10: "gemm32 (B transposed)",
            11: "cluster barriers"}
KERNEL = 4
NSLOTS = 16

_CLK = '''__device__ unsigned long long g_clk[%d];
struct Clk {
  int slot;
  long long c0;
  __device__ Clk(int s) : slot(s) {
#ifdef __CUDA_ARCH__
    c0 = clock64();
#endif
  }
  __device__ ~Clk() {
#ifdef __CUDA_ARCH__
    if (threadIdx.x == 0)
      atomicAdd(&g_clk[slot], (unsigned long long)(clock64() - c0));
#endif
  }
};
''' % NSLOTS

_READ = '''
extern "C" void stair_clk(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[%d] = {0};
    cudaMemcpyToSymbol(stair::mega::g_clk, z, sizeof(z));
  } else {
    cudaMemcpyFromSymbol(out, stair::mega::g_clk,
                         %d * sizeof(unsigned long long));
  }
}
''' % (NSLOTS, NSLOTS)

#: (file, anchor, the clock inserted after it); each anchor occurs once
_PATCHES = (
    ("mega_common.cuh", "namespace mega {\n", _CLK),
    ("mega_common.cuh",
     "int M, int K, int N, __nv_bfloat16* ring, Epi epi) {\n",
     "  Clk clk(0);\n"),
    ("mega_common.cuh",
     "  const int ld = K + TC_PAD, M = (rows + 15) & ~15;\n",
     "  Clk clk(1);\n"),
    ("mega_common.cuh", "float* part,\n                          Epi epi) {\n",
     "  Clk clk(2);\n"),
    ("mega_common.cuh",
     "int M, int K, int N, float* As, float* Bs,\n"
     "                     Epi epi) {\n",
     "  Clk clk(sbn == 1 ? 5 : 6);\n"),
    ("mega_common.cuh",
     "                       const T* W, int K, int N, Epi epi) {\n",
     "  Clk clk(7);\n"),
    ("mega_common.cuh",
     "int M, int K, int N, float* ring, Epi epi) {\n",
     "  Clk clk(NK ? 10 : 9);\n"),
    ("mega_common.cuh",
     "__device__ __forceinline__ void cluster_barrier() {\n",
     "  Clk clk(11);\n"),
    ("mega_grad.cu",
     "__device__ void mmT_vec(const float* g, const T* W, long ldw, int K, "
     "int N,\n                        float* out) {\n",
     "  Clk clk(8);\n"),
    ("mega_grad.cu",
     "__launch_bounds__(THREADS) mega_bwd_kernel(const BArgs<T> a) {\n",
     "  Clk clk(4);\n"),
    ("mega_exec.cu",
     "__launch_bounds__(THREADS) mega_exec_kernel(const Args<T> a) {\n",
     "  Clk clk(4);\n"),
    ("mega_grad_tc.cu", "                        float* scratch, Epi epi) {\n",
     "  Clk clk(3);\n"),
    ("mega_grad_tc.cu",
     "    mega_bwd_tc_kernel(const BArgs<__nv_bfloat16> a) {\n",
     "  Clk clk(4);\n"),
    ("mega_exec.cu",
     "  extern __shared__ __align__(16) unsigned char tc_smem[];\n",
     "  Clk clk(4);\n"),
)

#: the step kernel's clock slots (``--step``) -> section; STEP_KERNEL
#: holds the whole kernel
STEP_SECTIONS = {0: "products", 1: "ExistsFrame", 2: "pooled and HasItem",
                 3: "Localize", 4: "gate and stage-2 operand",
                 5: "stage-2 epilogue", 6: "cluster barriers",
                 7: "schedule and vectors"}
STEP_KERNEL = 8

_SCLK = '''__device__ unsigned long long g_sclk[%d];
// thread 0's lap start, and the nested clocks' time since
__device__ __forceinline__ long long* sclk_state() {
  __shared__ long long st[2];
  return st;
}
__device__ __forceinline__ void lap_start() {
  if (threadIdx.x == 0) {
    sclk_state()[0] = clock64();
    sclk_state()[1] = 0;
  }
}
// the time since the last lap, less the nested clocks', into slot
__device__ __forceinline__ void lap(int slot) {
  if (threadIdx.x == 0) {
    long long* st = sclk_state();
    const long long now = clock64();
    atomicAdd(&g_sclk[slot], (unsigned long long)(now - st[0] - st[1]));
    st[0] = now;
    st[1] = 0;
  }
}
// a nested clock: products, cluster barriers, the whole kernel
struct SClk {
  int slot;
  long long c0;
  __device__ SClk(int s) : slot(s) { c0 = clock64(); }
  __device__ ~SClk() {
    if (threadIdx.x == 0) {
      const long long d = clock64() - c0;
      atomicAdd(&g_sclk[slot], (unsigned long long)d);
      sclk_state()[1] += d;
    }
  }
};
''' % 16

_STEP_READ = '''
extern "C" void stair_sclk(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    cudaMemcpyToSymbol(g_sclk, z, sizeof(z));
  } else {
    cudaMemcpyFromSymbol(out, g_sclk, 16 * sizeof(unsigned long long));
  }
}
'''

#: (anchor, text before it, text after it) in executor_step.cu; each
#: anchor occurs once
_STEP_PATCHES = (
    ("namespace {\n", None, _SCLK),
    # the general route, step_kernel
    ("__device__ void gemm(const TA* A, const TW* W, int M, int H, Smem& sm,\n"
     "                     Epi epi) {\n", None, "  SClk clk(0);\n"),
    ("step_kernel(const Args<T> a) {\n  __shared__ Smem sm;\n", None,
     "  SClk kclk(8);\n  lap_start();\n"),
    ("  // ---- stage 1: expert two-layer MLP; pooled and hasitem ------------"
     "--\n  if (stage1) {\n    const T* w1", "  lap(7);\n", None),
    ("  // ---- existsframe cosine of the frames operand against va ---------"
     "---\n", "  lap(2);\n", None),
    ("  // ---- localize scores against both keyword operands --------------"
     "----\n  if (e1 == E1_LOCALIZE) {\n    loc_cos<T>(", "  lap(1);\n",
     None),
    ("  // ---- stage 2: FilterFrame / Temporal projection, or AttnVideo ----"
     "---\n  if (e2 == E2_FF && stage1) {\n    // gate = sigmoid(feat @ ffwf "
     "+ gkb) for the vec keyword, else 1\n    const float gk = a.gkb[b];\n"
     "    for (int f = warp; f < F; f += NWARPS) {\n      float d = 0.f;\n"
     "      if (ffv)\n        for (int k = lane; k < H; k += 32)\n"
     "          d += rd<T>(", "  lap(3);\n", None),
    ("    const T* b20 = a.b2t;\n", "    lap(4);\n", None),
    ("    const T* b21 = a.b2t + H;\n    gemm(ws_h", "    lap(4);\n", None),
    ("      fout[j] = from_f<T>(sm.f1[j / H] * to_f(x[j]));\n  }\n", None,
     "  lap(5);\n"),
    # the float32 route, executor_step_fma32_kernel
    ("__device__ void prod32(const float* A, const float* W, int F, int H, "
     "int c0,\n                       int N, float* ring, Epi epi) {\n", None,
     "  SClk clk(0);\n"),
    ("__device__ __forceinline__ void cluster_barrier() {\n", None,
     "  SClk clk(6);\n"),
    ("executor_step_fma32_kernel(const Args<float> a, int C) {\n", None,
     "  SClk kclk(8);\n  lap_start();\n"),
    ("  // ---- stage 1 on this CTA's columns; pooled and hasitem -----------"
     "----\n", "  lap(7);\n", None),
    ("  // ---- existsframe cosine of the frames operand against va, my rows "
     "-----\n", "  lap(2);\n", None),
    ("  // ---- localize scores against both keyword operands, my rows -----"
     "----\n", "  lap(1);\n", None),
    ("  // ---- stage 2: FilterFrame / Temporal projection, or AttnVideo ----"
     "---\n  const int e2 = ins[S_E2];\n", "  lap(3);\n", None),
    ("    cluster_barrier();   // the whole stage-2 operand\n    float* fout",
     "    lap(4);\n", None),
    ("    cluster_barrier();   // the whole stage-2 operand\n    {\n      const "
     "float* b21", "    lap(4);\n", None),
    ("        fout[(size_t)f * H + k] = aa[f] * x[(size_t)f * H + k];\n  }\n",
     None, "  lap(5);\n"),
)

P, I, U, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_DROP = [I, I, I, U, Fl]
_WALK = [P, I, P] + [I] * 9 + _DROP + [P]
#: the "fma32" and tensor-core entry points also take the cluster size and
#: &used
_WALK32 = [P, I, P] + [I] * 9 + _DROP + [I, P, P]
_WGRAD = [P, I, I, I, I, I, P]
#: route -> (compute dtype, sources, {entry point: argtypes}, kernels)
ROUTES = {
    "tc": ("bfloat16", ("mega_exec", "mega_grad_tc"), {
        "stair_mega_exec_fwd_tc_train": [P, I, P, P, P, P] + [I] * 9 + _DROP
        + [I, P, P],
        "stair_mega_exec_bwd_tc": _WALK32, "stair_mega_exec_wgrad_tc": _WGRAD},
        ("mega_exec_tc_kernel<true>", "mega_bwd_tc_kernel")),
    "general": ("float32", ("mega_exec", "mega_grad"), {
        "stair_mega_exec_fwd": [P, I, P, P, P, P] + [I] * 10 + _DROP + [P],
        "stair_mega_exec_bwd_f32": _WALK,
        "stair_mega_exec_wgrad_f32": _WGRAD},
        ("mega_exec_kernel<float, false>", "mega_bwd_kernel<float, false>")),
    "fma32": ("float32", ("mega_exec", "mega_grad_fma32"), {
        "stair_mega_exec_fwd_fma32": [P, I, P, P, P, P] + [I] * 9 + _DROP
        + [I, P, P],
        "stair_mega_exec_bwd_fma32": _WALK32,
        "stair_mega_exec_wgrad_fma32": _WGRAD},
        ("mega_exec_kernel<float, true>", "mega_bwd_kernel<float, true>")),
}


def patched_sources(out_dir):
    """A copy of ``ops/csrc`` in ``out_dir`` with the section clocks."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    shutil.copytree(csrc, out_dir)
    for name, anchor, text in _PATCHES:
        path = os.path.join(out_dir, name)
        with open(path) as f:
            src = f.read()
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor {anchor!r} found "
                               f"{src.count(anchor)} times")
        with open(path, "w") as f:
            f.write(src.replace(anchor, anchor + text))
    for name in ("mega_exec.cu", "mega_grad.cu", "mega_grad_tc.cu"):
        with open(os.path.join(out_dir, name), "a") as f:
            f.write(_READ)


def patched_step_source(out_dir):
    """A copy of ``ops/csrc`` in ``out_dir`` with the step kernel's section
    clocks in ``executor_step.cu``."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    shutil.copytree(csrc, out_dir)
    path = os.path.join(out_dir, "executor_step.cu")
    with open(path) as f:
        src = f.read()
    for anchor, before, after in _STEP_PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"executor_step.cu: anchor {anchor!r} found "
                               f"{src.count(anchor)} times")
        src = src.replace(anchor, (before or "") + anchor + (after or ""))
    with open(path, "w") as f:
        f.write(src + _STEP_READ)


def step_clocks(routes, dev, card, n=5):
    """The step kernel's sections on each route (``--step``)."""
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.scripts.step_fma32_variants import (
        opcode_calls, tiles_of,
    )

    out_dir = os.path.join(os.path.dirname(_build.BUILD_ROOT), "clocks_step")
    patched_step_source(out_dir)
    lib = build(out_dir, ["executor_step"])["executor_step"]
    _build.bind_step(lib)
    lib.stair_sclk.argtypes = [P, I]
    calls = opcode_calls(dev)
    for t, c in enumerate(calls):
        print(f"[clocks] #10 launch {t}: {json.dumps(tiles_of(c[0]))}",
              flush=True)
    pick, held = TE.step_route, _build._lib
    _build._lib = lib
    try:
        for route in routes:
            TE.step_route = lambda *a: route

            def run():
                return [TE.fused_step(*a) for a in calls]

            run()
            torch.cuda.synchronize()
            lib.stair_sclk(None, 1)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(n):
                run()
            ev1.record()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.stair_sclk(ctypes.cast(buf, P), 0)
            total = buf[STEP_KERNEL]
            held_s = sum(buf[i] for i in STEP_SECTIONS)
            shares = ", ".join(f"{name} {buf[i] / total:.3f}"
                               for i, name in STEP_SECTIONS.items() if buf[i])
            print(f"[clocks] #10 {route} route, float32, phase 15's "
                  f"{len(calls)} launches at B {calls[0][2].shape[0]} F 64: "
                  f"{ev0.elapsed_time(ev1) / n:.3f} ms (CUDA events, "
                  f"instrumented); share of the blocks' clocks: {shares}, "
                  f"rest {1 - held_s / total:.3f}; card {card}", flush=True)
    finally:
        TE.step_route, _build._lib = pick, held


def build(out_dir, names):
    """Build the patched sources ``names`` alone, in parallel; returns
    {name: CDLL}."""
    nvcc = _build._nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", out_dir, "-o",
         os.path.join(out_dir, n + ".so"), os.path.join(out_dir, n + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc {n}.cu failed:\n{log}")
    return {n: ctypes.CDLL(os.path.join(out_dir, n + ".so")) for n in procs}


@contextlib.contextmanager
def on_route(route):
    """The executor's forward and backward forced onto ``route``."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG

    picks = TX.fwd_route, TG.bwd_route
    TX.fwd_route = lambda *a: route
    TG.bwd_route = lambda *a: route
    try:
        yield
    finally:
        TX.fwd_route, TG.bwd_route = picks


def train_inputs(dtype, dev, frames=64, batch_size=128):
    """#5's and #6's inputs at the train step's shapes (F ``frames``, B
    ``batch_size``) in ``dtype``: meta, args and the dropout rate."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.testing import workload as W

    base = W.workload_config(hidden_size=512, video_size=1024,
                             text_size=300, max_video_length=frames)
    cfg = NMNConfig(**{**base.to_dict(), "compute_dtype": dtype,
                       "dropout": 0.25})
    batch = W.to_device(W.make_batch(cfg, batch_size=batch_size,
                                     question_len=16), dev)
    model = W.build_model(cfg, seed=0, device=dev)
    dt = model.compute_dtype
    p = tree_map(lambda x: x.detach(), model.param_tree())
    v = TL.bilstm_reference(*TL._prep(p["video_encoder"], batch["video"],
                                      batch["video_mask"], dt),
                            token_dtype=dt)
    q = TL.bilstm_reference(*TL._prep(p["text_encoder"], batch["question"],
                                      batch["question_mask"], dt),
                            token_dtype=dt)
    mods = tree_map(lambda x: x.to(dt), p["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], v[:2],
        batch["video_mask"].to(dt), q[:2], batch["question_mask"])
    return meta, args, cfg.dropout


def clock_route(route, libs, dev, card, frames=64, batch_size=128, n=5,
                cluster=None):
    """Run #5 and #6 on ``route`` with the patched library at F ``frames``
    and B ``batch_size`` (the "fma32" route on ``cluster`` CTAs an example,
    None: the launch's pick); print the sections' shares and the walk's
    and weight gradients' device times."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.scripts.executor_ab import kernel_ms

    dtype, names, entries, kernels = ROUTES[route]
    fns = {}
    for name, argtypes in entries.items():
        fn = next(getattr(lib, name) for lib in libs.values()
                  if hasattr(lib, name))
        fn.restype = I
        fn.argtypes = argtypes
        fns[name] = fn
    for lib in libs.values():
        lib.stair_clk.argtypes = [P, I]
    _build._lib = types.SimpleNamespace(**fns)
    meta, args, rate = train_inputs(dtype, dev, frames, batch_size)
    shape = f"B {batch_size} F {frames}"
    if route == "fma32":
        shape += f", cluster {cluster or 'picked by the launch'}"
    seed = (11, 22)
    with on_route(route):
        out = TX.mega_exec_train_call(meta, args, rate, seed, cluster=cluster)
        gen = torch.Generator().manual_seed(5)
        cots = [torch.randn(o.shape, generator=gen).to(dev, o.dtype)
                for o in out]
        runs = ((f"#5 {kernels[0]}", names[0],
                 lambda: TX.mega_exec_train_call(meta, args, rate, seed,
                                                 cluster=cluster)),
                (f"#6 {kernels[1]} (the call with its weight gradients)",
                 names[1], lambda: TG.mega_exec_bwd_call(
                     meta, args, out, cots, rate, seed, cluster=cluster)))
        for label, lib_name, fn in runs:
            lib = libs[lib_name]
            fn()
            torch.cuda.synchronize()
            lib.stair_clk(None, 1)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(n):
                fn()
            ev1.record()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * NSLOTS)()
            lib.stair_clk(ctypes.cast(buf, P), 0)
            total = buf[KERNEL]
            held = sum(buf[i] for i in SECTIONS)
            shares = ", ".join(f"{name} {buf[i] / total:.3f}"
                               for i, name in SECTIONS.items() if buf[i])
            print(f"[clocks] {route} route, {dtype}, {shape}: {label}: "
                  f"{ev0.elapsed_time(ev1) / n:.3f} ms a call (CUDA events, "
                  f"instrumented); share of the kernel's clocks: {shares}, "
                  f"rest {1 - held / total:.3f}; card {card}", flush=True)
        parts = kernel_ms(runs[1][2], ("mega_bwd", "mega_wgrad"), iters=n)
        print(f"[clocks] {route} route, {dtype}, {shape}: #6 device time a "
              f"call (torch.profiler, walk instrumented): walk "
              f"{parts['mega_bwd']:.3f} ms, weight gradients "
              f"{parts['mega_wgrad']:.3f} ms; card {card}", flush=True)
    del out, cots, args
    torch.cuda.empty_cache()


def main():
    from stair_tpu_torch.utils.device import card_identity, exact_f32

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--routes", default=None,
                    help="comma-separated routes (%s; with --step: general, "
                    "fma32)" % ", ".join(ROUTES))
    ap.add_argument("--step", action="store_true",
                    help="the float32 step kernel (#10) by section")
    ap.add_argument("--frames", type=int, default=64,
                    help="F of #5 and #6 (150: the NMN CLIs' default)")
    ap.add_argument("--batch", type=int, default=128,
                    help="B of #5 and #6 (32: the NMN CLIs' default)")
    ap.add_argument("--clusters", default=None,
                    help="comma-separated cluster sizes of the fma32 route "
                    "(CTAs an example; default: the launch's pick)")
    opts = ap.parse_args()
    routes = (opts.routes or ("general,fma32" if opts.step
                              else ",".join(ROUTES))).split(",")
    if not torch.cuda.is_available():
        raise SystemExit("executor_clocks: no CUDA device")
    if opts.step:
        exact_f32()
        step_clocks(routes, torch.device("cuda", 0),
                    card_identity().splitlines()[0])
        return
    out_dir = os.path.join(os.path.dirname(_build.BUILD_ROOT), "clocks")
    patched_sources(out_dir)
    libs = build(out_dir, sorted({n for r in routes for n in ROUTES[r][1]}))
    dev = torch.device("cuda", 0)
    exact_f32()
    card = card_identity().splitlines()[0]
    clusters = ([int(c) for c in opts.clusters.split(",")]
                if opts.clusters else [None])
    for route in routes:
        for c in (clusters if route == "fma32" else [None]):
            clock_route(route, {n: libs[n] for n in ROUTES[route][1]}, dev,
                        card, opts.frames, opts.batch, cluster=c)


if __name__ == "__main__":
    main()
