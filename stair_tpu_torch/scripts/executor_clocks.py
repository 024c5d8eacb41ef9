"""Section clocks of the executor's kernels at the train step's shapes, on
one NVIDIA GPU: the share of #5 (the training forward) and of #6's walk
spent in each product helper, on each route.

    python -m stair_tpu_torch.scripts.executor_clocks [--routes tc,general,fma32]

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
  ``gemm``'s place (SUPF's ``m1`` products stay on ``gemm``).

It copies ``ops/csrc`` into ``build/clocks/`` and patches the copy: each
block's thread 0 reads ``clock64()`` on entry to and return from each
helper and each kernel, and adds the difference into a ``__device__``
array. It builds the route's two sources alone from the copy, binds them in
place of the library's entry points and runs #5, then #6 (walk and weight
gradients), five times each on the inputs of
``scripts/bench_train_step.py``'s configuration (B 128, H 512, F 64,
dropout 0.25; weights from seed 0, the BiLSTM's plain version for the
token rows). It prints each kernel's time a call (CUDA events,
instrumented), each section's share of the kernel's clocks summed over
blocks (``rest``: what no section holds), and the device time of the
walk's and the weight-gradient kernels apart (``torch.profiler``; the
weight-gradient kernels hold no clock). The helpers that end in a barrier
(all but ``vecmat``) give the block's time in them. The repository's
sources are not touched.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
            9: "gemm32 (B as stored)", 10: "gemm32 (B transposed)"}
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
     "int M, int K, int N, __nv_bfloat16* tile, Epi epi) {\n",
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

P, I, U, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_DROP = [I, I, I, U, Fl]
_WALK = [P, I, P] + [I] * 9 + _DROP + [P]
_WGRAD = [P, I, I, I, I, I, P]
#: route -> (compute dtype, sources, {entry point: argtypes}, kernels)
ROUTES = {
    "tc": ("bfloat16", ("mega_exec", "mega_grad_tc"), {
        "stair_mega_exec_fwd_tc_train": [P, I, P, P, P, P] + [I] * 9 + _DROP
        + [P],
        "stair_mega_exec_bwd_tc": _WALK, "stair_mega_exec_wgrad_tc": _WGRAD},
        ("mega_exec_tc_kernel<true>", "mega_bwd_tc_kernel")),
    "general": ("float32", ("mega_exec", "mega_grad"), {
        "stair_mega_exec_fwd": [P, I, P, P, P, P] + [I] * 10 + _DROP + [P],
        "stair_mega_exec_bwd_f32": _WALK,
        "stair_mega_exec_wgrad_f32": _WGRAD},
        ("mega_exec_kernel<float, false>", "mega_bwd_kernel<float, false>")),
    "fma32": ("float32", ("mega_exec", "mega_grad_fma32"), {
        "stair_mega_exec_fwd_fma32": [P, I, P, P, P, P] + [I] * 9 + _DROP
        + [P],
        "stair_mega_exec_bwd_fma32": _WALK,
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


def train_inputs(dtype, dev):
    """#5's and #6's inputs at the train step's shapes in ``dtype``: meta,
    args, dropout rate, seed and the cotangents' generator."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.testing import workload as W

    base = W.workload_config(hidden_size=512, video_size=1024,
                             text_size=300, max_video_length=64)
    cfg = NMNConfig(**{**base.to_dict(), "compute_dtype": dtype,
                       "dropout": 0.25})
    batch = W.to_device(W.make_batch(cfg, batch_size=128, question_len=16),
                        dev)
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


def clock_route(route, libs, dev, card, n=5):
    """Run #5 and #6 on ``route`` with the patched library; print the
    sections' shares and the walk's and weight gradients' device times."""
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
    meta, args, rate = train_inputs(dtype, dev)
    seed = (11, 22)
    with on_route(route):
        out = TX.mega_exec_train_call(meta, args, rate, seed)
        gen = torch.Generator().manual_seed(5)
        cots = [torch.randn(o.shape, generator=gen).to(dev, o.dtype)
                for o in out]
        runs = ((f"#5 {kernels[0]}", names[0],
                 lambda: TX.mega_exec_train_call(meta, args, rate, seed)),
                (f"#6 {kernels[1]} (the call with its weight gradients)",
                 names[1], lambda: TG.mega_exec_bwd_call(
                     meta, args, out, cots, rate, seed)))
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
            print(f"[clocks] {route} route, {dtype}: {label}: "
                  f"{ev0.elapsed_time(ev1) / n:.3f} ms a call (CUDA events, "
                  f"instrumented); share of the kernel's clocks: {shares}, "
                  f"rest {1 - held / total:.3f}; card {card}", flush=True)
        parts = kernel_ms(runs[1][2], ("mega_bwd", "mega_wgrad"), iters=n)
        print(f"[clocks] {route} route, {dtype}: #6 device time a call "
              f"(torch.profiler, walk instrumented): walk "
              f"{parts['mega_bwd']:.3f} ms, weight gradients "
              f"{parts['mega_wgrad']:.3f} ms; card {card}", flush=True)
    del out, cots, args
    torch.cuda.empty_cache()


def main():
    from stair_tpu_torch.utils.device import card_identity, exact_f32

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--routes", default=",".join(ROUTES),
                    help="comma-separated routes (%s)" % ", ".join(ROUTES))
    opts = ap.parse_args()
    routes = opts.routes.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("executor_clocks: no CUDA device")
    out_dir = os.path.join(os.path.dirname(_build.BUILD_ROOT), "clocks")
    patched_sources(out_dir)
    libs = build(out_dir, sorted({n for r in routes for n in ROUTES[r][1]}))
    dev = torch.device("cuda", 0)
    exact_f32()
    card = card_identity().splitlines()[0]
    for route in routes:
        clock_route(route, {n: libs[n] for n in ROUTES[route][1]}, dev, card)


if __name__ == "__main__":
    main()
