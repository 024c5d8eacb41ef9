"""Section clocks of the executor's tensor-core kernels at the train step's
shapes, on one NVIDIA GPU: the share of #5 (``mega_exec_tc_kernel<true>``)
and of #6's walk (``mega_bwd_tc_kernel``) spent in each product helper.

    python -m stair_tpu_torch.scripts.executor_clocks

It copies ``ops/csrc`` into ``build/clocks/`` and patches the copy: each
block's thread 0 reads ``clock64()`` on entry to and return from
``fwd_gemm``, ``walk_gemm``, ``vecmat_tc``, the walk's gradient product
(``grad_tc``) and the two kernels, and adds the difference into a
``__device__`` array. It builds ``mega_exec.cu`` and ``mega_grad_tc.cu``
alone from the copy, binds them in place of the library's entry points
and runs #5, then #6 (walk and weight gradients), five times each on the
inputs of ``scripts/bench_train_step.py``'s configuration (weights from
seed 0, the BiLSTM's plain version for the token rows). It prints each
kernel's time a call (CUDA events, instrumented) and each section's share
of the kernel's clocks, summed over blocks. The helpers end in a barrier,
so a section is the block's time in it. The repository's sources are not
touched.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import types

import torch

from stair_tpu_torch.ops import _build

SECTIONS = ("fwd_gemm", "walk_gemm", "vecmat_tc", "grad products", "kernel")

_CLK = '''__device__ unsigned long long g_clk[8];
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
'''

_READ = '''
extern "C" void stair_clk(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    cudaMemcpyToSymbol(stair::mega::g_clk, z, sizeof(z));
  } else {
    cudaMemcpyFromSymbol(out, stair::mega::g_clk,
                         8 * sizeof(unsigned long long));
  }
}
'''

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
    ("mega_grad_tc.cu", "                        float* scratch, Epi epi) {\n",
     "  Clk clk(3);\n"),
    ("mega_grad_tc.cu",
     "    mega_bwd_tc_kernel(const BArgs<__nv_bfloat16> a) {\n",
     "  Clk clk(4);\n"),
    ("mega_exec.cu",
     "  extern __shared__ __align__(16) unsigned char tc_smem[];\n",
     "  Clk clk(4);\n"),
)


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
    for name in ("mega_exec.cu", "mega_grad_tc.cu"):
        with open(os.path.join(out_dir, name), "a") as f:
            f.write(_READ)


def build(out_dir):
    """Build the two patched sources alone; returns {name: CDLL}."""
    nvcc = _build._nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", out_dir, "-o",
         os.path.join(out_dir, n + ".so"), os.path.join(out_dir, n + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in ("mega_exec", "mega_grad_tc")}
    for n, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc {n}.cu failed:\n{log}")
    return {n: ctypes.CDLL(os.path.join(out_dir, n + ".so")) for n in procs}


def main():
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import card_identity, exact_f32

    if not torch.cuda.is_available():
        raise SystemExit("executor_clocks: no CUDA device")
    out_dir = os.path.join(os.path.dirname(_build.BUILD_ROOT), "clocks")
    patched_sources(out_dir)
    libs = build(out_dir)
    P, I, U, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    drop = [I, I, I, U, Fl]
    fwd = libs["mega_exec"].stair_mega_exec_fwd_tc_train
    fwd.restype = I
    fwd.argtypes = [P, I, P, P, P, P] + [I] * 9 + drop + [P]
    walk = libs["mega_grad_tc"].stair_mega_exec_bwd_tc
    walk.restype = I
    walk.argtypes = [P, I, P] + [I] * 9 + drop + [P]
    wgrad = libs["mega_grad_tc"].stair_mega_exec_wgrad_tc
    wgrad.restype = I
    wgrad.argtypes = [P, I, I, I, I, I, P]
    for lib in libs.values():
        lib.stair_clk.argtypes = [P, I]
    _build._lib = types.SimpleNamespace(
        stair_mega_exec_fwd_tc_train=fwd, stair_mega_exec_bwd_tc=walk,
        stair_mega_exec_wgrad_tc=wgrad)

    dev = torch.device("cuda", 0)
    exact_f32()
    card = card_identity().splitlines()[0]
    base = W.workload_config(hidden_size=512, video_size=1024,
                             text_size=300, max_video_length=64)
    cfg = NMNConfig(**{**base.to_dict(), "compute_dtype": "bfloat16",
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
    seed = (11, 22)
    out = TX.mega_exec_train_call(meta, args, cfg.dropout, seed)
    gen = torch.Generator().manual_seed(5)
    cots = [torch.randn(o.shape, generator=gen).to(dev, o.dtype)
            for o in out]
    runs = (("#5 mega_exec_tc_kernel<true>", "mega_exec",
             lambda: TX.mega_exec_train_call(meta, args, cfg.dropout, seed)),
            ("#6 mega_bwd_tc_kernel (the call with its weight gradients)",
             "mega_grad_tc",
             lambda: TG.mega_exec_bwd_call(meta, args, out, cots,
                                           cfg.dropout, seed)))
    n = 5
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
        buf = (ctypes.c_ulonglong * 8)()
        lib.stair_clk(ctypes.cast(buf, P), 0)
        total = buf[4]
        shares = ", ".join(f"{SECTIONS[i]} {buf[i] / total:.3f}"
                           for i in range(4) if buf[i])
        print(f"[clocks] {label}: {ev0.elapsed_time(ev1) / n:.3f} ms a call "
              f"(CUDA events, instrumented); share of the kernel's clocks: "
              f"{shares}; card {card}", flush=True)


if __name__ == "__main__":
    main()
