"""Section clocks of the BiLSTM's float32 cluster forward
(``csrc/bilstm.cu bilstm_fwd_f32_kernel``, TPU kernels #1 and #2 in
float32) at the program parser's and the float32 NMN's shapes, on one
NVIDIA GPU: the share of a step spent in each of its sections.

    python -m stair_tpu_torch.scripts.bilstm_f32_clocks

It copies ``ops/csrc`` into ``build/bilstm_f32_clocks/`` and patches the
copy: thread 0 of every CTA reads ``clock64()`` at the section edges of
each step (the recurrent product; the gate math with the token and stack
stores; the next step's loads and the CTA barrier; the push of h_t to the
peers; the cluster barrier), keeps the sums in registers and adds them into
a ``__device__`` array when it leaves, with the wh slice's load and the
steps' count. It builds ``bilstm.cu`` alone from the copy and as it is,
binds each in turn in place of the library's entry points and runs the
training forward (with state stacks) five times at each shape on
``lstm.fwd_tile``'s tile, with weights and inputs from a seed. It prints
the kernel's time a call (CUDA events, instrumented and not) and each
section's cycles a step of one CTA and share of the step, with the SM
clock ``nvidia-smi`` reads during the run. A section ends where thread 0
reaches its edge; the barriers make every thread meet there, so the
sections after the product hold the wait for the block's slowest warp.
The repository's sources are not touched.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import lstm as TL
from stair_tpu_torch.scripts.bilstm_fwd_tiles import build_alone, inputs
from stair_tpu_torch.utils.device import card_identity, cuda_time_ms, exact_f32

SECTIONS = ("product", "gates and stores", "loads and CTA barrier", "push",
            "cluster barrier")
#: (name, B, L, D, h): the parser's training batch, the float32 NMN's
#: training encoders
SHAPES = (("parser train", 64, 32, 256, 128),
          ("nmn video train", 128, 64, 1024, 256),
          ("nmn question train", 128, 16, 300, 256))

_KERNEL = "    bilstm_fwd_f32_kernel(const FwdF32Args a) {\n"
#: (anchor inside bilstm_fwd_f32_kernel, text inserted before it); each
#: anchor occurs once in the kernel
_PATCHES = (
    ("  const float* wq = Ws + u * LD;\n",
     "  long long clk[6] = {0, 0, 0, 0, 0, clock64() - t_entry};\n"
     "  int steps = 0;\n"),
    ("    const float* cur = op + (s & 1) * BT * LD;",
     "    long long c0 = clock64();\n    ++steps;\n"),
    ("#pragma unroll\n    for (int i = 0; i < P; ++i) {\n"
     "      const int r = r0 + F32_WARPS * i, b = b0 + r;\n",
     "    long long c1 = clock64();\n    clk[0] += c1 - c0;\n"),
    ("    if (s + 1 == L) break;\n",
     "    long long c2 = clock64();\n    clk[1] += c2 - c1;\n"),
    ("    // Push them to the peers, 16 bytes at a time at the same "
     "offsets.\n",
     "    long long c3 = clock64();\n    clk[2] += c3 - c2;\n"),
    ("    cluster_arrive();\n    cluster_wait();\n  }\n",
     "    long long c4 = clock64();\n    clk[3] += c4 - c3;\n"),
    ("  // No CTA leaves while a peer may still reach its shared memory.\n",
     "  if (threadIdx.x == 0) {\n"
     "    for (int q = 0; q < 6; ++q)\n"
     "      atomicAdd(&g_f32_clk[q], (unsigned long long)clk[q]);\n"
     "    atomicAdd(&g_f32_clk[6], (unsigned long long)steps);\n"
     "    atomicAdd(&g_f32_clk[7], 1ull);\n"
     "  }\n"),
)
#: the cluster barrier's clock, after the wait that ends a step
_AFTER_WAIT = ("    cluster_arrive();\n    cluster_wait();\n  }\n",
               "    cluster_arrive();\n    cluster_wait();\n"
               "    clk[4] += clock64() - c4;\n  }\n")

_GLOBAL = ("__device__ unsigned long long g_f32_clk[8];\n\n"
           "template <int H, int BT>\n__global__ void __cluster_dims__")

_READ = '''
extern "C" void stair_f32_clk(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    cudaMemcpyToSymbol(g_f32_clk, z, sizeof(z));
  } else {
    cudaMemcpyFromSymbol(out, g_f32_clk, 8 * sizeof(unsigned long long));
  }
}
'''


def patched_source(text: str) -> str:
    """``bilstm.cu`` with the section clocks in the float32 forward."""
    start = text.index(_KERNEL)
    end = text.index("// With a != null: launch on a's batch", start)
    body = text[start:end]
    body = body.replace(_KERNEL, _KERNEL + "  const long long t_entry = "
                        "clock64();\n", 1)
    for anchor, insert in _PATCHES:
        if body.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        body = body.replace(anchor, insert + anchor, 1)
    body = body.replace(*_AFTER_WAIT, 1)
    head = text[:start]
    decl = ("template <int H, int BT>\n__global__ void "
            "__cluster_dims__(H / F32_U")
    if head.count(decl) != 1:
        raise RuntimeError("the kernel's declaration moved")
    head = head.replace(decl, _GLOBAL + "(H / F32_U", 1)
    tail = text[end:]
    anchor = "}  // namespace\n"
    if tail.count(anchor) != 1:
        raise RuntimeError("namespace end not found")
    return head + body + tail.replace(anchor, anchor + _READ, 1)


def build(out_dir):
    """Build the patched ``bilstm.cu`` alone; returns the bound CDLL."""
    src = os.path.join(out_dir, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build._CSRC, src)
    path = os.path.join(src, "bilstm.cu")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(patched_source(text))
    so = os.path.join(out_dir, "bilstm_clocks.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", src, "-o", so, path], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    _build.bind_bilstm(lib)
    lib.stair_f32_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.stair_f32_clk.restype = None
    return lib


def sm_clock_mhz() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def main():
    dev = torch.device("cuda")
    exact_f32()
    print(f"card {card_identity()}", flush=True)
    root = os.path.join(_build.BUILD_ROOT, os.pardir, "bilstm_f32_clocks")
    os.makedirs(root, exist_ok=True)
    lib = build(root)
    buf = (ctypes.c_ulonglong * 8)()
    plain, _ = build_alone(os.path.join(root, "plain"))
    for name, B, L, D, h in SHAPES:
        args = inputs(dev, B, L, D, h, B + L, torch.float32)
        _build._lib = plain      # bilstm.cu as the repository has it
        plain_ms = cuda_time_ms(lambda: TL.bilstm_train_call(*args))
        _build._lib = lib
        TL.bilstm_train_call(*args)
        torch.cuda.synchronize()
        lib.stair_f32_clk(buf, 1)
        ms = cuda_time_ms(lambda: TL.bilstm_train_call(*args), iters=5,
                          warmup=0)
        lib.stair_f32_clk(buf, 0)
        clk, steps, ctas = list(buf[:6]), buf[6], buf[7]
        step_total = sum(clk[:5])
        print(json.dumps({
            "shape": name, "B": B, "L": L, "D": D, "h": h,
            "tile": TL.fwd_tile(B, TL._clusters_held(dev, h, "cluster32"),
                                "cluster32"),
            "ms_instrumented": ms, "ms": plain_ms, "ctas": ctas // 5,
            "steps": steps // max(ctas, 1),
            "cycles_a_step": {s: clk[i] / steps
                              for i, s in enumerate(SECTIONS)},
            "share": {s: clk[i] / step_total
                      for i, s in enumerate(SECTIONS)},
            "wh_load_cycles_a_cta": clk[5] / ctas,
            "sm_clock": sm_clock_mhz()}), flush=True)
    _build._lib = None


if __name__ == "__main__":
    main()
