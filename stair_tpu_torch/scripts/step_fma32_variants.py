"""Time the float32 step kernel (#10) by parts of its design on one NVIDIA
GPU, in turns: the general route (``step_kernel``), the "fma32" route
(``executor_step_fma32_kernel``) as its launch picks the cluster size, and
builds of ``csrc/executor_step.cu`` with that choice fixed: one CTA a tile
(``gemm32`` alone) or its cluster of H / 128 CTAs, each at as many CTAs an
SM as its shared memory allows (two) or at one.

    python -m stair_tpu_torch.scripts.step_fma32_variants [--alone]
        [--shapes opcode,serving32,serving128,serving1024] [--turns 2]

Shapes: ``opcode``, ``chip_smoke.py`` phase 15's float32 forward at F 64
(the all-opcode programs x8, B 216, H 512: 16 launches; its calls recorded
through the model on the CPU, plain versions, then moved to the card);
``servingB``, one float32 serving batch of phase 16's configuration at
batch size B (H 512, F 64, the 128-program pool: 13 launches; recorded
through the model on the card, which needs the whole library): B 32 is the
NMN trainer CLI's default batch, B 128 the eval batch of the train step's
measurements, B 1024 phase 16's. The fixed variants are this file built
alone with the launch's choice patched out (``PATCHES``), in parallel.
``--alone`` builds the route's own variants from that file alone too
(seconds, not the whole library's minutes) and takes ``opcode`` only.

Every variant is first held to the general route on every call (equal bits
in all six outputs and the whole frames file), then each is timed over the
shape's calls (in place: a repeat rewrites the same frames slots) in the
order given and back (``--turns``), back to back between CUDA events
(``ms``: the host's time between launches included, which exceeds a
launch without a live tile) and by CUDA-graph replay (``graph_ms``: the
device's time alone). One JSON line per shape and turn: both per variant,
the plain version's ms, the bound, the cluster size the launch picks and
the live tiles per launch, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess

import torch

from stair_tpu_torch.ops import _build

#: the launch's choice of the cluster size, and the shared memory it asks
_PICK = ("  const int C = cluster > 0 ? cluster : "
         "step32_cluster(B, H, slots);\n")
_SMEM = ("  const size_t smem = step32_smem_bytes(F, H);\n"
         "  cudaError_t e = cudaFuncSetAttribute(\n"
         "      executor_step_fma32_kernel,")
#: more shared memory asked than half an H100 SM holds: one CTA an SM
_ONE_AN_SM = _SMEM.replace("step32_smem_bytes(F, H)", "232448 / 2 + 16")

#: fixed variant -> its replacements in ``csrc/executor_step.cu``
PATCHES = {
    "fma32_c1_2sm": ((_PICK, "  const int C = 1;\n"),),
    "fma32_c1_1sm": ((_PICK, "  const int C = 1;\n"), (_SMEM, _ONE_AN_SM)),
    "fma32_cluster_2sm": ((_PICK, "  const int C = H / G32_BN;\n"),),
    "fma32_cluster_1sm": ((_PICK, "  const int C = H / G32_BN;\n"),
                          (_SMEM, _ONE_AN_SM)),
}
#: every variant: the two routes as built, then the fixed ones
VARIANTS = ("general", "fma32", *PATCHES)


def patched_source(name):
    """``csrc/executor_step.cu`` with variant ``name``'s replacements, each
    anchor found exactly once."""
    with open(os.path.join(_build._CSRC, "executor_step.cu")) as f:
        src = f.read()
    for old, new in PATCHES.get(name, ()):
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor {old!r} found "
                               f"{src.count(old)} times")
        src = src.replace(old, new)
    return src


def start_builds(out_dir, names):
    """Start one ``nvcc`` for each variant in ``names``: ``executor_step.cu``
    built alone, patched as the variant says; returns what ``finish_builds``
    waits for."""
    procs = {}
    for name in names:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        cu, so = (os.path.join(d, f) for f in ("executor_step.cu",
                                              "executor_step.so"))
        with open(cu, "w") as f:
            f.write(patched_source(name))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             _build._CSRC, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def finish_builds(procs):
    """Wait for ``start_builds``' compilers; returns each variant's bound
    CDLL and the compilers' ``-Xptxas -v`` report."""
    libs, log = {}, ""
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(so)
        _build.bind_step(libs[name])
        log += out
    return libs, log


@contextlib.contextmanager
def variant(libs, name):
    """``fused_step`` on the variant ``name`` inside the block."""
    from stair_tpu_torch.ops import executor_step as TE

    route = "general" if name == "general" else "fma32"
    pick, held = TE.step_route, _build._lib
    TE.step_route = lambda *a: route
    _build._lib = libs[name]
    try:
        yield
    finally:
        TE.step_route, _build._lib = pick, held


def record_calls(model, batch):
    """The argument tuples of every ``fused_step`` call of one forward."""
    from stair_tpu_torch.ops import executor_step as TE

    calls, real = [], TE.fused_step

    def record(*args):
        calls.append(tuple(a.clone() for a in args))
        return real(*args)

    TE.fused_step = record
    try:
        with torch.no_grad():
            model(batch)
    finally:
        TE.fused_step = real
    return calls


def opcode_calls(dev, F=64, H=512):
    """Phase 15's float32 forward at F: the all-opcode programs x8 on the
    ``"step"`` executor (weights from seed 3), recorded on the CPU (plain
    versions) and moved to ``dev``."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.testing import workload as W

    cfg = NMNConfig(hidden_size=H, video_size=1024, text_size=300,
                    max_video_length=F, object_types=3, max_steps=16,
                    num_vec=10, num_frames=6, num_attn=8,
                    compute_dtype="float32")
    model = W.build_model(cfg, seed=3, device=torch.device("cpu"),
                          executor="step")
    batch = W.to_device(W.opcode_batch(cfg, W.OPCODE_PROGRAMS * 8, seed=F),
                        torch.device("cpu"))
    return [tuple(a.to(dev) for a in c) for c in record_calls(model, batch)]


def serving_calls(dev, B):
    """One float32 serving batch of phase 16's configuration at batch size
    ``B`` on the ``"step"`` executor (weights from seed 0), recorded on the
    card."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
    from stair_tpu_torch.testing import workload as W

    serving = W.ServingBatches(dev, batch_size=B, question_len=16)
    cfg = NMNConfig(**{**serving.cfg.to_dict(), "compute_dtype": "float32"})
    params = W.build_model(serving.cfg, seed=0, device=dev).param_tree()
    model = VideoNMN(cfg, params, device=dev, executor="step")
    b0 = serving.device_batch(serving.host_batch(0))
    return record_calls(model, b0)


def tiles_of(scal):
    """Per launch: tiles with a product, and the most products a tile does
    (two for a live stage 1, one for a FilterFrame / Temporal projection)."""
    from stair_tpu_torch.ops import executor_step as TE

    e1, e2 = scal[TE.S_E1].long(), scal[TE.S_E2].long()
    stage1 = (e1 >= 0) & (e1 != TE.E1_NULL) & (e1 < TE.NUM_E1)
    proj = ((e2 == TE.E2_FF) & stage1) | (e2 == TE.E2_TEMPORAL)
    n = 2 * stage1.long() + proj.long()
    return {"live": int((n > 0).sum()), "most_products": int(n.max()),
            "tiles_with_most": int((n == n.max()).sum())}


def check_variants(libs, calls, names):
    """Hold each variant to the general route on every call, equal bits."""
    from stair_tpu_torch.ops import executor_step as TE

    for args in calls:
        with variant(libs, "general"):
            want = TE.fused_step(*(a.clone() for a in args))
        for name in names:
            with variant(libs, name):
                got = TE.fused_step(*(a.clone() for a in args))
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise SystemExit(f"{name} differs from the general route")


def main():
    from chip_smoke import add_bounds, step_bound
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.utils.device import (
        card_identity, cuda_time_ms, exact_f32, graph_ms,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alone", action="store_true",
                    help="build csrc/executor_step.cu alone (opcode only)")
    ap.add_argument("--shapes", default="opcode,serving32,serving128,"
                    "serving1024")
    ap.add_argument("--turns", type=int, default=2)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_fma32_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    exact_f32()
    card = card_identity().splitlines()[0]
    out_dir = os.path.join(_build.BUILD_ROOT, os.pardir,
                           "step_fma32_variants")
    procs = start_builds(out_dir, [*(["base"] if opts.alone else []),
                                   *PATCHES])
    base = None if opts.alone else _build.build()
    libs, log = finish_builds(procs)
    if opts.alone:
        base = libs.pop("base")
    else:
        log += _build.BUILD_INFO["log"]
    libs.update(general=base, fma32=base)
    _build._lib = base
    for r in _build.ptxas_report(log):
        if r["kernel"].startswith(("executor_step", "step_kernel")):
            print(json.dumps({"ptxas": r}), flush=True)
    shapes = opts.shapes.split(",")
    if opts.alone and shapes != ["opcode"]:
        shapes = ["opcode"]
    names = list(VARIANTS)
    for shape in shapes:
        calls = (opcode_calls(dev) if shape == "opcode" else
                 serving_calls(dev, int(shape[len("serving"):])))
        check_variants(libs, calls, names[1:])
        B, _, F, H = calls[0][2].shape
        print(json.dumps({
            "shape": shape, "launches": len(calls), "B": B,
            "cluster_picked": base.stair_executor_step_fma32_cluster(B, F, H),
            "tiles": [tiles_of(c[0]) for c in calls],
            "equal_bits_to_general": names[1:]}), flush=True)
        bnd = add_bounds(*[step_bound(a, torch.float32) for a in calls])
        plain = cuda_time_ms(
            lambda: [TE.fused_step_reference(*a) for a in calls], iters=2,
            warmup=1)
        for turn in range(opts.turns):
            order = names if turn % 2 == 0 else names[::-1]
            ms, graph = {}, {}
            for name in order:
                with variant(libs, name):
                    def run():
                        return [TE.fused_step(*a) for a in calls]

                    ms[name] = cuda_time_ms(run, iters=5)
                    graph[name] = graph_ms(run, iters=2)
            print(json.dumps({"shape": shape, "turn": turn, "ms": ms,
                              "graph_ms": graph, "plain_ms": plain, **bnd,
                              "card": card}), flush=True)
        del calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
