"""Pick the tile of the attention backward's tensor-core dK/dV kernel
(``csrc/flash_attn_bwd.cu flash_bwd_dkv_mma``, TPU kernel #9) on one NVIDIA
GPU.

    python -m stair_tpu_torch.scripts.flash_bwd_tiles [--turns 2]

Each candidate (key rows per block, query rows per ring step, warps,
blocks per SM) is built from a copy of ``csrc/flash_attn_bwd.cu`` alone
whose ``DKV_*`` constants are rewritten (the same tile at head_dim 64 and
128), under ``build/flash_bwd_tiles/``, with the port's nvcc flags; the
builds run in parallel. Per build it prints ptxas' registers and spill
bytes of both tensor-core dK/dV instances. At three shapes of the repo's
paths (bf16, causal, ragged ``valid_len``: the SFT step's B 8 x 512 with
32 heads of 128; B 4 x 640 with 32 heads of 128; the prefix-LM trainer's
B 32 x 214 with 8 heads of 64 and a video prefix) it checks every build
against ``flash_backward_reference`` (each gradient within 2e-2 of its
largest value) and times, in turns, the dK/dV kernel, the dQ kernel and
the whole backward (both launches) of each build by CUDA-graph replay;
one JSON line per shape and turn. The last line names the fastest
candidate without spills per head_dim (its mean dK/dV time at the SFT
shape for 128, the prefix-LM shape for 64).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import attention as TA
from stair_tpu_torch.utils.device import card_identity, graph_ms

#: name -> (warps, query rows per step, blocks per SM); key rows per
#: block = 16 x warps
CANDIDATES = {
    "64x32 4w 2/SM": (4, 32, 2),
    "64x64 4w 2/SM": (4, 64, 2),
    "128x32 8w 1/SM": (8, 32, 1),
    "128x64 8w 1/SM": (8, 64, 1),
}

#: name -> (B, L, H, D, seed); the shape that picks each head_dim's tile
SHAPES = {
    "SFT B8 L512 H32 D128": (8, 512, 32, 128, 0),
    "B4 L640 H32 D128": (4, 640, 32, 128, 1),
    "prefix-LM B32 L214 H8 D64": (32, 214, 8, 64, 2),
}
PICK_SHAPE = {128: "SFT B8 L512 H32 D128", 64: "prefix-LM B32 L214 H8 D64"}


def source_tile(head_dim):
    """The tensor-core dK/dV kernel's tile at ``head_dim`` (64 or 128) as
    ``csrc/flash_attn_bwd.cu`` sets it: (warps, query rows per step, blocks
    per SM)."""
    c = _build.header_ints("flash_attn_bwd.cu")
    return tuple(c[f"DKV_{n}_D{head_dim}"] for n in ("WARPS", "MQ", "MINB"))


def smem_bytes(head_dim, tile):
    """Dynamic shared memory per block of the two tensor-core kernels at
    ``head_dim``, the dK/dV kernel at ``tile``: ``(dq, dkv)``, as
    ``dq_mma_smem`` and ``dkv_mma_smem`` of the source compute it."""
    c = _build.header_ints("flash_attn_bwd.cu")
    c.update(_build.header_ints("flash_common.cuh"))
    warps, mq, _ = tile
    row = 2 * (head_dim + c["PAD"])
    dq = (2 * c["BQ"] + 2 * c["STAGES"] * c["MKV"]) * row + 4 * c["BQ"]
    dkv = ((2 * 16 * warps + 2 * c["STAGES"] * mq) * row
           + 2 * c["STAGES"] * mq * 4)
    return dq, dkv


def tile_source(tile):
    """``flash_attn_bwd.cu`` with the dK/dV tile ``tile`` at both
    head_dims."""
    with open(os.path.join(_build._CSRC, "flash_attn_bwd.cu")) as f:
        text = f.read()
    consts = _build.header_ints("flash_attn_bwd.cu")
    for d in (64, 128):
        for name, val in zip(("WARPS", "MQ", "MINB"), tile):
            key = f"DKV_{name}_D{d}"
            old = f"constexpr int {key} = {consts[key]};"
            if old not in text:
                raise RuntimeError(f"flash_attn_bwd.cu no longer has {old!r}")
            text = text.replace(old, f"constexpr int {key} = {val};")
    return text


def build_all(out_dir):
    """Compile every candidate in parallel; returns {name: (CDLL, ptxas
    rows of its dK/dV tensor-core kernels)}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, tile in CANDIDATES.items():
        tag = "_".join(map(str, tile))
        src = os.path.join(out_dir, f"flash_attn_bwd_{tag}.cu")
        with open(src, "w") as f:
            f.write(tile_source(tile))
        so = os.path.join(out_dir, f"flash_bwd_{tag}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             _build._CSRC, "-o", so, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn in (lib.stair_flash_attn_bwd_dq, lib.stair_flash_attn_bwd_dkv):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        rows = [r for r in _build.ptxas_report(out)
                if r["kernel"].startswith("flash_bwd_dkv_mma")]
        libs[name] = (lib, rows)
    return libs


def inputs(B, L, H, D, seed, dev):
    """bf16 q, k, v (strided ``[B, L, H, D]`` views), out and lse of the
    plain forward, a cotangent, prefix_len and valid_len."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, L, H, D, generator=gen, device=dev)
                     .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    cpu = torch.Generator().manual_seed(seed)
    if D == 64:       # a video prefix of 64-150 frames and 10-64 text tokens
        prefix = torch.randint(64, 151, (B,), generator=cpu)
        valid = (prefix + torch.randint(10, 65, (B,), generator=cpu)).clamp(
            max=L)
    else:
        prefix = torch.zeros(B, dtype=torch.int64)
        valid = torch.randint(3 * L // 4, L + 1, (B,), generator=cpu)
        valid[0] = L
    pl = prefix.to(dev, torch.int32)
    vl = valid.to(dev, torch.int32)
    out, lse = TA.reference_attention(q, k, v, pl, vl)
    return q, k, v, out, lse, dout, pl, vl


def run(lib, args, dev, which):
    stream = _build.stream_ptr(dev)
    if which in ("dq", "whole"):
        _build.check(lib.stair_flash_attn_bwd_dq(ctypes.byref(args), stream),
                     "flash_attn_bwd_dq")
    if which in ("dkv", "whole"):
        _build.check(lib.stair_flash_attn_bwd_dkv(ctypes.byref(args), stream),
                     "flash_attn_bwd_dkv")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_tiles: no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_identity().splitlines()[0]
    print(f"card {card}", flush=True)
    libs = build_all(os.path.join(_build.BUILD_ROOT, os.pardir,
                                  "flash_bwd_tiles"))
    spills = {}
    for name, (_, rows) in libs.items():
        spills[name] = any(r.get("spill_stores") or r.get("spill_loads")
                           for r in rows)
        print(json.dumps({"candidate": name, "tile": CANDIDATES[name],
                          "smem": {d: smem_bytes(d, CANDIDATES[name])[1]
                                   for d in (64, 128)},
                          "ptxas": rows}), flush=True)
    means = {}
    for shape, (B, L, H, D, seed) in SHAPES.items():
        q, k, v, out, lse, dout, pl, vl = inputs(B, L, H, D, seed, dev)
        scale = D ** -0.5
        want = TA.flash_backward_reference(q, k, v, out, lse, dout, pl, vl,
                                           True, scale)
        args, grads, keep = TA._backward_args(q, k, v, out, lse, dout, pl,
                                              vl, True, scale)
        for name, (lib, _) in libs.items():
            run(lib, args, dev, "whole")
            for g, w in zip(grads, want):
                err = float((g.float() - w.float()).abs().max())
                top = max(float(w.float().abs().max()), 1e-30)
                if err > 2e-2 * top:
                    raise AssertionError(f"{name} at {shape}: {err / top}")
        dkv = {}
        for turn in range(opts.turns):
            order = list(libs) if turn % 2 == 0 else list(libs)[::-1]
            row = {"shape": shape, "turn": turn, "card": card}
            for which in ("dkv", "dq", "whole"):
                row[f"{which}_ms"] = {}
                for name in order:
                    ms = graph_ms(lambda lib=libs[name][0], w=which:
                                  run(lib, args, dev, w))
                    row[f"{which}_ms"][name] = ms
                    if which == "dkv":
                        dkv.setdefault(name, []).append(ms)
            print(json.dumps(row), flush=True)
        means[shape] = {n: sum(t) / len(t) for n, t in dkv.items()}
        del q, k, v, out, lse, dout, want, args, grads, keep
        torch.cuda.empty_cache()
    pick = {}
    for d, shape in PICK_SHAPE.items():
        ok = {n: ms for n, ms in means[shape].items() if not spills[n]}
        pick[d] = min(ok, key=ok.get) if ok else None
    print(json.dumps({"mean_dkv_ms": means, "spills": spills,
                      "pick": pick}), flush=True)


if __name__ == "__main__":
    main()
