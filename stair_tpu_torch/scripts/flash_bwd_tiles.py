"""Pick the tiles of the attention backward's tensor-core kernels
(``csrc/flash_attn_bwd.cu``, TPU kernels #8 and #9) on one NVIDIA GPU.

    python -m stair_tpu_torch.scripts.flash_bwd_tiles [--turns 2]
        [--dtype bfloat16|float32]

bf16 (the default): each candidate tile of ``flash_bwd_dkv_mma`` (key rows
per block, query rows per ring step, warps, blocks per SM) is built from a
copy of ``csrc/flash_attn_bwd.cu`` alone whose ``DKV_*`` constants are
rewritten (the same tile at head_dim 64 and 128). float32: each candidate
rewrites the ``DQ32_*`` and ``DKV32_*`` constants of ``flash_bwd_dq_mma32``
and ``flash_bwd_dkv_mma32`` (tiles and blocks per SM), per head_dim. The builds go under
``build/flash_bwd_tiles/`` with the port's nvcc flags, in parallel; per
build it prints ptxas' registers and spill bytes of the dtype's
tensor-core kernels. At the dtype's shapes (bf16, causal, ragged
``valid_len``: the SFT step's B 8 x 512 with 32 heads of 128; B 4 x 640
with 32 heads of 128; the prefix-LM trainer's B 32 x 214 with 8 heads of 64
and a video prefix. float32: the LLM trainer CLIs' three backward shapes
at full lengths and B 4 x 640, D 128 with ragged ``valid_len``, as
``chip_smoke.py`` phase 11 times them) it checks every build against
``flash_backward_reference`` (each gradient within 2e-2 of its largest
value in bf16, 2e-4 in float32) and times, in turns, the dK/dV kernel, the
dQ kernel and the whole backward (both launches) of each build by
CUDA-graph replay; one JSON line per shape and turn (``--turns 0``: build
and check only). The last line names the fastest candidate without spills
per head_dim (bf16: its mean dK/dV time at the SFT shape for 128, the
prefix-LM shape for 64; float32: per kernel, its mean time over the D 64
shapes and at the D 128 shape).
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
from stair_tpu_torch.utils.device import card_identity, exact_f32, graph_ms

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


def _f32(d, dq, dkv):
    """The float32 constants of head_dim ``d``: dQ (key rows, blocks per
    SM), dK/dV (warps, query rows, blocks per SM)."""
    return {f"DQ32_KV_D{d}": dq[0], f"DQ32_MINB_D{d}": dq[1],
            f"DKV32_WARPS_D{d}": dkv[0], f"DKV32_MQ_D{d}": dkv[1],
            f"DKV32_MINB_D{d}": dkv[2]}


#: head_dim 128's tiles in the candidates that vary D 64's
_D128 = _f32(128, (16, 2), (4, 16, 2))

#: float32 candidates: name -> the ``DQ32_*`` / ``DKV32_*`` constants a
#: build sets (every operand split into TF32 as it is read)
CANDIDATES32 = {
    "kv32 3/SM mq32 3/SM": {**_f32(64, (32, 3), (4, 32, 3)), **_D128},
    "kv32 mq32": {**_f32(64, (32, 2), (4, 32, 2)), **_D128},
    "kv16 3/SM mq16 3/SM": {**_f32(64, (16, 3), (4, 16, 3)), **_D128},
    "kv64 mq32 3/SM": {**_f32(64, (64, 2), (4, 32, 3)), **_D128},
    "kv32 mq16": {**_f32(64, (32, 2), (4, 16, 2)), **_D128},
    "kv64 mq64 | d128 kv32 mq32 1/SM": {
        **_f32(64, (64, 2), (4, 64, 2)),
        **_f32(128, (32, 1), (4, 32, 1))},
}

#: float32 shapes: name -> (B, L, H, D, prefix_len, valid_len or None for
#: L), ``chip_smoke.F32_ATTENTION_SHAPES``
SHAPES32 = {
    "with_video_lm reply": (32, 214, 8, 64, 0, None),
    "with_video_lm video": (32, 214, 8, 64, 150, None),
    "videochat_train SFT": (8, 512, 4, 64, 0, None),
    "L640 D128": (4, 640, 32, 128, 0, (531, 560, 548, 537)),
}


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


def source_with(consts):
    """``flash_attn_bwd.cu`` with its ``constexpr int`` constants named in
    ``consts`` set to the values given."""
    with open(os.path.join(_build._CSRC, "flash_attn_bwd.cu")) as f:
        text = f.read()
    have = _build.header_ints("flash_attn_bwd.cu")
    for key, val in consts.items():
        old = f"constexpr int {key} = {have.get(key)};"
        if old not in text:
            raise RuntimeError(f"flash_attn_bwd.cu no longer has {old!r}")
        text = text.replace(old, f"constexpr int {key} = {val};")
    return text


def tile_source(tile):
    """``flash_attn_bwd.cu`` with the bf16 dK/dV tile ``tile`` at both
    head_dims."""
    return source_with({f"DKV_{name}_D{d}": val for d in (64, 128)
                        for name, val in zip(("WARPS", "MQ", "MINB"), tile)})


def build_all(out_dir, sources, kernels):
    """Compile every candidate source (name -> text) in parallel; returns
    {name: (CDLL, ptxas rows of the kernels whose names start with one of
    ``kernels``)}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = os.path.join(out_dir, f"flash_attn_bwd_{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"flash_bwd_{i}.so")
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
                if r["kernel"].startswith(kernels)]
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


def inputs32(B, L, H, D, prefix, valid, seed, dev):
    """float32 q, k, v, dO (strided ``[B, L, H, D]`` views, as the
    decoder's), out and lse of the plain forward, prefix_len, valid_len."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(B, L, H, D, generator=gen, device=dev)
                     .transpose(1, 2) for _ in range(4))
    pl = torch.full((B,), prefix, dtype=torch.int32, device=dev)
    vl = torch.tensor(valid or [L] * B, dtype=torch.int32, device=dev)
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


def mean(xs):
    return sum(xs) / len(xs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_tiles: no CUDA device")
    f32 = opts.dtype == "float32"
    dev = torch.device("cuda", 0)
    exact_f32()
    card = card_identity().splitlines()[0]
    print(f"card {card}", flush=True)
    if f32:
        cands = CANDIDATES32
        sources = {n: source_with(c) for n, c in cands.items()}
        kernels = ("flash_bwd_dq_mma32", "flash_bwd_dkv_mma32")
        shapes = {n: (*dims, seed)
                  for seed, (n, dims) in enumerate(SHAPES32.items())}
        tol = 2e-4
    else:
        cands = CANDIDATES
        sources = {n: tile_source(t) for n, t in cands.items()}
        kernels = ("flash_bwd_dkv_mma",)
        shapes = SHAPES
        tol = 2e-2
    libs = build_all(os.path.join(_build.BUILD_ROOT, os.pardir,
                                  "flash_bwd_tiles"), sources, kernels)
    spills = {}
    for name, (_, rows) in libs.items():
        spills[name] = any(r.get("spill_stores") or r.get("spill_loads")
                           for r in rows)
        info = ({d: TA.mma32_bwd_smem_bytes(d, cands[name])
                 for d in (64, 128)} if f32 else
                {d: smem_bytes(d, cands[name])[1] for d in (64, 128)})
        print(json.dumps({"candidate": name, "tile": cands[name],
                          "smem": info, "ptxas": rows}), flush=True)
    times = {}
    for shape, dims in shapes.items():
        q, k, v, out, lse, dout, pl, vl = (inputs32 if f32 else inputs)(
            *dims, dev)
        D = q.shape[-1]
        scale = D ** -0.5
        want = TA.flash_backward_reference(q, k, v, out, lse, dout, pl, vl,
                                           True, scale)
        args, grads, keep = TA._backward_args(q, k, v, out, lse, dout, pl,
                                              vl, True, scale)
        errs = {}
        for name, (lib, _) in libs.items():
            run(lib, args, dev, "whole")
            torch.cuda.synchronize()
            errs[name] = 0.0
            for g, w in zip(grads, want):
                err = float((g.float() - w.float()).abs().max())
                top = max(float(w.float().abs().max()), 1e-30)
                errs[name] = max(errs[name], err / top)
            if errs[name] > tol:
                raise AssertionError(f"{name} at {shape}: {errs[name]}")
        print(json.dumps({"shape": shape, "max_rel_err": errs,
                          "bound": tol}), flush=True)
        for turn in range(opts.turns):
            order = list(libs) if turn % 2 == 0 else list(libs)[::-1]
            row = {"shape": shape, "turn": turn, "card": card}
            for which in ("dkv", "dq", "whole"):
                row[f"{which}_ms"] = {}
                for name in order:
                    ms = graph_ms(lambda lib=libs[name][0], w=which:
                                  run(lib, args, dev, w))
                    row[f"{which}_ms"][name] = ms
                    times.setdefault((shape, which, name), []).append(ms)
            print(json.dumps(row), flush=True)
        del q, k, v, out, lse, dout, want, args, grads, keep
        torch.cuda.empty_cache()
    if not opts.turns:
        return
    pick = {}
    for d in (64, 128):
        if f32:
            at = [n for n, dims in SHAPES32.items() if dims[3] == d]
            whiches = ("dq", "dkv")
        else:
            at, whiches = [PICK_SHAPE[d]], ("dkv",)
        for which in whiches:
            ok = {n: mean([mean(times[(s, which, n)]) for s in at])
                  for n in libs if not spills[n]}
            pick[f"{which} D{d}"] = min(ok, key=ok.get) if ok else None
    print(json.dumps({"mean_ms": {f"{s} {w}": {n: mean(times[(s, w, n)])
                                               for n in libs}
                                  for s in shapes for w in ("dq", "dkv")},
                      "spills": spills, "pick": pick}), flush=True)


if __name__ == "__main__":
    main()
