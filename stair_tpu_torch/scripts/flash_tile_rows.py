"""Time the attention forward's tensor-core kernel (``csrc/flash_attn.cu
flash_fwd_mma``, TPU kernel #7) at two query-tile shapes on one NVIDIA GPU:
the source's own (64 rows, 4 warps, two blocks per SM) and 128 rows with 8
warps (one block per SM, K and V read half as often).

    python -m stair_tpu_torch.scripts.flash_tile_rows

Both libraries are built from ``csrc/flash_attn.cu`` with the port's nvcc
flags; the 128-row one from a copy whose three tile constants are
rewritten, under ``build/flash_tile_rows/``. At the shapes of this repo's
paths (B 4, H 32, D 128 at L 640 and at the prefill's L 512; the SFT
step's B 8 x 512 with lse; bf16, causal, ragged ``valid_len``) it checks
both against ``reference_attention`` (bf16 within 2e-2) and prints one
JSON line per shape and round with each tile shape's time (CUDA events,
mean of 50 launches), in turns.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import attention as TA
from stair_tpu_torch.utils.device import card_identity, cuda_time_ms

#: the source's tile constants and their 128-row replacements
ROWS_128 = (
    ("constexpr int MQ = 64;", "constexpr int MQ = 128;"),
    ("constexpr int MTHREADS = 128;", "constexpr int MTHREADS = 256;"),
    ("__launch_bounds__(MTHREADS, 2)", "__launch_bounds__(MTHREADS, 1)"),
)

#: name -> (B, L, valid_len, with lse)
SHAPES = {
    "B4 L640 valid 531-560": (4, 640, [531, 560, 548, 537], False),
    "B4 L512 valid 420-429 (prefill)": (4, 512, [421, 429, 429, 420], False),
    "B8 L512 with lse (SFT step)": (
        8, 512, [512, 386, 442, 494, 466, 464, 441, 417], True),
}


def build_both(out_dir):
    """Compile the source as it is and the 128-row copy; returns
    {tile rows: CDLL}."""
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build._CSRC, "flash_attn.cu")
    with open(src) as f:
        text = f.read()
    for old, new in ROWS_128:
        if old not in text:
            raise RuntimeError(f"flash_attn.cu no longer has {old!r}")
        text = text.replace(old, new)
    wide = os.path.join(out_dir, "flash_attn_128.cu")
    with open(wide, "w") as f:
        f.write(text)
    libs = {}
    for rows, path in ((64, src), (128, wide)):
        so = os.path.join(out_dir, f"flash_{rows}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                        _build._CSRC, "-o", so, path], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(so)
        lib.stair_flash_attn_fwd.restype = ctypes.c_int
        lib.stair_flash_attn_fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        libs[rows] = lib
    return libs


def launch(lib, q, k, v, prefix_len, valid_len, with_lse):
    """One causal launch of ``lib``'s kernel with ``_launch``'s argument
    block; returns (out, lse)."""
    B, H, L, D = q.shape
    dev = q.device
    out = torch.empty(B, L, H, D, dtype=q.dtype, device=dev).transpose(1, 2)
    lse = (torch.empty(B, H, L, dtype=torch.float32, device=dev)
           if with_lse else None)
    args = TA._Args(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, prefix_len.data_ptr(),
        valid_len.data_ptr(), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], B, H, k.shape[1], L, L, D, 1, 1,
        1, 1.0 / math.sqrt(D))
    _build.check(lib.stair_flash_attn_fwd(ctypes.byref(args),
                                          _build.stream_ptr(dev)),
                 "flash_attn")
    return out, lse


def main():
    dev = torch.device("cuda")
    print(f"card {card_identity()}", flush=True)
    libs = build_both(os.path.join(_build.BUILD_ROOT, os.pardir,
                                   "flash_tile_rows"))
    gen = torch.Generator(device=dev).manual_seed(9)
    for name, (B, L, valid, with_lse) in SHAPES.items():
        q, k, v = (torch.randn(B, L, 32, 128, generator=gen, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        pl = torch.zeros(B, dtype=torch.int32, device=dev)
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        ref, _ = TA.reference_attention(q, k, v, pl, vl)
        for rows, lib in libs.items():
            out, _ = launch(lib, q, k, v, pl, vl, with_lse)
            err = float((out.float() - ref.float()).abs().max())
            if err > 2e-2:
                raise AssertionError(f"{rows}-row tiles at {name}: {err}")
        for turn in range(2):
            order = (64, 128) if turn == 0 else (128, 64)
            ms = {rows: cuda_time_ms(
                lambda lib=libs[rows]: launch(lib, q, k, v, pl, vl, with_lse),
                iters=50, warmup=5) for rows in order}
            print(json.dumps({"shape": name, "turn": turn,
                              "ms_64_rows": ms[64], "ms_128_rows": ms[128]}),
                  flush=True)


if __name__ == "__main__":
    main()
