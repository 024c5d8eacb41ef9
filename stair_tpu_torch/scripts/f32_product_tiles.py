"""Time the float32 "fma32" route's product helper ``gemm32`` at three
column tiles against the general route's ``stair::mega::gemm``, on one
NVIDIA GPU.

    python -m stair_tpu_torch.scripts.f32_product_tiles [--reps 20]

At the executor's product shapes at phase 8's widths (F 64, H 512): ``[64,
512] @ [512, 512]`` with B as stored (stage 1, the projections) and
transposed (the walk's ``dY @ W^T``), and ``[64, 512] @ [512, 64]^T``
(SUPF's dots), ``mega_grad.f32_product_check`` runs ``gemm`` in one block
and ``gemm32`` (64 x 64, 64 x 128 and 64 x 256 output tiles) in another,
``--reps`` times each, on operands from a fixed seed. It checks equal bits
and prints each block's ``clock64()`` span a product and its share of one
SM's 128 float32 FMAs a clock (``M K N`` over the span and 128), and
``gemm32``'s speed over ``gemm``, with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

#: (M, K, N, B transposed)
SHAPES = ((64, 512, 512, False), (64, 512, 512, True), (64, 512, 64, True))
TILES = (64, 128, 256)


def main():
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.utils.device import card_identity, exact_f32

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("f32_product_tiles: no CUDA device")
    dev = torch.device("cuda", 0)
    exact_f32()
    _build.build()
    card = card_identity().splitlines()[0]
    gen = torch.Generator().manual_seed(3)
    for M, K, N, nk in SHAPES:
        A = torch.randn(M, K, generator=gen).to(dev)
        W = (torch.randn(*((N, K) if nk else (K, N)), generator=gen)
             / K ** 0.5).to(dev)
        fma = M * K * N
        for bn in TILES:
            TG.f32_product_check(A, W, nk, bn, 1)   # warm: operands in L2
            outg, out32, clk = TG.f32_product_check(A, W, nk, bn, opts.reps)
            torch.cuda.synchronize()
            if not torch.equal(outg, out32):
                raise SystemExit(f"gemm32 (tile 64 x {bn}) != gemm at "
                                 f"[{M}, {K}] @ [{K}, {N}] nk={nk}")
            g, t = (int(c) / opts.reps for c in clk)
            print(f"[f32 product] [{M}, {K}] @ [{K}, {N}]"
                  f"{' (B transposed)' if nk else ''}: gemm {g:.0f} clocks "
                  f"a product ({fma / g / 128:.3f} of 128 FMA a clock), "
                  f"gemm32 64 x {bn} {t:.0f} ({fma / t / 128:.3f}), "
                  f"{g / t:.2f}x; equal bits; card {card}", flush=True)


if __name__ == "__main__":
    main()
