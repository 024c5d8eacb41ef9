"""Time the attention backward and the SFT step of several checkouts of
this repository in turns on one NVIDIA GPU, so that two versions are
compared on one card within one run.

    python -m stair_tpu_torch.scripts.attention_bwd_ab ROOT [ROOT ...]
        [--turns 2]

Each ROOT is a checkout (``.`` for this one, or a ``git archive`` of
another commit unpacked under a gitignored directory). The checkouts run
in the order given, then reversed (A B B A for two and ``--turns 2``),
each in a fresh process that imports that checkout's own
``stair_tpu_torch`` and ``chip_smoke.py``. A process builds that
checkout's ``flash_attn.cu`` and ``flash_attn_bwd.cu`` alone (seconds, not
the whole build) and prints one JSON line per shape and round: the dQ
launch, the dK/dV launch (after one dQ launch) and the whole backward
(that checkout's ``_launch_backward``, with whatever it computes around
its two launches) by CUDA-graph replay, beside autograd through
``scaled_dot_product_attention`` with the boolean mask (forward +
backward less forward, a yardstick only), at the SFT step's B 8 x 512 and
at B 4 x 640 (32 heads of 128, bf16, causal, ragged ``valid_len``); then
that checkout's ``chip_smoke.py`` phase 12 (the full-width SFT step with
and without ``remat='full'``, and its kernel entries).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: (B, L, valid_len) of the two shapes
SHAPES = ((8, 512, [512, 386, 442, 494, 466, 464, 441, 417]),
          (4, 640, [531, 560, 548, 537]))


def turn_order(roots, turns):
    """The checkouts in the order they run: as given, then reversed, and so
    on for ``turns`` rounds."""
    order = []
    for turn in range(turns):
        order += list(roots) if turn % 2 == 0 else list(roots)[::-1]
    return order


def one(root, tag):
    """Time one checkout (this process imports its modules)."""
    import ctypes

    sys.path.insert(0, root)
    import torch

    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.utils.device import (
        card_identity, cuda_time_ms, exact_f32,
    )

    def graph_ms(fn, iters=20):
        # as utils.device.graph_ms, which an older checkout may lack
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
        return cuda_time_ms(graph.replay, iters=5, warmup=2) / iters

    out_dir = os.path.join(_build.BUILD_ROOT, os.pardir, "attention_bwd_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"attention_{os.getpid()}.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", _build._CSRC,
         "-o", so] + [os.path.join(_build._CSRC, f) for f in
                      ("flash_attn.cu", "flash_attn_bwd.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    for fn in (lib.stair_flash_attn_fwd, lib.stair_flash_attn_bwd_dq,
               lib.stair_flash_attn_bwd_dkv):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _build._lib = lib

    dev = torch.device("cuda", 0)
    exact_f32()
    card = card_identity().splitlines()[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, L, valid in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(5)
        q, k, v, dout = (torch.randn(B, L, 32, 128, generator=gen, device=dev)
                         .to(torch.bfloat16).transpose(1, 2)
                         for _ in range(4))
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        scale = 128 ** -0.5
        o, lse = TA.flash_attention(q, k, v, zeros, vl, return_lse=True)
        args, _, keep = TA._backward_args(q, k, v, o, lse, dout, zeros, vl,
                                          True, scale)
        TA._launch_dq(args, dev)
        mask = TA.attention_mask(zeros, vl, L, L)[:, None]

        def library():
            a, b, c = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa(a, b, c, attn_mask=mask).backward(dout)

        def library_forward():
            with torch.no_grad():
                sdpa(q, k, v, attn_mask=mask)

        for rnd in range(2):
            print(json.dumps({
                "tag": tag, "card": card, "B": B, "L": L, "round": rnd,
                "dq_ms": graph_ms(lambda: TA._launch_dq(args, dev)),
                "dkv_ms": graph_ms(lambda: TA._launch_dkv(args, dev)),
                "whole_ms": graph_ms(lambda: TA._launch_backward(
                    q, k, v, o, lse, dout, zeros, vl, True, scale)),
                "sdpa_bwd_ms": graph_ms(library) - graph_ms(library_forward),
            }), flush=True)
        del q, k, v, dout, o, lse, args, keep
        torch.cuda.empty_cache()

    import chip_smoke
    from stair_tpu_torch.testing import videochat as VW

    model = VW.build_model(dev)
    entries = chip_smoke.phase_sft(dev, card, model)
    print(json.dumps({"tag": tag, "entries": entries}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "TAG"),
                    help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.one:
        one(*opts.one)
        return
    roots = [os.path.abspath(r) for r in opts.roots]
    for root in turn_order(roots, opts.turns):
        tag = os.path.relpath(root)
        print(f"== {tag}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root, tag], cwd=root).returncode
        if rc:
            raise SystemExit(f"{tag}: exit {rc}")


if __name__ == "__main__":
    main()
