"""The "fma32" executor kernels' cluster mode against one CTA an example, on
one NVIDIA GPU: #4 (``mega_exec_kernel<float, true>``, eval), #5 (the same
kernel with dropout) and #6's walk (``mega_bwd_kernel<float, true>``) at
the NMN CLIs' widths (H 512, F 150, float32; ``train/args.py``), on every
cluster size the route takes (1, 2 and H / 128 = 4) at each batch.

    python -m stair_tpu_torch.scripts.fma32_clusters [--batches 32,64,128]
        [--frames 150]

Inputs: ``scripts/executor_ab.py train_inputs`` at those widths (weights
from seed 0, dropout 0.25, the seeded batch of ``testing/workload.py``).
For each batch it prints, as one JSON line, the clusters of each size that
fit the card at once (``mega_exec.fma32_fit``, forward and walk), the size
the launch picks (``fma32_launch_cluster``; it fails unless that is
``fma32_cluster`` over those fits), and for each size each kernel's time by CUDA-graph replay (``utils.device.graph_ms``), with #6's
weight gradients once; it fails unless every size gives the one-CTA
route's bits (#4 and #5 files; the walk's data cotangents and, through the
weight-gradient launch, every weight gradient) and unless a launch at the
picked size counts under ``_build.CLUSTERS``. Every line names the card.
"""

from __future__ import annotations

import argparse
import json

import torch


def cluster_rows(frames, batches):
    """One JSON-ready row per batch (see the module docstring)."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.scripts.executor_ab import train_inputs
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import card_identity, graph_ms

    dev = torch.device("cuda", 0)
    card = card_identity().splitlines()[0]
    H = 512
    wide = W.workload_config(hidden_size=H, video_size=2048, text_size=300,
                             max_video_length=frames)
    cfg = NMNConfig(**{**wide.to_dict(), "compute_dtype": "float32",
                       "dropout": 0.25})
    seed = (11, 22)
    most = H // TX._TILES["G32_BN"]
    sizes = sorted({1, 2, most})
    rows = []
    for B in batches:
        batch = W.to_device(W.add_fake_supervision(
            W.make_batch(cfg, batch_size=B, question_len=16), cfg), dev)
        meta, args, _, cots = train_inputs(cfg, batch, "float32", dev, seed)
        drop = TX.dropout_params(cfg.dropout, seed)
        row = {"card": card, "B": B, "F": frames, "H": H,
               "fit_fwd": {c: TX.fma32_fit(c) for c in sizes},
               "fit_walk": {c: TX.fma32_fit(c, frames, H) for c in sizes},
               "pick_fwd": TX.fma32_launch_cluster(B, H),
               "pick_walk": TX.fma32_launch_cluster(B, H, frames)}
        for k in ("fwd", "walk"):
            fit = row[f"fit_{k}"]
            mirror = TX.fma32_cluster(B, H, fit[1], fit[2] if most > 2 else 0,
                                      fit[most] if most > 1 else 0)
            if row[f"pick_{k}"] != mirror:
                raise SystemExit(f"B {B}: the {k} launch picks "
                                 f"{row[f'pick_{k}']}, fma32_cluster {mirror}")
        want = {}
        for c in sizes:
            f4 = TX.mega_exec_call(meta, args, cluster=c)
            f5 = TX.mega_exec_train_call(meta, args, cfg.dropout, seed,
                                         cluster=c)
            walk, wgrad, result = TG.bwd_launches(meta, args, f5, cots, drop,
                                                  cluster=c)
            walk()
            wgrad()
            got = (*f4, *f5, *result())
            if c == 1:
                want = got
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            if not same:
                raise SystemExit(f"B {B}: cluster {c} differs from one CTA "
                                 "an example")
            row[f"c{c}"] = {
                "fwd_ms": graph_ms(lambda: TX.mega_exec_call(
                    meta, args, cluster=c), 5),
                "train_fwd_ms": graph_ms(lambda: TX.mega_exec_train_call(
                    meta, args, cfg.dropout, seed, cluster=c), 5),
                "walk_ms": graph_ms(walk, 5)}
            if c == 1:
                row["wgrad_ms"] = graph_ms(wgrad, 5)
        _build.reset_launches()
        TX.mega_exec_call(meta, args)
        TX.mega_exec_train_call(meta, args, cfg.dropout, seed)
        TG.mega_exec_bwd_call(meta, args, f5, cots, cfg.dropout, seed)
        seen = {k: dict(v) for k, v in _build.CLUSTERS.items()}
        expect = {"mega_exec_fma32": {row["pick_fwd"]: 1},
                  "mega_exec_train_fma32": {row["pick_fwd"]: 1},
                  "mega_exec_bwd_fma32": {row["pick_walk"]: 1}}
        if seen != expect:
            raise SystemExit(f"B {B}: cluster launches {seen}, want {expect}")
        row["same_bits"] = True
        rows.append(row)
        print(json.dumps(row), flush=True)
        del meta, args, cots, f4, f5, got, want, walk, wgrad, result
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="32,64,128")
    ap.add_argument("--frames", type=int, default=150)
    opts = ap.parse_args()
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.utils.device import exact_f32

    _build.build()
    exact_f32()
    cluster_rows(opts.frames, [int(b) for b in opts.batches.split(",")])


if __name__ == "__main__":
    main()
