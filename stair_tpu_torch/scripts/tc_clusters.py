"""The bf16 tensor-core executor kernels' row-slice mode at each cluster
size, on one NVIDIA GPU: #4 (``mega_exec_tc_kernel<false, true>``, eval),
#5 (``<true, true>``, with dropout) and #6's walk (``mega_bwd_tc_kernel``
on the forward's cluster) at the NMN CLIs' widths (H 512, F 150, bf16
through their ``--config-filename``; ``train/args.py``), every slice of an
example on 1, 2, 3 or 4 CTAs of a thread-block cluster, at each batch.

    python -m stair_tpu_torch.scripts.tc_clusters [--batches 32,64,128]
        [--frames 150] [--sizes 1,2,3,4]

Inputs: ``scripts/executor_ab.py train_inputs`` at those widths (weights
from seed 0, dropout 0.25, the seeded batch of ``testing/workload.py``).
For each batch it prints, as one JSON line, the card's CTA slots and the
size the launch picks (``mega_exec.tc_launch_cluster``; it fails unless
that is ``tc_cluster`` over those slots, forward and walk) and for each
size each kernel's time by CUDA-graph replay (``utils.device.graph_ms``),
with #6's weight gradients once; it fails unless every size gives the first size's bits (#4 and #5
files; the walk's data cotangents and, through the weight-gradient launch,
every weight gradient) and unless the launches at the picked size count
under ``_build.CLUSTERS``. Every line names the card.
"""

from __future__ import annotations

import argparse
import json

import torch


def cluster_rows(frames, batches, sizes):
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
    cfg = NMNConfig(**{**wide.to_dict(), "compute_dtype": "bfloat16",
                       "dropout": 0.25})
    seed = (11, 22)
    rows = []
    for B in batches:
        batch = W.to_device(W.add_fake_supervision(
            W.make_batch(cfg, batch_size=B, question_len=16), cfg), dev)
        meta, args, _, cots = train_inputs(cfg, batch, "bfloat16", dev, seed)
        drop = TX.dropout_params(cfg.dropout, seed)
        slots = TX.tc_slots(frames, H, meta[8])
        pick = TX.tc_launch_cluster(B, frames, H, meta[8])
        pick6 = TX.tc_launch_cluster(B, frames, H, walk=True)
        if pick != TX.tc_cluster(B, frames, slots) or pick6 != pick:
            raise SystemExit(f"B {B}: the launches pick {pick} / {pick6}, "
                             f"tc_cluster {TX.tc_cluster(B, frames, slots)}")
        row = {"card": card, "B": B, "F": frames, "H": H, "slots": slots,
               "pick": pick}
        want = None
        for c in sizes:
            f4 = TX.mega_exec_call(meta, args, cluster=c)
            f5 = TX.mega_exec_train_call(meta, args, cfg.dropout, seed,
                                         cluster=c)
            walk, wgrad, result = TG.bwd_launches(meta, args, f5, cots, drop,
                                                  cluster=c)
            walk()
            wgrad()
            got = (*f4, *f5, *result())
            want = got if want is None else want
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise SystemExit(f"B {B}: cluster {c} differs from cluster "
                                 f"{sizes[0]}")
            row[f"c{c}"] = {
                "fwd_ms": graph_ms(lambda: TX.mega_exec_call(
                    meta, args, cluster=c), 5),
                "train_fwd_ms": graph_ms(lambda: TX.mega_exec_train_call(
                    meta, args, cfg.dropout, seed, cluster=c), 5),
                "walk_ms": graph_ms(walk, 5)}
            if c == sizes[0]:
                row["wgrad_ms"] = graph_ms(wgrad, 5)
        _build.reset_launches()
        TX.mega_exec_call(meta, args)
        TX.mega_exec_train_call(meta, args, cfg.dropout, seed)
        TG.mega_exec_bwd_call(meta, args, f5, cots, cfg.dropout, seed)
        seen = {k: dict(_build.CLUSTERS[k]) for k in _build.TC_CLUSTER_KEYS}
        expect = dict.fromkeys(_build.TC_CLUSTER_KEYS, {pick: 1})
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
    ap.add_argument("--sizes", default="1,2,3,4")
    opts = ap.parse_args()
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.utils.device import exact_f32

    _build.build()
    exact_f32()
    cluster_rows(opts.frames, [int(b) for b in opts.batches.split(",")],
                 [int(c) for c in opts.sizes.split(",")])


if __name__ == "__main__":
    main()
