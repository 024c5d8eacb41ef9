"""How far the NMN's scan executor (``executor="step"``) and its megakernel
executor agree on the serving path at full width, over several word-vector
tables, on one NVIDIA GPU.

    python -m stair_tpu_torch.scripts.route_agreement [--tables 10]

For each table (``HashEmbeddings.salt`` = ``""``, ``"#1"``, ``"#2"``, ...)
it builds the bench configuration (``testing.workload.ServingBatches``
defaults: H = 512, video 1024, text 300, F = 64, 172 answers, bf16,
B = 1024, the 128-program pool) and one set of weights for both routes,
runs two batches through each route twice and prints one JSON line per
batch: whether each route gave the same bits twice, the argmax agreement
of the logits, the examples whose Choose step kept another keyword on each
route with the gap between their two cosines
(``testing.workload.choose_flips``), and per register file the elements
outside the executor's bf16 tolerance (atol 3e-2 + rtol 1e-2) with the
worst multiple of it, over all examples and over those that chose alike.
"""

from __future__ import annotations

import argparse
import json

import torch

from stair_tpu_torch.models.nmn import VideoNMN
from stair_tpu_torch.testing import workload as W
from stair_tpu_torch.utils.device import card_identity

FILES = ("regs_vec", "regs_frames", "regs_attn")


def outside(a, b):
    """Elements of ``a`` outside atol 3e-2 + rtol 1e-2 of ``b``, and the
    worst difference as a multiple of that tolerance."""
    diff = (a - b).abs()
    tol = 3e-2 + 1e-2 * b.abs()
    return [int((diff > tol).sum()), float((diff / tol).max())]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", type=int, default=10)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 0])
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(f"card {card_identity()}", flush=True)
    for table in range(args.tables):
        W.HashEmbeddings.salt = f"#{table}" if table else ""
        serving = W.ServingBatches(dev)
        mega = W.build_model(serving.cfg, seed=0, device=dev)
        step = VideoNMN(serving.cfg, mega.param_tree(), device=dev,
                        executor="step")
        for index in args.batches:
            batch = serving.device_batch(serving.host_batch(index))
            runs = [(step(batch), mega(batch)) for _ in range(2)]
            out, ref = runs[1]
            flipped, gap = W.choose_flips(batch["trace"], out["regs_vec"],
                                          ref["regs_vec"])
            line = {
                "table": table, "batch": index,
                "same_bits_twice": all(
                    torch.equal(runs[0][r][k], runs[1][r][k])
                    for r in (0, 1) for k in (*FILES, "logits")),
                "argmax_agreement": (
                    out["logits"].argmax(-1) == ref["logits"].argmax(-1)
                ).float().mean().item(),
                "with_choose": int(torch.isfinite(gap).sum()),
                "flipped": int(flipped.sum()),
                "flipped_gaps": gap[flipped].tolist(),
            }
            for name, rows in (("all", slice(None)), ("alike", ~flipped)):
                line[name] = {k: outside(out[k][rows], ref[k][rows])
                              for k in FILES}
            print(json.dumps(line), flush=True)
    W.HashEmbeddings.salt = ""


if __name__ == "__main__":
    main()
