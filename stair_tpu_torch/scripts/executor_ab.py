"""Time the NMN executor kernels (#4 eval, #5 training forward, #6
backward) and the NMN paths of several checkouts of this repository in
turns on one NVIDIA GPU, so that two versions are compared on one card
within one run.

    python -m stair_tpu_torch.scripts.executor_ab ROOT [ROOT ...]
        [--turns 2] [--no-phases]

Each ROOT is a checkout (``.`` for this one, or a ``git archive`` of
another commit unpacked under a gitignored directory). The checkouts run
in the order given, then reversed (A B B A for two and ``--turns 2``),
each in a fresh process that imports that checkout's own
``stair_tpu_torch`` and ``chip_smoke.py`` and builds that checkout's kernel
library with its own ``_build.build`` (cached per checkout after its first
turn). It prints one JSON line per round, on the main paths' own inputs
(weights from seed 0):

- ``fwd_ms``: #4, ``mega_exec_call`` on a serving batch of 1024 (H 512,
  F 64, bf16, the 128-program pool), ``fwd_general_ms`` on the general
  route where the checkout has ``mega_exec.fwd_route``, and
  ``fwd_digest``: a SHA-256 of #4's three register files, which two
  checkouts with the same #4 print alike;
- ``train_fwd_ms``: #5, ``mega_exec_train_call`` at the train step's B
  128 (dropout 0.25), ``train_fwd_general_ms`` on the general route where
  the checkout has ``mega_exec.fwd_route``, and ``train_digest`` /
  ``train_f32_digest``: the same hash of #5's files in bf16 (the route the
  checkout picks) and in float32 (the general route in every checkout);
- ``bwd_ms``: #6, one ``mega_exec_bwd_call`` (its two launches and the
  wrapper's allocations), and ``walk_ms`` / ``wgrad_ms``: the device time
  of its walk and weight-gradient kernels (``torch.profiler``), with
  ``bwd_general_ms`` on the general route where the checkout has
  ``mega_grad.bwd_route``; ``bwd_f32_ms``: the same call in float32 (the
  general route in every checkout), on a float32 model's inputs.

Then, unless ``--no-phases``, that checkout's ``chip_smoke.py`` phases 5
(serving) and 8 (the train step), which print q/s, device ms per batch,
ms per step and their kernel entries. Every line names the card.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys

import torch


@contextlib.contextmanager
def forced(module, name, value):
    """``module.name`` returns ``value`` inside the block."""
    pick = getattr(module, name)
    setattr(module, name, lambda *a: value)
    try:
        yield
    finally:
        setattr(module, name, pick)


def digest(tensors):
    """The first 16 hex digits of a SHA-256 over the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def kernel_ms(fn, names, iters=5):
    """Device ms per call of ``fn`` of each kernel whose name holds one of
    ``names`` (``torch.profiler``, after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                out[n] += us / 1e3 / iters
    return out


def train_inputs(cfg, batch, dtype, dev, seed):
    """The executor backward's inputs at the train step's shapes in
    ``dtype`` (a model of that compute dtype from seed 0): ``(meta, args,
    outs, cotangents)``."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.testing import workload as W

    cfg = NMNConfig(**{**cfg.to_dict(), "compute_dtype": dtype})
    model = W.build_model(cfg, seed=0, device=dev)
    dt = model.compute_dtype
    p = tree_map(lambda x: x.detach(), model.param_tree())
    with torch.no_grad():
        v = TL.bilstm_train_call(*TL._prep(
            p["video_encoder"], batch["video"], batch["video_mask"], dt),
            token_dtype=dt)
        q = TL.bilstm_train_call(*TL._prep(
            p["text_encoder"], batch["question"], batch["question_mask"],
            dt), token_dtype=dt)
    mods = tree_map(lambda x: x.to(dt), p["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], v[:2],
        batch["video_mask"].to(dt), q[:2], batch["question_mask"])
    outs = TX.mega_exec_train_call(meta, args, cfg.dropout, seed)
    gen = torch.Generator().manual_seed(5)
    cots = [torch.randn(o.shape, generator=gen).to(dev, o.dtype)
            for o in outs]
    return meta, args, outs, cots


def one(root, tag, phases):
    """Time one checkout (this process imports its modules)."""
    sys.path.insert(0, root)
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import (
        card_identity, cuda_time_ms, exact_f32,
    )

    _build.build()
    dev = torch.device("cuda", 0)
    exact_f32()
    card = card_identity().splitlines()[0]

    # #4 on a serving batch's own inputs (chip_smoke phase 5's)
    serving = W.ServingBatches(dev, batch_size=1024, question_len=16)
    cfg = serving.cfg
    model = W.build_model(cfg, seed=0, device=dev)
    b0 = serving.device_batch(serving.host_batch(0))
    dt = model.compute_dtype
    p = tree_map(lambda x: x.detach(), model.param_tree())
    with torch.no_grad():
        kv = TL.bilstm(*TL._prep(p["video_encoder"], b0["video"],
                                 b0["video_mask"], dt), token_dtype=dt)
        kq = TL.bilstm(*TL._prep(p["text_encoder"], b0["question"],
                                 b0["question_mask"], dt), token_dtype=dt)
    mods = tree_map(lambda x: x.to(dt), p["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), b0["trace"], kv[:2],
        b0["video_mask"].to(dt), kq[:2], b0["question_mask"])
    del kv, kq, serving

    # #5 and #6 on the train step's own inputs (chip_smoke phase 8's)
    base = W.workload_config(hidden_size=512, video_size=1024, text_size=300,
                             max_video_length=64)
    tcfg = NMNConfig(**{**base.to_dict(), "compute_dtype": "bfloat16",
                        "dropout": 0.25})
    batch = W.to_device(W.add_fake_supervision(
        W.make_batch(tcfg, batch_size=128, question_len=16), tcfg), dev)
    seed = (11, 22)
    tmeta, targs, tout, cots = train_inputs(tcfg, batch, "bfloat16", dev,
                                            seed)
    f32 = train_inputs(tcfg, batch, "float32", dev, seed)

    def fwd():
        return TX.mega_exec_call(meta, args)

    def train_fwd():
        return TX.mega_exec_train_call(tmeta, targs, tcfg.dropout, seed)

    def bwd():
        return TG.mega_exec_bwd_call(tmeta, targs, tout, cots, tcfg.dropout,
                                     seed)

    for rnd in range(2):
        row = {"tag": tag, "card": card, "round": rnd,
               "fwd_ms": cuda_time_ms(fwd, iters=5),
               "fwd_digest": digest(fwd()),
               "train_fwd_ms": cuda_time_ms(train_fwd, iters=5),
               "train_digest": digest(train_fwd())}
        if hasattr(TX, "fwd_route"):
            with forced(TX, "fwd_route", "general"):
                row["fwd_general_ms"] = cuda_time_ms(fwd, iters=3)
                row["train_fwd_general_ms"] = cuda_time_ms(train_fwd, iters=3)
        row["train_f32_digest"] = digest(TX.mega_exec_train_call(
            f32[0], f32[1], tcfg.dropout, seed))
        row["bwd_ms"] = cuda_time_ms(bwd, iters=5)
        parts = kernel_ms(bwd, ("mega_bwd", "mega_wgrad"))
        row["walk_ms"] = parts["mega_bwd"]
        row["wgrad_ms"] = parts["mega_wgrad"]
        if hasattr(TG, "bwd_route"):
            with forced(TG, "bwd_route", "general"):
                row["bwd_general_ms"] = cuda_time_ms(bwd, iters=3)
        row["bwd_f32_ms"] = cuda_time_ms(
            lambda: TG.mega_exec_bwd_call(*f32, tcfg.dropout, seed), iters=3)
        print(json.dumps(row), flush=True)
    del args, targs, tout, cots, model, f32
    torch.cuda.empty_cache()

    if phases:
        import chip_smoke

        entries = chip_smoke.phase_slice(dev, card)
        entries += chip_smoke.phase_train(dev, card)
        print(json.dumps({"tag": tag, "entries": entries}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--no-phases", action="store_true",
                    help="time the kernels only, not phases 5 and 8")
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "TAG"),
                    help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.one:
        one(*opts.one, phases=not opts.no_phases)
        return
    # imported here, not at the top: a --one process imports the
    # stair_tpu_torch of the checkout it times
    from stair_tpu_torch.scripts.attention_bwd_ab import turn_order

    roots = [os.path.abspath(r) for r in opts.roots]
    for root in turn_order(roots, opts.turns):
        tag = os.path.relpath(root)
        print(f"== {tag}", flush=True)
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root, tag]
        if opts.no_phases:
            cmd.append("--no-phases")
        rc = subprocess.run(cmd, cwd=root).returncode
        if rc:
            raise SystemExit(f"{tag}: exit {rc}")


if __name__ == "__main__":
    main()
