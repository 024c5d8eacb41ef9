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
  checkouts with the same #4 print alike; ``fwd_f32_ms`` and
  ``fwd_f32_digest``: #4 in float32 on the same batch (the float32
  encoders and weights) on the route the checkout picks, with
  ``fwd_f32_general_ms`` on the general route;
- ``train_fwd_ms``: #5, ``mega_exec_train_call`` at the train step's B
  128 (dropout 0.25), ``train_fwd_general_ms`` on the general route where
  the checkout has ``mega_exec.fwd_route``, and ``train_digest`` /
  ``train_f32_digest``: the same hash of #5's files in bf16 and in float32,
  each on the route the checkout picks (float32: the "fma32" route where
  the checkout has it, the general route before; the two give equal bits,
  so the digest stays), with ``train_f32_ms``: #5 in float32 on that route;
- ``bwd_ms``: #6, one ``mega_exec_bwd_call`` (its two launches and the
  wrapper's allocations), and ``walk_ms`` / ``wgrad_ms``: the device time
  of its walk and weight-gradient kernels (``torch.profiler``), with
  ``bwd_general_ms`` on the general route where the checkout has
  ``mega_grad.bwd_route``; ``bwd_f32_ms``: the same call in float32 on the
  route the checkout picks, on a float32 model's inputs, and
  ``walk_f32_ms`` / ``wgrad_f32_ms``: its walk's and weight gradients'
  device time (``torch.profiler``).
- ``f150_digest``: the same hash of #5's files and #6's outputs in float32
  at the NMN CLIs' default F 150 (B 32, H 512, video 2048, dropout 0.25,
  a float32 model from seed 0), each on the route the checkout picks (the
  "fma32" route where the checkout takes F 150 there, else the general
  route: the two give equal bits, so the digest stays), with
  ``f150_train_ms`` and ``f150_bwd_ms`` (#5 and #6 on that route: where the
  checkout has the "fma32" cluster mode, on the cluster its launches pick)
  and, where the checkout has the routes, ``f150_general_digest``,
  ``f150_train_general_ms`` and ``f150_bwd_general_ms`` on the general
  route; where it has the cluster mode, ``f150_one_cta_digest``,
  ``f150_train_one_cta_ms`` and ``f150_bwd_one_cta_ms`` on one CTA an
  example (the wrappers' ``cluster=1``; the digest stays);
- ``step_ms``: #10, the ``T`` (13) ``fused_step`` launches of a serving
  batch of 1024 on ``executor="step"`` on the route the checkout picks,
  ``step_general_ms`` on the general route where the checkout has
  ``executor_step.step_route``, and ``step_digest``: the same hash of the
  general route's outputs on those 13 calls (their inputs recorded with the
  general route, so every checkout hands it the same bits), and
  ``step_tc_digest``: the same calls' outputs on the route the checkout
  picks (the tensor-core route at F 64, one CTA a tile); ``step_f32_ms``
  and ``step_f32_digest``: the same in float32 (a serving batch of the same
  weights with ``compute_dtype="float32"``) on the route the checkout picks
  (the "fma32" route where the checkout has it), with
  ``step_f32_general_ms`` and ``step_f32_general_digest`` on the general
  route; the two digests are equal where the routes give the same bits;
- ``slot_add_ms``: #13, the seven slot adds of one ``"rev"`` backward step
  at the train shapes (bf16, B 128) as the checkout's ``rev_exec`` makes
  them (one ``SlotPlan`` call where the checkout has it, else one
  ``slot_add_many``, else seven ``slot_add``), and ``slot_add_seven_ms``:
  seven ``slot_add`` launches; ``slot_set_ms`` (#11) and ``slot_zero_ms``
  (#12): the step's four sets and its eight reads-and-zeros (the four
  output cotangents read out, then zeroed, then the same slots of the
  register files) as its ``rev_exec`` makes them (one ``SlotPlan`` call
  each where the checkout has it, else four ``slot_set``, and four
  gathers and eight ``slot_zero``); the three again by CUDA-graph replay
  (``slot_add_graph_ms``, ``slot_set_graph_ms``, ``slot_zero_graph_ms``:
  the device's time without the host's between launches, on files that
  stay in L2);
- ``rev_digest``: the same hash of one bf16 ``"rev"`` train step's loss
  and every gradient leaf (B 128, dropout 0.25, weights from seed 0, the
  loss's generator from seed 7, ``torch.use_deterministic_algorithms``
  on), through the model's public API, and ``rev_step_ms``: that step
  (loss and backward) by CUDA events.

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


def f150_rows(inputs, rate, seed):
    """``f150_digest`` and its times, and their general-route twins (see
    the module docstring), on ``train_inputs``' float32 inputs at F 150."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.utils.device import cuda_time_ms

    meta, args, _, cots = inputs

    def train():
        return TX.mega_exec_train_call(meta, args, rate, seed)

    def both():
        outs = train()
        return (*outs, *TG.mega_exec_bwd_call(meta, args, outs, cots, rate,
                                              seed))

    outs = train()
    row = {"f150_digest": digest(both()),
           "f150_train_ms": cuda_time_ms(train, iters=3),
           "f150_bwd_ms": cuda_time_ms(lambda: TG.mega_exec_bwd_call(
               meta, args, outs, cots, rate, seed), iters=3)}
    if hasattr(TX, "fwd_route"):
        with forced(TX, "fwd_route", "general"):
            outs = train()
            row["f150_general_digest"] = digest(both())
            row["f150_train_general_ms"] = cuda_time_ms(train, iters=3)
            row["f150_bwd_general_ms"] = cuda_time_ms(
                lambda: TG.mega_exec_bwd_call(meta, args, outs, cots, rate,
                                              seed), iters=3)
    if hasattr(TX, "fma32_cluster"):

        def train1():
            return TX.mega_exec_train_call(meta, args, rate, seed, cluster=1)

        def bwd1(o):
            return TG.mega_exec_bwd_call(meta, args, o, cots, rate, seed,
                                         cluster=1)

        outs = train1()
        row["f150_one_cta_digest"] = digest((*outs, *bwd1(outs)))
        row["f150_train_one_cta_ms"] = cuda_time_ms(train1, iters=3)
        row["f150_bwd_one_cta_ms"] = cuda_time_ms(lambda: bwd1(outs),
                                                  iters=3)
    return row


def step_rows(dev):
    """``step_ms``, ``step_general_ms`` and ``step_digest``, and their
    float32 twins ``step_f32_*`` (see the module docstring), on the 13
    ``fused_step`` calls of one serving batch."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import cuda_time_ms

    serving = W.ServingBatches(dev, batch_size=1024, question_len=16)
    base = W.build_model(serving.cfg, seed=0, device=dev)
    b0 = serving.device_batch(serving.host_batch(0))
    routed = hasattr(TE, "step_route")
    real = TE.fused_step

    def general():
        return (forced(TE, "step_route", "general") if routed
                else contextlib.nullcontext())

    row = {}
    for tag, dtype in (("step", "bfloat16"), ("step_f32", "float32")):
        cfg = NMNConfig(**{**serving.cfg.to_dict(), "compute_dtype": dtype})
        model = VideoNMN(cfg, base.param_tree(), device=dev, executor="step")
        calls = []

        def record(*a):
            calls.append(tuple(x.clone() for x in a))
            return real(*a)

        TE.fused_step = record
        try:
            with general():
                model(b0)
        finally:
            TE.fused_step = real

        def run():
            return [real(*a) for a in calls]

        def hashed():
            # call by call (a generator: one call's outputs held at once)
            return digest(
                x for a in calls for x in real(*(t.clone() for t in a)))

        row[f"{tag}_ms"] = cuda_time_ms(run, iters=5)
        row["step_f32_digest" if tag == "step_f32"
            else "step_tc_digest"] = hashed()
        with general():
            if routed:
                row[f"{tag}_general_ms"] = cuda_time_ms(run, iters=5)
            row["step_digest" if tag == "step"
                else "step_f32_general_digest"] = hashed()
        del calls, model
        torch.cuda.empty_cache()
    return row


def slot_rows(dev):
    """``slot_add_ms``, ``slot_add_seven_ms``, ``slot_set_ms``,
    ``slot_zero_ms`` and their graph-replay times (see the module
    docstring) on files of the train step's shapes from a fixed seed."""
    from stair_tpu_torch.models.rev_exec import take
    from stair_tpu_torch.ops import regslots as TR
    from stair_tpu_torch.utils.device import cuda_time_ms, graph_ms

    gen = torch.Generator().manual_seed(13)
    B = 128
    shapes = {"rv": (B, 25, 512), "rf": (B, 9, 64, 512), "ra": (B, 11, 64)}
    files = {n: torch.randn(s, generator=gen).to(dev, torch.bfloat16)
             for n, s in shapes.items()}

    def index(n):
        return torch.randint(0, shapes[n][1], (B,), generator=gen).to(
            dev, torch.int32)

    def block(n):
        return torch.randn(B, *shapes[n][2:], generator=gen).to(
            dev, torch.bfloat16)

    adds = [(files[n], index(n), block(n))
            for n in ("rv", "rv", "rv", "rf", "rf", "ra", "ra")]
    # out_vec, out_frames, out_attn, out_attn_b (on one slot for half the
    # examples, as through the scratch slot)
    sets = [(files[n], index(n), block(n)) for n in ("rv", "rf", "ra", "ra")]
    sets[3][1][:B // 2] = sets[2][1][:B // 2]
    cots = {n: torch.randn(s, generator=gen).to(dev, torch.bfloat16)
            for n, s in shapes.items()}
    written = [(f, i) for f, i, _ in reversed(sets)]
    d_written = [(cots[n], i) for n, (_, i) in zip(("ra", "ra", "rf", "rv"),
                                                   written)]

    def seven():
        for f, i, v in adds:
            TR.slot_add(f, i, v)

    if hasattr(TR, "SlotPlan"):
        add_plan = TR.SlotPlan("add", [(f, i.view(1, -1)) for f, i, _ in
                                       adds])
        set_plan = TR.SlotPlan("set", [(f, i.view(1, -1)) for f, i, _ in
                                       sets])
        outs = [f.new_empty((B, *f.shape[2:])) for f, _ in d_written]
        zero_plan = TR.SlotPlan("zero", [
            *((f, i.view(1, -1), o) for (f, i), o in zip(d_written, outs)),
            *((f, i.view(1, -1)) for f, i in written)])

        def add():
            add_plan(0, [v for _, _, v in adds])

        def set_():
            set_plan(0, [v for _, _, v in sets])

        def zero():
            zero_plan(0)
    else:
        many = getattr(TR, "slot_add_many", None)

        def add():
            many(adds) if many else seven()

        def set_():
            for f, i, v in sets:
                TR.slot_set(f, i, v)

        def zero():
            for f, i in d_written:
                take(f, i)
                TR.slot_zero(f, i)
            for f, i in written:
                TR.slot_zero(f, i)

    return {"slot_add_ms": cuda_time_ms(add, iters=20),
            "slot_add_seven_ms": cuda_time_ms(seven, iters=20),
            "slot_set_ms": cuda_time_ms(set_, iters=20),
            "slot_zero_ms": cuda_time_ms(zero, iters=20),
            "slot_add_graph_ms": graph_ms(add),
            "slot_set_graph_ms": graph_ms(set_),
            "slot_zero_graph_ms": graph_ms(zero)}


def rev_rows(dev, cfg, batch):
    """``rev_digest`` and ``rev_step_ms`` (see the module docstring)."""
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.train.losses import total_loss
    from stair_tpu_torch.utils.device import cuda_time_ms

    model = W.build_model(cfg, seed=0, device=dev, executor="rev")

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = total_loss(model, batch, torch.Generator().manual_seed(7),
                             1.0, 1.0, 1.0, 1.0, contrastive_window=32)
        loss.backward()
        return loss

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss = step()
        row = {"rev_digest": digest([loss.detach(), *(
            torch.zeros_like(p) if p.grad is None else p.grad
            for _, p in sorted(model.weights.items()))])}
    finally:
        torch.use_deterministic_algorithms(False)
    row["rev_step_ms"] = cuda_time_ms(step, iters=3, warmup=1)
    return row


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
    # #4 in float32 on the same serving batch (the float32 encoders, the
    # model's float32 weights)
    with torch.no_grad():
        kv = TL.bilstm(*TL._prep(p["video_encoder"], b0["video"],
                                 b0["video_mask"]))
        kq = TL.bilstm(*TL._prep(p["text_encoder"], b0["question"],
                                 b0["question_mask"]))
    cfg32 = NMNConfig(**{**cfg.to_dict(), "compute_dtype": "float32"})
    meta32, args32 = TX.prepare_args(
        cfg32, p["modules"], VideoNMN._fused_tables(p["modules"]),
        b0["trace"], kv[:2], b0["video_mask"], kq[:2], b0["question_mask"])
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
    # #5 and #6 in float32 at the NMN CLIs' default F 150 (train/args.py)
    wide = W.workload_config(hidden_size=512, video_size=2048, text_size=300,
                             max_video_length=150)
    fcfg = NMNConfig(**{**wide.to_dict(), "compute_dtype": "float32",
                        "dropout": 0.25})
    f150 = train_inputs(fcfg, W.to_device(W.add_fake_supervision(
        W.make_batch(fcfg, batch_size=32, question_len=16), fcfg), dev),
        "float32", dev, seed)

    def fwd():
        return TX.mega_exec_call(meta, args)

    def fwd_f32():
        return TX.mega_exec_call(meta32, args32)

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
        row["fwd_f32_ms"] = cuda_time_ms(fwd_f32, iters=3)
        row["fwd_f32_digest"] = digest(fwd_f32())
        if hasattr(TX, "fwd_route"):
            with forced(TX, "fwd_route", "general"):
                row["fwd_f32_general_ms"] = cuda_time_ms(fwd_f32, iters=3)
        row["train_f32_digest"] = digest(TX.mega_exec_train_call(
            f32[0], f32[1], tcfg.dropout, seed))
        row["train_f32_ms"] = cuda_time_ms(lambda: TX.mega_exec_train_call(
            f32[0], f32[1], tcfg.dropout, seed), iters=5)
        row["bwd_ms"] = cuda_time_ms(bwd, iters=5)
        parts = kernel_ms(bwd, ("mega_bwd", "mega_wgrad"))
        row["walk_ms"] = parts["mega_bwd"]
        row["wgrad_ms"] = parts["mega_wgrad"]
        if hasattr(TG, "bwd_route"):
            with forced(TG, "bwd_route", "general"):
                row["bwd_general_ms"] = cuda_time_ms(bwd, iters=3)
        row["bwd_f32_ms"] = cuda_time_ms(
            lambda: TG.mega_exec_bwd_call(*f32, tcfg.dropout, seed), iters=3)
        parts = kernel_ms(lambda: TG.mega_exec_bwd_call(
            *f32, tcfg.dropout, seed), ("mega_bwd", "mega_wgrad"), iters=3)
        row["walk_f32_ms"] = parts["mega_bwd"]
        row["wgrad_f32_ms"] = parts["mega_wgrad"]
        row.update(f150_rows(f150, fcfg.dropout, seed))
        print(json.dumps(row), flush=True)
    del args, args32, targs, tout, cots, model, f32, f150
    torch.cuda.empty_cache()
    for rnd in range(2):
        print(json.dumps({"tag": tag, "card": card, "round": rnd,
                          **step_rows(dev), **slot_rows(dev),
                          **rev_rows(dev, tcfg, batch)}), flush=True)

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
