#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU: the NMN serving
forward and train step (on the megakernel route, and on the scan
executor's per-step and reversible routes), Video-ChatGPT serving and LLM
training.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device: refuse to run without CUDA; print the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. build: compile the CUDA kernels from ``stair_tpu_torch/ops/csrc``, print
   every kernel's ptxas registers and spills, and fail on a spill in the
   tensor-core kernels (the attention backward's and the executor's);
3. BiLSTM forward kernels vs their plain version at the slice's shapes (B
   = 1024, h = 256; video L = 64 / D = 1024, question L = 16 / D = 300),
   with non-suffix masks and an all-padding row: float32 on the general
   route, bf16 on the cluster route and the general route, and on both at
   the batches whose tiles ``lstm.fwd_tile`` picks otherwise (the train
   step's 128, the class table's 64, a ragged 125); two launches of each
   with identical bits;
4. executor kernel vs its plain version over the all-opcode program set at
   H = 512, both Filter modes and both temporal modes (F = 16 linear,
   F = 64 conv), float32 (the general route) and bf16 on both of its
   routes (the tensor-core kernel and the general one);
5. the slice end to end at the bench configuration (H = 512, video 1024,
   text 300, F = 64, 172 answers, bf16, B = 1024, the 128-program pool):
   native parse/lower with span linking, tokenization to ids, pinned H2D,
   device embedding gather, ``VideoNMN.forward``, logits fetch — for a few
   batches, with launch counters proving both kernels ran (the BiLSTM on
   its cluster route and the executor on its tensor-core route, none on
   the general routes), kernel vs plain route on one batch, and both
   executor routes against the plain version on the main path's inputs;
6. BiLSTM training kernels (forward with state stacks, backward and its
   dwh/dbias reduction) vs their plain versions at the training shapes
   (B = 128, h = 256; video L = 64 / D = 1024, question L = 16 / D = 300),
   float32 and bf16, with holes and an all-padding row; the forward and
   the backward each on both of their routes (bf16: the cluster route and
   the general route; float32: the general route), the backward on the
   cluster forward's stacks, two runs of each with identical bits;
7. executor training kernels (forward with dropout 0.25, backward and its
   weight-gradient reduction) vs their plain versions over the all-opcode
   programs at H = 512, both Filter modes and both temporal modes, float32
   (three runs, the last two on inputs moved by 1e-4 to move ReLU kinks:
   all within 5e-2, two of three within 1e-4) and bf16 on both routes
   (tensor-core and general: the forward within atol 3e-2 + rtol 1e-2, the
   backward within 1e-1, each backward handed its own route's forward);
   two backward runs must give identical bits; the tensor-core walk's
   recompute products against the training forward's own calls at the
   walk's shapes (the matrix and the vec-level products, alone and as
   stage 1's chained pair): equal bits;
8. the training slice at ``scripts/bench_train_step.py``'s configuration
   (H = 512, video 1024, text 300, F = 64, 172 answers, 64 object types,
   bf16, dropout 0.25, B = 128, fake supervision, Adam at lr 2e-4 with the
   trainer's 1.0 -> 0.1 schedule): 10 steps on the kernel route with launch
   counts per step (the BiLSTM forward and backward on their cluster
   routes, the executor forward and backward on their tensor-core routes,
   none on the general routes) and a falling loss, one step kernel vs
   plain route (the loss in bf16; the gradients leaf by leaf in float32,
   where rounding sites agree), ms per step on both routes, each training kernel against
   its plain version on the step's own inputs (the executor backward on
   each route handed that route's forward's register files, as the step
   hands them, against autograd at those files, within 1e-1; and on the
   plain forward's files against autograd through the plain forward,
   within 1e-1) and its time beside its plain version's at these shapes
   (the BiLSTM forward and backward and the executor forward and backward
   also on their general routes);
9. the attention kernel vs its plain version: B = 4, H = 32, D = 128 at
   L = 640 and a ragged L = 611 (strided views), grouped heads 32 / 8,
   D = 64 with mixed ``prefix_len``, non-causal with Lq != Lkv, a head_dim
   the tensor-core kernel refuses, ``valid_len`` from 0 to L and at 1,
   127, 128, 129 (edges of the tensor-core kernel's query tiles); out and
   lse, float32 within 1e-4 and bf16 within 2e-2; its time beside the plain
   version's and ``scaled_dot_product_attention``'s (a yardstick only),
   the kernel's and the yardstick's as device time over calls replayed
   from a CUDA graph (``graph_ms``: the wrapper's host time exceeds the
   kernel's), as in phase 10's kernel entry;
10. Video-ChatGPT serving at full width: Llama-7B (32 layers, d 4096) and
   CLIP ViT-L/14 in bf16 with weights made on the card from a seed, batch
   4, 100 frames per video, 64 new tokens, greedy: ``encode_video_batch``
   then ``video_chatgpt_infer_batch``, with 32 attention launches per
   prefill, finite logits and four strings; then at 2 decoder + 2 tower
   layers of the same widths the kernel route against the plain route
   (prefill hidden states below ``prompt_len``, first greedy token); then
   one ``VideoPrefixLM.forward`` at GPT-2 widths with the video-visible
   prefix mask against its plain route;
11. the attention backward kernels (dQ; dK/dV) vs their plain version over
   the mask cases of phase 9 plus grouped heads with one kv head and D = 32,
   float32 (within 2e-4 of each gradient's largest value) and bf16 (within
   2e-2), on strided q/k/v and a non-contiguous dO: identical bits on a
   second launch, padding rows exactly 0, no NaN at ``valid_len`` 0, the
   ``di`` that the dQ launch writes against the plain version's (1e-5 of
   each row's sum of |O dO|, 0 on padding rows), and exactly two CUDA
   launches in one backward (``torch.profiler``'s device events); the
   build's ptxas lines for every kernel, with no spill allowed in the
   backward's tensor-core kernels;
12. the SFT train step at full width: phase 10's Llama-7B in bf16 with the
   projector alone tuned (in float32), batch 8 x 512 tokens with ragged
   ``valid_len``, through ``videochat_train.make_sft_step``: a finite loss
   that falls on the repeated batch, 32 + 32 + 32 attention launches per
   step, ms per step and peak memory without remat and with
   ``remat='full'``; then at 2 decoder layers of full width every gradient
   leaf of the kernel route against the plain route in float32, and the
   bf16 loss of both routes; on the step's own q, k, v the backward
   kernels against their plain version, and their times (each kernel and
   the whole backward, ``di`` included, by CUDA-graph replay) beside the
   plain version's and autograd through ``scaled_dot_product_attention``
   (a yardstick only);
13. both trainers as entry points on the card at their CLI defaults, on
   seeded tiny data: ``videochat_train.main`` then ``videochat_infer`` on
   the checkpoint it saved; ``with_video_lm.main`` for the GPT-2 family
   with the video loss and for Llama with LoRA, each then ``--func test``
   on what it saved;
14. the register-slot kernels (set, zero, add) vs their plain versions on
   the three register files at the training shapes (B = 128: vec
   ``[128, 25, 512]``, frames ``[128, 9, 64, 512]``, attn ``[128, 11, 64]``),
   float32 and bf16, random slots including the scratch slot: equal bits,
   and every other slot equal to what it was; ``slot_add_many`` on the
   seven adds of a ``"rev"`` step (repeated slots: vb = va, fb = fa, ab =
   aa on some examples) in one launch: equal bits to the seven plain adds
   and to seven ``slot_add`` launches in turn; its time beside the seven
   launches', seven ``index_put_(accumulate=True)`` and the bound;
15. the fused executor-step kernel vs its plain version at every step of
   the all-opcode programs at H = 512 (F = 16 linear and F = 64 conv
   temporal), float32 on the general route within 1e-4 and bf16 on both
   routes (the tensor-core kernel, which ``step_route`` picks, and the
   general one) within atol 3e-2 + rtol 1e-2: every output and the whole
   frames file, ``T`` launches of the route's key;
16. the serving path at full width on the scan executor (phase 5's
   configuration and batches through ``VideoNMN(executor="step")``): per
   batch ``T`` launches of the tensor-core step kernel, none of the
   general one, 2 of the BiLSTM kernel and none of the megakernel; logits
   and the three register files against the megakernel route on one batch
   (an example whose Choose step saw two cosines tie within bf16 rounding,
   and kept another keyword on each route, is held to that tie and left
   out of the file comparison); q/s and device ms per batch beside that
   route's; the 13 launches of the batch on both routes against the plain
   version, with their times and bound;
17. the train step on the reversible executor (phase 8's configuration with
   ``executor="rev"``): per step ``4 T`` slot sets, ``8 T`` slot zeros and
   ``T`` launches of ``slot_add_many`` (the seven adds of a step; no
   ``slot_add``), the BiLSTM training kernels as in phase 8 and no
   megakernel; a finite, falling loss over 10 steps; one step's loss and
   every gradient leaf in float32 against ``executor="step"`` under the
   same seed; ms per step beside phase 8's.

Each path is driven with the launch counts set to 0 just before it and
read just after. The last two lines are ``{"kernels": [...]}`` (per
kernel: launches on its main path, error against the plain version on the
main path's inputs, its time, the plain version's, the bound the card's
peaks allow for this run's inputs, and a library call's time where one
computes the same function) and ``{"ok": true, "device": {...}}``. The
step kernel's general route (``executor_step``) counts the launches of its
own path, phase 15's float32 forward at F = 64; ``slot_add`` shows 0, as
the ``"rev"`` path now makes its adds through ``slot_add_many``. Every
time printed is measured in this run, on the card named above it.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import torch

NUM_BATCHES = 8
BATCH = 1024
QUESTION_LEN = 16
#: the training phases' widths: scripts/bench_train_step.py's configuration
HIDDEN, VIDEO_D, TEXT_D, FRAMES = 512, 1024, 300, 64
TRAIN_BATCH = 128
TRAIN_STEPS = 10
#: per training step: video + question encoders through the train pair
#: (forward and backward on their bf16 cluster routes: the forward, the
#: backward's walk, dwh slices and their sum; none on the general routes),
#: the class table through the eval kernel's cluster route, one executor
#: training forward (#5) and its backward (the walk and the weight
#: gradients), both on their tensor-core routes (none on the general
#: routes)
TRAIN_LAUNCHES = {"bilstm": 0, "bilstm_train": 0, "bilstm_tc": 1,
                  "bilstm_train_tc": 2, "bilstm_bwd": 0, "bilstm_dwh": 0,
                  "bilstm_bwd_tc": 2, "bilstm_dwh_tc": 2, "bilstm_dwh_sum": 2,
                  "mega_exec": 0, "mega_exec_tc": 0, "mega_exec_train": 0,
                  "mega_exec_train_tc": 1, "mega_exec_bwd": 0,
                  "mega_exec_wgrad": 0, "mega_exec_bwd_tc": 1,
                  "mega_exec_wgrad_tc": 1}


#: what an earlier phase measured and a later one prints beside its own
SEEN = {}
STEP_BATCHES = 4
#: two cosines closer than this (about four bf16 steps below 1) are a tie
#: that the executor routes may break differently
CHOOSE_TIE = 1.6e-2

#: the SFT step: videochat_train.py's defaults (batch 8, 512 tokens)
SFT_BATCH, SFT_LEN, SFT_STEPS, SFT_LR = 8, 512, 6, 3e-4


#: the card's published peaks (NVIDIA H100 SXM data sheet): dense FLOP/s by
#: input type, and device-memory bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def tensor_bytes(*trees):
    """Bytes of every tensor in nested tuples/lists/dicts."""
    total = 0
    for t in trees:
        if torch.is_tensor(t):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += tensor_bytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += tensor_bytes(*t)
    return total


def bound(flops, nbytes, dtype):
    """The least time the card could take: the larger of operations over
    the peak rate of their input type and compulsory bytes over the memory
    rate. Returns ``{"bound_ms", "bound_by"}``."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    mem_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, mem_ms),
            "bound_by": "operations" if ops_ms >= mem_ms else "bytes"}


def add_bounds(*bs):
    """The bound of several launches timed as one entry."""
    ms = sum(b["bound_ms"] for b in bs)
    by = max(bs, key=lambda b: b["bound_ms"])["bound_by"]
    return {"bound_ms": ms, "bound_by": by}


def counted_flops(fn):
    """Matrix-product operations of one call of ``fn`` (a plain version on
    this run's inputs), counted by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    return fc.get_total_flops()


def lstm_bound(args, outs, passes=1, extra=()):
    """BiLSTM recurrence: per live step and direction one ``[B, h] @ [h,
    4h]`` product (three in the backward: the gate recompute, ``dgates @
    wh^T`` and ``h^T dgates``); every argument read and every output
    written once."""
    xp_f, mask = args[0], args[2]
    h = xp_f.shape[-1] // 4
    flops = passes * 2 * 2 * 4 * h * h * float(mask.sum())
    return bound(flops, tensor_bytes(args, outs, extra), xp_f.dtype)


def lstm_library_ms(B, L, D, h, dev, dtype, train=False):
    """``torch.nn.LSTM(bidirectional=True)`` at the same B, L, D, h on
    full-length sequences (it has no per-step mask and includes the input
    projection that the port leaves to a matmul outside its kernel): the
    nearest single PyTorch call, timed as a yardstick and used nowhere.
    Returns (forward ms, backward ms or None)."""
    from stair_tpu_torch.utils.device import cuda_time_ms

    lstm = torch.nn.LSTM(D, h, batch_first=True, bidirectional=True).to(
        dev, dtype)
    x = torch.randn(B, L, D, device=dev, dtype=dtype)
    if not train:
        with torch.no_grad():
            return cuda_time_ms(lambda: lstm(x), iters=5), None
    lstm.train()
    x.requires_grad_(True)
    fwd = cuda_time_ms(lambda: lstm(x), iters=5)
    g = torch.randn(B, L, 2 * h, device=dev, dtype=dtype)
    both = cuda_time_ms(lambda: lstm(x)[0].backward(g), iters=5)
    return fwd, max(both - fwd, 0.0)


def graph_ms(fn, iters=20):
    """Device milliseconds per call of ``fn`` by CUDA-graph replay
    (``utils.device.graph_ms``)."""
    from stair_tpu_torch.utils import device

    return device.graph_ms(fn, iters)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def plain_route():
    """Route every kernel call of the model (serving and training) to its
    plain PyTorch version (on the same CUDA tensors) for a comparison run;
    fails if a kernel was launched inside it all the same."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.ops import regslots as TR

    def attention(q, k, v, prefix_len, valid_len, causal=True,
                  sm_scale=None, return_lse=False):
        out, lse = TA.reference_attention(
            q, k, v, prefix_len.to(torch.int32), valid_len.to(torch.int32),
            causal, sm_scale)
        return (out, lse) if return_lse else out

    def lstm_train(*args, token_dtype=torch.float32):
        return TL.bilstm_reference(*args, token_dtype=token_dtype,
                                   return_stacks=True)

    def mega_train(meta, args, rate, seed):
        return TX.mega_exec_reference(meta, args, rate=rate, seed=seed)

    swaps = [(TL, "bilstm", TL.bilstm_reference),
             (TL, "bilstm_train_call", lstm_train),
             (TL, "bilstm_bwd_call", TL.bilstm_bwd_reference),
             (TX, "mega_exec_call", TX.mega_exec_reference),
             (TX, "mega_exec_train_call", mega_train),
             (TG, "mega_exec_bwd_call", TG.mega_exec_bwd_reference),
             (TA, "flash_attention", attention),
             (TE, "fused_step", TE.fused_step_reference),
             (TR, "slot_set", TR.slot_set_reference),
             (TR, "slot_zero", TR.slot_zero_reference),
             (TR, "slot_add", TR.slot_add_reference),
             (TR, "slot_add_many", TR.slot_add_many_reference)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    _build.reset_launches()
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    require(not any(_build.LAUNCHES.values()),
            f"the plain route launched kernels: {_build.LAUNCHES}")


@contextlib.contextmanager
def general_lstm_fwd():
    """Send the BiLSTM forward (eval and training) through its general
    route (``bilstm`` / ``bilstm_train``) whatever ``lstm.fwd_route``
    picks."""
    from stair_tpu_torch.ops import lstm as TL

    pick = TL.fwd_route
    TL.fwd_route = lambda dtype, h: "general"
    try:
        yield
    finally:
        TL.fwd_route = pick


#: the BiLSTM forward's routes: name, launch-key suffix, context
FWD_ROUTES = (("cluster", "_tc", contextlib.nullcontext),
              ("general", "", general_lstm_fwd))


@contextlib.contextmanager
def general_lstm_bwd():
    """Send the BiLSTM backward through its general route
    (``bilstm_bwd`` + ``bilstm_dwh``) whatever ``lstm.bwd_route`` picks."""
    from stair_tpu_torch.ops import lstm as TL

    pick = TL.bwd_route
    TL.bwd_route = lambda dtype, h: "general"
    try:
        yield
    finally:
        TL.bwd_route = pick


@contextlib.contextmanager
def general_mega():
    """Send the executor's forward (eval and training) and backward through
    their general routes (``mega_exec``, ``mega_exec_train``;
    ``mega_exec_bwd`` + ``mega_exec_wgrad``) whatever
    ``mega_exec.fwd_route`` and ``mega_grad.bwd_route`` pick."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG

    picks = TX.fwd_route, TG.bwd_route
    TX.fwd_route = lambda *a: "general"
    TG.bwd_route = lambda *a: "general"
    try:
        yield
    finally:
        TX.fwd_route, TG.bwd_route = picks


#: the bf16 executor's routes: name, eval launch key, context
MEGA_ROUTES = (("tc", "mega_exec_tc", contextlib.nullcontext),
               ("general", "mega_exec", general_mega))
#: the training forward's launch key on each route
TRAIN_KEYS = {"tc": "mega_exec_train_tc", "general": "mega_exec_train"}


@contextlib.contextmanager
def kernel_route(keys):
    """Fail unless every kernel named in ``keys`` was launched inside the
    block."""
    from stair_tpu_torch.ops import _build

    _build.reset_launches()
    yield
    require(all(_build.LAUNCHES[k] for k in keys),
            f"the kernel route skipped a kernel: {_build.LAUNCHES}")


def max_err(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def lstm_inputs(gen, dev, B, L, D, h, dtype):
    from stair_tpu_torch.ops import lstm as TL

    p = TL.init_lstm_params(gen, D, h, device=dev)
    x = torch.randn(B, L, D, generator=gen).to(dev)
    lens = torch.randint(1, L + 1, (B,), generator=gen)
    mask = (torch.arange(L)[None] < lens[:, None]).float()
    mask *= (torch.rand(B, L, generator=gen) > 0.2).float()  # holes
    mask[:, 0] = 1.0
    mask[5] = 0.0                                             # all padding
    mm = None if dtype == torch.float32 else dtype
    return TL._prep(p, x, mask.to(dev), mm)


#: phase 3's BiLSTM cases: name, B, L, D. Serving's two encoders at B
#: 1024, then the batches whose tiles ``lstm.fwd_tile`` picks otherwise:
#: the train step's B 128, the class table's 64, a ragged B
LSTM_CASES = (("video", BATCH, 64, 1024), ("question", BATCH, 16, 300),
              ("video", TRAIN_BATCH, 64, 1024),
              ("question", TRAIN_BATCH, 16, 300),
              ("class table", 64, 16, 300), ("ragged", 125, 16, 300))


def run_lstm_routes(dev, args, dtype, key, call, check):
    """``call()`` on each of the BiLSTM forward's routes that takes
    ``dtype`` (float32: the general route alone): twice, with identical
    bits and two launches of ``key`` plus the route's suffix and none of
    the other route's; ``check(route, out)`` holds each against the plain
    version. Returns {route: (out, batch tile or None)}."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL

    B, h = args[0].shape[0], args[0].shape[-1] // 4
    outs = {}
    for route, sfx, ctx in FWD_ROUTES:
        if route != "general" and TL.fwd_route(dtype, h) != route:
            continue
        with ctx():
            _build.reset_launches()
            out, out2 = call(), call()
            torch.cuda.synchronize()
        other = key + ("" if sfx else "_tc")
        require(_build.LAUNCHES[key + sfx] == 2
                and _build.LAUNCHES[other] == 0,
                f"{key} {route} route launches {_build.LAUNCHES}")
        flat = [t for o in (out, out2) for t in (
            (*o[:3], *o[3]) if len(o) == 4 else o)]
        n = len(flat) // 2
        require(all(torch.equal(x, y) for x, y in zip(flat[:n], flat[n:])),
                f"{key} {route} route: two launches differ")
        require(out[0][5].abs().max().item() == 0.0,
                f"{key} {route} route: all-padding row has nonzero tokens")
        check(route, out)
        tile = (TL.fwd_tile(B, TL._clusters_held(dev, h))
                if route == "cluster" else None)
        outs[route] = (out, tile)
    return outs


def phase_lstm(dev):
    from stair_tpu_torch.ops import lstm as TL

    gen = torch.Generator().manual_seed(0)
    errs = {}
    for name, B, L, D in LSTM_CASES:
        dtypes = ((torch.float32, (1e-4, 1e-4)),) if B == BATCH else ()
        for dtype, tol in dtypes + ((torch.bfloat16, (0.0, 2e-2)),):
            args = lstm_inputs(gen, dev, B, L, D, 256, dtype)
            ref = TL.bilstm_reference(*args, token_dtype=dtype)

            def check(route, out):
                for o, r, what in zip(out, ref, ("tok_f", "tok_b", "sent")):
                    torch.testing.assert_close(
                        o.float(), r.float(), rtol=tol[0], atol=tol[1],
                        msg=f"{name} B={B} {dtype} {route} route {what}")

            outs = run_lstm_routes(
                dev, args, dtype, "bilstm",
                lambda: TL.bilstm(*args, token_dtype=dtype), check)
            for route, (out, tile) in outs.items():
                e = max_err(out, ref)
                errs[(name, B, str(dtype), route)] = e
                log(f"[lstm] {name} B={B} L={L} D={D} h=256 {dtype} {route} "
                    f"route{f' (batch tile {tile})' if tile else ''}: "
                    f"max_abs_err {e:.3e} (rtol {tol[0]}, atol {tol[1]}), "
                    "two launches bit-identical ok")
    return errs


def phase_mega(dev):
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.testing import workload as W

    errs = {}
    for F, attention in ((16, "parity"), (64, "softmax"), (64, "parity")):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = NMNConfig(
                hidden_size=512, video_size=1024, text_size=300,
                max_video_length=F, object_types=3, max_steps=16,
                num_vec=10, num_frames=6, num_attn=8,
                filter_attention=attention,
                compute_dtype="float32" if dtype == torch.float32
                else "bfloat16")
            model = W.build_model(cfg, seed=3, device=dev)
            programs = W.OPCODE_PROGRAMS * 8
            batch = W.to_device(W.opcode_batch(cfg, programs, seed=F), dev)
            B, L = batch["question"].shape[:2]
            gen = torch.Generator().manual_seed(F)
            halves = [torch.randn(B, n, 256, generator=gen).to(dev, dtype)
                      for n in (F, F, L, L)]
            mods = tree_map(lambda x: x.detach().to(dtype),
                            model.param_tree()["modules"])
            meta, args = TX.prepare_args(
                cfg, mods, VideoNMN._fused_tables(mods), batch["trace"],
                halves[:2], batch["video_mask"], halves[2:],
                batch["question_mask"])
            ref = TX.mega_exec_reference(meta, args)
            if dtype == torch.float32:
                tol = (1e-4, 1e-4)
            else:
                # a bf16 step is 2^-7 to 2^-8 of the value (0.0625 in
                # [8, 16)), so rtol 1e-2 allows about 1.3 to 2.6 steps; the
                # float32 check at 1e-4 is what catches logic errors
                tol = (1e-2, 3e-2)
            # float32 has the general route alone; bf16 both
            for route, key, ctx in MEGA_ROUTES:
                if TX.fwd_route(dtype, 512, F, False) != route and (
                        route != "general"):
                    continue
                with ctx():
                    _build.reset_launches()
                    out = TX.mega_exec_call(meta, args)
                    torch.cuda.synchronize()
                other = "mega_exec" if key == "mega_exec_tc" else \
                    "mega_exec_tc"
                require(_build.LAUNCHES[key] == 1
                        and _build.LAUNCHES[other] == 0,
                        f"mega_exec {route} route launches {_build.LAUNCHES}")
                for o, r, what in zip(out, ref, ("regs_vec", "regs_frames",
                                                 "regs_attn")):
                    torch.testing.assert_close(
                        o.float(), r.float(), rtol=tol[0], atol=tol[1],
                        msg=f"{route} route {what}")
                agree = np.mean([
                    (o.float().argmax(-1) == r.float().argmax(-1)).float()
                    .mean().item() for o, r in zip(out, ref)])
                if dtype == torch.bfloat16:
                    require(agree >= 0.98,
                            f"{route} route register argmax agreement {agree}")
                e = max_err(out, ref)
                errs[(F, attention, str(dtype), route)] = e
                log(f"[mega_exec] all {len(W.OPCODE_PROGRAMS)} opcode "
                    f"programs x8 H=512 F={F} {attention} "
                    f"{'conv' if cfg.conv_temporal else 'linear'}-temporal "
                    f"{dtype} {route} route: max_abs_err {e:.3e}, row argmax "
                    f"agreement {agree:.4f} (rtol {tol[0]}, atol {tol[1]}) ok")
    return errs


def phase_slice(dev, card):
    from stair_tpu_torch.models.nmn import VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import cuda_time_ms

    serving = W.ServingBatches(dev, batch_size=BATCH,
                               question_len=QUESTION_LEN)
    cfg = serving.cfg
    log(f"[slice] config {json.dumps(cfg.to_dict())}")
    model = W.build_model(cfg, seed=0, device=dev)
    host_batch, device_batch = serving.host_batch, serving.device_batch

    def forward(b):
        return model(b)["logits"]

    # Warm-up (allocator, cuBLAS handles) outside the counted run.
    hb0 = host_batch(NUM_BATCHES)
    warm = forward(device_batch(hb0))
    torch.cuda.synchronize()
    require(warm.shape == (BATCH, cfg.answer_vocab_length), "logits shape")

    # ---- the counted main-path run ------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    host_s = 0.0
    fetched = []
    for i in range(NUM_BATCHES):
        th = time.perf_counter()
        hb = host_batch(i)
        host_s += time.perf_counter() - th
        fetched.append(forward(device_batch(hb)).float().cpu())
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    require(launches["bilstm_tc"] == 2 * NUM_BATCHES
            and launches["bilstm"] == 0,
            f"bilstm_tc launches {launches['bilstm_tc']} != "
            f"{2 * NUM_BATCHES} (general route {launches['bilstm']})")
    require(launches["mega_exec_tc"] == NUM_BATCHES
            and launches["mega_exec"] == 0,
            f"mega_exec_tc launches {launches['mega_exec_tc']} != "
            f"{NUM_BATCHES} (general route {launches['mega_exec']})")
    for lg in fetched:
        require(lg.shape == (BATCH, cfg.answer_vocab_length), "logits shape")
        require(bool(torch.isfinite(lg).all()), "non-finite logits")
    qps = NUM_BATCHES * BATCH / wall
    log(f"[slice] {NUM_BATCHES} batches x {BATCH} questions: {qps:.1f} q/s "
        f"end to end (host parse/lower/tokenize {host_s * 1e3:.1f} ms total, "
        f"sequential with the device), launches {launches}; card {card}")

    # ---- kernel route vs plain route on one batch -------------------------
    b0 = device_batch(hb0)
    with kernel_route(("bilstm_tc", "mega_exec_tc")):
        kern = forward(b0).float()
    with plain_route():
        plain = forward(b0).float()
    torch.cuda.synchronize()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    require(agree >= 0.98, f"kernel/plain argmax agreement {agree}")
    with kernel_route(("bilstm_tc", "mega_exec_tc")):
        dev_ms = cuda_time_ms(lambda: forward(b0), iters=5, warmup=1)
    with plain_route():
        plain_dev_ms = cuda_time_ms(lambda: forward(b0), iters=3, warmup=1)
    log(f"[slice] kernel vs plain route argmax agreement {agree:.4f}; "
        f"logits max_abs_err {float((kern - plain).abs().max()):.3e}")
    log(f"[slice] device forward per batch of {BATCH} (CUDA events): "
        f"kernel route {dev_ms:.3f} ms, plain route {plain_dev_ms:.3f} ms; "
        f"card {card}")
    SEEN.update(serving=serving, mega_model=model, mega_qps=qps,
                mega_dev_ms=dev_ms)

    # ---- each kernel on the main path's own inputs ----------------------
    dt = model.compute_dtype
    p = tree_map(lambda x: x.detach(), model.param_tree())
    vargs = TL._prep(p["video_encoder"], b0["video"], b0["video_mask"], dt)
    qargs = TL._prep(p["text_encoder"], b0["question"], b0["question_mask"],
                     dt)
    kv, kq = TL.bilstm(*vargs, token_dtype=dt), TL.bilstm(*qargs,
                                                        token_dtype=dt)
    rvv = TL.bilstm_reference(*vargs, token_dtype=dt)
    rqq = TL.bilstm_reference(*qargs, token_dtype=dt)
    lstm_err = max(max_err(kv, rvv), max_err(kq, rqq))
    require(lstm_err <= 2e-2, f"bilstm main-path max_abs_err {lstm_err}")
    mods = tree_map(lambda x: x.to(dt), p["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), b0["trace"], kv[:2],
        b0["video_mask"].to(dt), kq[:2], b0["question_mask"])
    rm = TX.mega_exec_reference(meta, args)
    mega_errs = {}
    for route, _, ctx in MEGA_ROUTES:
        with ctx():
            km = TX.mega_exec_call(meta, args)
        mega_errs[route] = max_err(km, rm)
        for o, r in zip(km, rm):
            torch.testing.assert_close(o.float(), r.float(), rtol=1e-2,
                                       atol=3e-2, msg=f"{route} route")
    mega_err = mega_errs["tc"]
    log(f"[main-path inputs] bilstm max_abs_err {lstm_err:.3e} (atol 2e-2); "
        f"mega_exec max_abs_err tensor-core route {mega_err:.3e}, general "
        f"route {mega_errs['general']:.3e} (rtol 1e-2, atol 3e-2) ok")

    def both():
        return (TL.bilstm(*vargs, token_dtype=dt),
                TL.bilstm(*qargs, token_dtype=dt))

    with general_lstm_fwd():
        general_ms = cuda_time_ms(both, iters=3)

    def general_ms_of(fn):
        with general_mega():
            return cuda_time_ms(fn, iters=3)

    t = {
        "bilstm_video": cuda_time_ms(lambda: TL.bilstm(*vargs,
                                                       token_dtype=dt)),
        "bilstm_question": cuda_time_ms(lambda: TL.bilstm(*qargs,
                                                          token_dtype=dt)),
        "bilstm_general": general_ms,
        "bilstm_video_plain": cuda_time_ms(
            lambda: TL.bilstm_reference(*vargs, token_dtype=dt), iters=3),
        "bilstm_question_plain": cuda_time_ms(
            lambda: TL.bilstm_reference(*qargs, token_dtype=dt), iters=3),
        "mega_exec": cuda_time_ms(lambda: TX.mega_exec_call(meta, args),
                                  iters=5),
        "mega_exec_general": general_ms_of(
            lambda: TX.mega_exec_call(meta, args)),
        "mega_exec_plain": cuda_time_ms(
            lambda: TX.mega_exec_reference(meta, args), iters=3),
    }
    for k, v in t.items():
        log(f"[kernel time] {k}: {v:.3f} ms per call (CUDA events, bf16, "
            f"main-path shapes); card {card}")
    lstm_b = add_bounds(lstm_bound(vargs, kv), lstm_bound(qargs, kq))
    lstm_lib = sum(lstm_library_ms(BATCH, L, D, cfg.hidden_size // 2, dev,
                                   dt)[0]
                   for L, D in ((cfg.max_video_length, cfg.video_size),
                                (QUESTION_LEN, cfg.text_size)))
    mega_b = bound(counted_flops(lambda: TX.mega_exec_reference(meta, args)),
                   tensor_bytes(args, km), dt)
    log(f"[bound] bilstm {lstm_b}, nn.LSTM (full length, with its input "
        f"projection) {lstm_lib:.3f} ms; mega_exec {mega_b}; card {card}")
    log(f"[kernel time] bilstm, both encoders: cluster route "
        f"{t['bilstm_video'] + t['bilstm_question']:.4f} ms (batch tile "
        f"{TL.fwd_tile(BATCH, TL._clusters_held(dev, 256))}), general route "
        f"{general_ms:.4f} ms, nn.LSTM {lstm_lib:.4f} ms; card {card}")
    return [
        {"name": "bilstm", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/bilstm.cu",
         "replaces": "stair_tpu/ops/lstm.py:136",
         "launches": launches["bilstm_tc"], "max_abs_err": lstm_err,
         "ms": t["bilstm_video"] + t["bilstm_question"],
         "general_ms": general_ms,
         "plain_ms": t["bilstm_video_plain"] + t["bilstm_question_plain"],
         **lstm_b, "library_ms": lstm_lib},
        {"name": "mega_exec", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/mega_exec.cu",
         "replaces": "stair_tpu/ops/mega_exec.py:123",
         "executor_route": "tc",
         "launches": launches["mega_exec_tc"], "max_abs_err": mega_err,
         "ms": t["mega_exec"], "general_ms": t["mega_exec_general"],
         "plain_ms": t["mega_exec_plain"], **mega_b, "library_ms": None},
    ]


def rel_err(a, b):
    """max |a - b| over max |b| (float32), the gradient comparisons'
    measure: one bound per tensor whatever its scale."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


def phase_lstm_train(dev):
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL

    gen = torch.Generator().manual_seed(1)
    errs = {}
    for name, L, D in (("video", FRAMES, VIDEO_D), ("question", QUESTION_LEN,
                                                       TEXT_D)):
        for dtype, ftol, btol in ((torch.float32, 1e-4, 1e-4),
                                  (torch.bfloat16, 2e-2, 2e-2)):
            args = lstm_inputs(gen, dev, TRAIN_BATCH, L, D, HIDDEN // 2, dtype)
            ref = TL.bilstm_reference(*args, token_dtype=dtype,
                                      return_stacks=True)
            fwd_errs = {}

            def check(route, out):
                fwd_errs[route] = max(max_err(out[:3], ref[:3]),
                                      max_err(out[3], ref[3]))
                require(fwd_errs[route] <= ftol,
                        f"bilstm_train {name} {dtype} {route} route: "
                        f"{fwd_errs[route]}")

            outs = run_lstm_routes(
                dev, args, dtype, "bilstm_train",
                lambda: TL.bilstm_train_call(*args, token_dtype=dtype), check)
            # the backward runs on the stacks of the route the main path
            # takes (bf16: the cluster forward's)
            out = outs[TL.fwd_route(dtype, HIDDEN // 2)][0]
            fwd = max(fwd_errs.values())
            B, h = TRAIN_BATCH, HIDDEN // 2
            dtok = [torch.randn(B, L, h, generator=gen).to(dev, dtype)
                    for _ in range(2)]
            dsent = torch.randn(B, 2 * h, generator=gen).to(dev)
            rb = TL.bilstm_bwd_reference(*args, ref[3], *dtok, dsent)
            routes = (("cluster", "bilstm_bwd_tc", contextlib.nullcontext),
                      ("general", "bilstm_bwd", general_lstm_bwd))
            for route, key, ctx in routes:
                if route != "general" and TL.bwd_route(dtype, h) != route:
                    continue   # float32 takes only the general route
                with ctx():
                    _build.reset_launches()
                    kb = TL.bilstm_bwd_call(*args, out[3], *dtok, dsent)
                    kb2 = TL.bilstm_bwd_call(*args, out[3], *dtok, dsent)
                    torch.cuda.synchronize()
                require(_build.LAUNCHES[key] == 2,
                        f"bilstm backward {route} route launches "
                        f"{_build.LAUNCHES}")
                require(all(torch.equal(x, y) for x, y in zip(kb, kb2)),
                        f"bilstm backward ({route}) is not deterministic")
                bwd = {n: rel_err(x, y) for n, x, y in zip(
                    ("dxp_f", "dxp_b", "dwh_f", "dwh_b", "dbias_f",
                     "dbias_b"), kb, rb)}
                worst = max(bwd.values())
                require(worst <= btol,
                        f"bilstm_bwd {route} {name} {dtype}: {bwd}")
                errs[(name, str(dtype), route)] = (fwd, max_err(kb, rb))
                ferr = ", ".join(f"{k} route {v:.3e}"
                                 for k, v in fwd_errs.items())
                log(f"[lstm train] {name} B={B} L={L} D={D} h={h} {dtype}: "
                    f"forward+stacks max_abs_err {ferr} (atol {ftol}; batch "
                    f"tile {outs[TL.fwd_route(dtype, h)][1]}; two launches "
                    "of each bit-identical); "
                    f"backward on the {route} route ({key}) max rel err "
                    f"{worst:.3e} (bound {btol}: "
                    f"{', '.join(f'{k} {v:.2e}' for k, v in bwd.items())}); "
                    "two backward runs bit-identical ok")
    return errs


def phase_mega_train(dev):
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.testing import workload as W

    rate, seed = 0.25, (1234567, 2 ** 31 - 5)
    names = (("dvf_a", "dvf_b", "dtok_a", "dtok_b", "daux")
             + TX.ARG_NAMES[TG.N_DATA:])
    errs = {}
    for F, attention in ((16, "parity"), (FRAMES, "softmax"),
                         (FRAMES, "parity")):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = NMNConfig(
                hidden_size=HIDDEN, video_size=VIDEO_D, text_size=TEXT_D,
                max_video_length=F, object_types=3, max_steps=16,
                num_vec=10, num_frames=6, num_attn=8,
                filter_attention=attention,
                compute_dtype="float32" if dtype == torch.float32
                else "bfloat16")
            model = W.build_model(cfg, seed=4, device=dev)
            batch = W.to_device(W.opcode_batch(
                cfg, W.OPCODE_PROGRAMS * 2, seed=F + 1), dev)
            B, L = batch["question"].shape[:2]
            gen = torch.Generator().manual_seed(F + 1)
            halves = [torch.randn(B, n, HIDDEN // 2, generator=gen)
                      .to(dev, dtype)
                      for n in (F, F, L, L)]
            mods = tree_map(lambda x: x.detach().to(dtype),
                            model.param_tree()["modules"])
            gouts = None
            ftol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 3e-2)
            # The softmax Filter's keyword weights and bias shift every
            # logit of one softmax alike, so their exact gradient is 0 and
            # both sides hold float32 rounding noise: bound their size
            # against the Filter logit weights' gradient instead.
            vanish = ("fltk", "fltb") if attention == "softmax" else ()
            # float32: a ReLU pre-activation within rounding of 0 can take
            # the other side under the kernel's summation order, and its
            # whole cotangent moves (up to ~2e-2 of a gradient at F = 64,
            # H = 512). So the inputs are run three times, as drawn and
            # twice with 1e-4 relative noise, which moves such kinks and
            # leaves a logic error in place: every run within 5e-2, and
            # two of three within 1e-4. bf16: one run within 1e-1.
            runs = 3 if dtype == torch.float32 else 1
            tight, loose = (1e-4, 5e-2) if runs == 3 else (1e-1, 1e-1)
            worsts, fwd_err = [], {}
            for k in range(runs):
                hk = halves if k == 0 else [
                    h * (1 + 1e-4 * torch.randn(
                        h.shape, generator=gen).to(dev, dtype))
                    for h in halves]
                meta, args = TX.prepare_args(
                    cfg, mods, VideoNMN._fused_tables(mods), batch["trace"],
                    hk[:2], batch["video_mask"], hk[2:],
                    batch["question_mask"])
                ref = TX.mega_exec_reference(meta, args, rate=rate, seed=seed)
                if gouts is None:
                    gouts = [torch.randn(r.shape, generator=gen).to(dev)
                             for r in ref]
                rb = TG.mega_exec_bwd_reference(meta, args, ref, gouts, rate,
                                                seed)
                plain = dict(zip(names, rb))
                # float32: the general route alone; bf16: both routes, the
                # tensor-core one first (its worst error is the run's). Each
                # route's forward against the plain version, and its backward
                # handed that forward's files (the walk recomputes its own
                # route's forward values bit for bit)
                for route, _, ctx in MEGA_ROUTES:
                    if route == "tc" and TX.fwd_route(dtype, HIDDEN, F,
                                                      True) != "tc":
                        continue
                    with ctx():
                        _build.reset_launches()
                        out = TX.mega_exec_train_call(meta, args, rate, seed)
                        torch.cuda.synchronize()
                        require(_build.LAUNCHES[TRAIN_KEYS[route]] == 1 and
                                sum(_build.LAUNCHES[key] for key in
                                    TRAIN_KEYS.values()) == 1,
                                f"mega_exec_train {route} route launches "
                                f"{_build.LAUNCHES}")
                        for o, r, what in zip(out, ref, ("regs_vec",
                                                         "regs_frames",
                                                         "regs_attn")):
                            torch.testing.assert_close(
                                o.float(), r.float(), rtol=ftol[0],
                                atol=ftol[1], msg=f"{route} route {what}")
                        fwd_err[route] = max_err(out, ref)
                        kb = TG.mega_exec_bwd_call(meta, args, out, gouts,
                                                   rate, seed)
                        if k == 0:
                            kb2 = TG.mega_exec_bwd_call(meta, args, out,
                                                        gouts, rate, seed)
                            torch.cuda.synchronize()
                            require(all(torch.equal(x, y)
                                        for x, y in zip(kb, kb2)),
                                    f"executor backward ({route} route) is "
                                    "not deterministic")
                    grads = dict(zip(names, kb))
                    ref_scale = max(float(plain["fltw"].float().abs().max()),
                                    1e-12)
                    noise = max((float(t[n].float().abs().max()) / ref_scale
                                 for t in (grads, plain) for n in vanish),
                                default=0.0)
                    require(noise <= 1e-3,
                            f"mega_exec_bwd {route} route {vanish} not ~0: "
                            f"{noise}")
                    bwd = {n: rel_err(grads[n], plain[n]) for n in names
                           if n not in vanish}
                    worst = max(bwd, key=bwd.get)
                    require(bwd[worst] <= loose,
                            f"mega_exec_bwd {route} route F={F} {attention} "
                            f"{dtype} run {k}: bound {loose}: {bwd}")
                    if route == "general" and dtype == torch.bfloat16:
                        general_worst = (bwd[worst], worst)
                        continue
                    worsts.append((bwd[worst], worst))
                    if k == 0:
                        e0 = (fwd_err[route], max_err(kb, rb))
            n_tight = sum(w <= tight for w, _ in worsts)
            require(2 * n_tight > runs,
                    f"mega_exec_bwd F={F} {attention} {dtype}: only "
                    f"{n_tight} of {runs} runs within {tight}: {worsts}")
            errs[(F, attention, str(dtype))] = e0
            routes = ("tensor-core route" if dtype == torch.bfloat16
                      else "general route")
            ferr = ", ".join(f"{r} route {e:.3e}" for r, e in fwd_err.items())
            log(f"[mega_exec train] all {len(W.OPCODE_PROGRAMS)} opcode "
                f"programs x2 H={HIDDEN} F={F} {attention} rate {rate} {dtype}: "
                f"forward max_abs_err {ferr} (rtol {ftol[0]}, atol "
                f"{ftol[1]}); backward ({routes}) over {len(bwd)} gradients "
                f"max rel err per run {[(f'{w:.2e}', n) for w, n in worsts]} "
                f"({n_tight} of {runs} within {tight}, all within {loose})"
                + (f"; general route {general_worst[0]:.2e} at "
                   f"{general_worst[1]}" if dtype == torch.bfloat16 else "")
                + (f"; {'/'.join(vanish)} (0 in exact arithmetic) at "
                   f"{noise:.2e} of the fltw gradient (bound 1e-3)"
                   if vanish else "")
                + "; two backward runs bit-identical ok")
    # The tensor-core walk recomputes the training forward's values with the
    # forward's own product code (walk_gemm, vecmat_tc); each must give the
    # bits of the forward's call at the walk's shapes ([F, H] @ [H, H],
    # [F, H] @ [H, F], and the vec-level product over 1-3 segments), alone
    # and as stage 1's chained pair (the hidden kept as each kernel keeps
    # it).
    gen = torch.Generator().manual_seed(9)
    for i, (M, K, N) in enumerate(((FRAMES, HIDDEN, HIDDEN),
                                   (16, HIDDEN, HIDDEN),
                                   (FRAMES, HIDDEN, FRAMES))):
        for vec in (False, True):
            S = 1 + i   # segments of the vec-level product
            rows = S * K if vec else K
            A = torch.randn(S if vec else M, K, generator=gen).to(
                dev, torch.bfloat16)
            if vec:     # the executor's vectors: float32 holding bf16 values
                A = A.float()
            Bm = (torch.randn(rows, N, generator=gen) / K ** 0.5).to(
                dev, torch.bfloat16)
            for chain in (False, True):
                fwd, walk = TG.recompute_check(A, Bm, vec, chain)
                torch.cuda.synchronize()
                require(torch.equal(fwd, walk),
                        f"walk's recompute != #5's product at M={M} K={K} "
                        f"N={N} vec={vec} chain={chain}: max diff "
                        f"{float((fwd - walk).abs().max())}")
        log(f"[recompute] the walk's products equal #5's bit for bit at "
            f"[{M}, {K}] @ [{K}, {N}] and the vec-level [{S} x {K}] @ "
            f"[{S * K}, {N}], alone and chained ok")
    return errs


def phase_train(dev, card):
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.train.loop import make_train_step, trainer_defaults
    from stair_tpu_torch.train.losses import total_loss
    from stair_tpu_torch.utils.device import cuda_time_ms

    base = W.workload_config(hidden_size=HIDDEN, video_size=VIDEO_D,
                             text_size=TEXT_D, max_video_length=FRAMES)
    cfg = NMNConfig(**{**base.to_dict(), "compute_dtype": "bfloat16",
                       "dropout": 0.25})
    log(f"[train] config {json.dumps(cfg.to_dict())}")
    batch = W.add_fake_supervision(
        W.make_batch(cfg, batch_size=TRAIN_BATCH,
                     question_len=QUESTION_LEN), cfg)
    batch = W.to_device(batch, dev)
    args = trainer_defaults()    # lr 2e-4, schedule 1.0 -> 0.1, window 32
    model = W.build_model(cfg, seed=0, device=dev)

    def grads_of(m, seed):
        m.zero_grad(set_to_none=True)
        loss, _ = total_loss(m, batch, torch.Generator().manual_seed(seed),
                             1.0, 1.0, 1.0, 1.0,
                             contrastive_window=args.contrastive_window)
        loss.backward()
        return float(loss.detach()), {
            k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
            for k, p in m.weights.items()}

    def norm_rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    # ---- one step, kernel route vs plain route ---------------------------
    # Gradients leaf by leaf in float32 (the same weights, batch and
    # dropout masks): in bf16 the two routes round at different sites and
    # ReLUs take different sides, so leaves move by up to ~0.17 (max) and
    # ~0.09 (norm) with no logic at fault. In float32 a ReLU pre-activation
    # within rounding of 0 still moves a leaf by up to ~2e-3 in norm (a
    # logic error moves it by O(1)): bound 1e-2 on ||kernel - plain|| /
    # ||plain|| per leaf. The bf16 step's loss agrees within 1e-4.
    # float32 takes the backward's general route (the exact one)
    keys = tuple(k for k, v in TRAIN_LAUNCHES.items() if v)
    keys32 = tuple(k for k in keys if not k.endswith(("_tc", "_sum"))) + (
        "bilstm", "bilstm_train", "bilstm_bwd", "bilstm_dwh",
        "mega_exec_train", "mega_exec_bwd", "mega_exec_wgrad")
    model32 = W.build_model(NMNConfig(**{**cfg.to_dict(),
                                         "compute_dtype": "float32"}),
                            seed=0, device=dev)
    for m, dtype in ((model32, "float32"), (model, "bfloat16")):
        with kernel_route(keys32 if dtype == "float32" else keys):
            lk, gk = grads_of(m, 7)
        with plain_route():
            lp, gp = grads_of(m, 7)
        require(abs(lk - lp) <= 1e-4 * abs(lp),
                f"{dtype} step loss kernel {lk} vs plain {lp}")
        if dtype == "float32":
            live = [k for k in gk if gp[k].abs().max() > 0]
            rels = {k: norm_rel(gk[k], gp[k]) for k in live}
            worst = sorted(rels.items(), key=lambda kv: -kv[1])[:4]
            mx = max(rel_err(gk[k], gp[k]) for k in live)
            require(worst[0][1] <= 1e-2, f"kernel vs plain gradients {worst}")
            log(f"[train] one step's float32 gradients, kernel vs plain route"
                f" over {len(live)} leaves: worst norm rel err "
                f"{[(k, f'{v:.2e}') for k, v in worst]} (bound 1e-2), median "
                f"{float(np.median(list(rels.values()))):.2e}, max-based "
                f"worst {mx:.2e}; loss {lk:.6f} vs {lp:.6f}")
        else:
            log(f"[train] one bf16 step's loss, kernel vs plain route: "
                f"{lk:.6f} vs {lp:.6f} (bound 1e-4 relative)")
    del model32

    # ---- the counted main-path run: 10 steps on the kernel route --------
    step = make_train_step(model, args)
    step(batch, torch.Generator().manual_seed(100), 1.0, 1.0)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        m = step(batch, torch.Generator().manual_seed(i), 1.0, 1.0)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    losses = [float(x) for x in losses]
    for k, n in TRAIN_LAUNCHES.items():
        require(launches[k] == n * TRAIN_STEPS,
                f"{k} launches {launches[k]} != {n * TRAIN_STEPS}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(np.mean(losses[-3:]) < np.mean(losses[:3]),
            f"loss did not fall: {losses}")
    log(f"[train] {TRAIN_STEPS} steps B={TRAIN_BATCH}: losses "
        f"{[round(x, 4) for x in losses]}; launches {launches}; "
        f"{wall * 1e3 / TRAIN_STEPS:.3f} ms per step (host clock, "
        f"synchronized); card {card}")
    k_ms = cuda_time_ms(lambda: step(batch, torch.Generator().manual_seed(
        200), 1.0, 1.0), iters=5, warmup=1)
    with plain_route():
        p_ms = cuda_time_ms(lambda: step(
            batch, torch.Generator().manual_seed(300), 1.0, 1.0),
            iters=2, warmup=1)
    log(f"[train] ms per step (CUDA events): kernel route {k_ms:.3f}, plain "
        f"route {p_ms:.3f}; card {card}")
    SEEN.update(train_cfg=cfg, train_batch=batch, train_args=args,
                mega_train_ms=k_ms)

    # ---- each training kernel at these shapes, and its plain version ----
    dt = model.compute_dtype
    p = tree_map(lambda x: x.detach(), model.param_tree())
    vargs = TL._prep(p["video_encoder"], batch["video"], batch["video_mask"],
                     dt)
    qargs = TL._prep(p["text_encoder"], batch["question"],
                     batch["question_mask"], dt)
    kv = TL.bilstm_train_call(*vargs, token_dtype=dt)
    kq = TL.bilstm_train_call(*qargs, token_dtype=dt)
    rv_ = TL.bilstm_reference(*vargs, token_dtype=dt, return_stacks=True)
    rq_ = TL.bilstm_reference(*qargs, token_dtype=dt, return_stacks=True)
    e_lt = max(max_err(kv[:3], rv_[:3]), max_err(kq[:3], rq_[:3]))
    gen = torch.Generator().manual_seed(5)

    def cot(a):
        return torch.randn(a.shape, generator=gen).to(dev, a.dtype)

    vcot = (cot(kv[0]), cot(kv[1]), cot(kv[2]))
    qcot = (cot(kq[0]), cot(kq[1]), cot(kq[2]))
    kbv = TL.bilstm_bwd_call(*vargs, kv[3], *vcot)
    rbv = TL.bilstm_bwd_reference(*vargs, kv[3], *vcot)
    kbq = TL.bilstm_bwd_call(*qargs, kq[3], *qcot)
    rbq = TL.bilstm_bwd_reference(*qargs, kq[3], *qcot)
    e_lb = max(max_err(kbv, rbv), max_err(kbq, rbq))

    def general_fwd_ms():
        """The two training-forward calls on the general route."""
        with general_lstm_fwd():
            return cuda_time_ms(
                lambda: (TL.bilstm_train_call(*vargs, token_dtype=dt),
                         TL.bilstm_train_call(*qargs, token_dtype=dt)),
                iters=3)

    def general_bwd_ms():
        """The same two calls on the backward's general route (the
        kernels the cluster route replaced on the main path)."""
        with general_lstm_bwd():
            return cuda_time_ms(
                lambda: (TL.bilstm_bwd_call(*vargs, kv[3], *vcot),
                         TL.bilstm_bwd_call(*qargs, kq[3], *qcot)), iters=3)
    def general_mega_ms(fn):
        """``fn`` on the executor's general routes (the kernels the
        tensor-core routes replaced on the main path)."""
        with general_mega():
            return cuda_time_ms(fn, iters=3)
    r_lb = max(max(rel_err(x, y) for x, y in zip(kbv, rbv)),
               max(rel_err(x, y) for x, y in zip(kbq, rbq)))
    require(e_lt <= 2e-2 and r_lb <= 2e-2,
            f"bilstm train main-path errors {e_lt} {r_lb}")
    mods = tree_map(lambda x: x.to(dt), p["modules"])
    meta, margs = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], kv[:2],
        batch["video_mask"].to(dt), kq[:2], batch["question_mask"])
    seed = (11, 22)
    km = TX.mega_exec_train_call(meta, margs, cfg.dropout, seed)
    rm = TX.mega_exec_reference(meta, margs, rate=cfg.dropout, seed=seed)
    e_mt = max_err(km, rm)
    for o, r in zip(km, rm):
        torch.testing.assert_close(o.float(), r.float(), rtol=1e-2, atol=3e-2)
    mcot = [cot(o) for o in km]
    # The train step hands the backward the kernel forward's register files
    # (km), and the walk reads every register value from them, as the JAX
    # kernel #6 does: its plain version is autograd at those files
    # (at_files), the main-path check, bound 1e-1. The general route is held
    # the same way on its own forward's files (kmg): each route's walk
    # recomputes its own forward's values bit for bit. The kernel handed
    # the plain forward's files (rm) is held to the plain backward through
    # the plain forward, whose files are rm, within the same bound. Printed
    # beside: the kernel on km against the plain backward through the plain
    # forward, and the plain VJP at km against it too; the two read alike
    # when the gap is the forwards' bf16 steps moving a relu's side, not
    # the backward.
    names = ("dvf_a", "dvf_b", "dtok_a", "dtok_b", "daux") + tuple(
        TX.ARG_NAMES[TG.N_DATA:])

    def worst(out, ref):
        rels = sorted(((rel_err(x, y), n) for n, x, y in zip(names, out, ref)),
                      reverse=True)
        return rels[0][0], [(n, f"{r:.3e}") for r, n in rels[:3]]

    rmb = TG.mega_exec_bwd_reference(meta, margs, km, mcot, cfg.dropout,
                                     seed, at_files=True)
    rrb = TG.mega_exec_bwd_reference(meta, margs, rm, mcot, cfg.dropout,
                                     seed)
    kmb = TG.mega_exec_bwd_call(meta, margs, km, mcot, cfg.dropout, seed)
    e_mb = max_err(kmb, rmb)
    r_mb, w_mb = worst(kmb, rmb)
    with general_mega():
        kmg = TX.mega_exec_train_call(meta, margs, cfg.dropout, seed)
        e_mtg = max_err(kmg, rm)
        r_gen, w_gen = worst(TG.mega_exec_bwd_call(
            meta, margs, kmg, mcot, cfg.dropout, seed),
            TG.mega_exec_bwd_reference(meta, margs, kmg, mcot, cfg.dropout,
                                       seed, at_files=True))
    r_rm, w_rm = worst(TG.mega_exec_bwd_call(meta, margs, rm, mcot,
                                             cfg.dropout, seed), rrb)
    r_fwd, w_fwd = worst(kmb, rrb)
    r_pf, w_pf = worst(rmb, rrb)
    log(f"[main-path inputs] bilstm_train max_abs_err {e_lt:.3e}; "
        f"bilstm_bwd max_abs_err {e_lb:.3e} (max rel {r_lb:.2e}); "
        f"mega_exec_train max_abs_err {e_mt:.3e} (general route "
        f"{e_mtg:.3e}); mega_exec_bwd max rel err (bound 1e-1) on the "
        f"kernel forward's files {r_mb:.3e} (max_abs_err {e_mb:.3e}; worst "
        f"{w_mb}), the general route on its forward's files {r_gen:.3e} "
        f"({w_gen}), on the plain forward's files {r_rm:.3e} "
        f"({w_rm}); through the plain forward instead: the kernel on km "
        f"{r_fwd:.3e} ({w_fwd}), the plain VJP at km {r_pf:.3e} ({w_pf})")
    require(r_mb <= 1e-1 and r_gen <= 1e-1,
            f"mega_exec_bwd main-path rel err {r_mb} {w_mb}, general route "
            f"{r_gen} {w_gen} (bound 1e-1)")
    require(r_rm <= 1e-1,
            f"mega_exec_bwd on the plain forward's files rel err {r_rm} "
            f"{w_rm} (bound 1e-1)")
    t = {
        "bilstm_train": cuda_time_ms(
            lambda: (TL.bilstm_train_call(*vargs, token_dtype=dt),
                     TL.bilstm_train_call(*qargs, token_dtype=dt)), iters=5),
        "bilstm_train_general": general_fwd_ms(),
        "bilstm_train_plain": cuda_time_ms(
            lambda: (TL.bilstm_reference(*vargs, token_dtype=dt,
                                         return_stacks=True),
                     TL.bilstm_reference(*qargs, token_dtype=dt,
                                         return_stacks=True)), iters=2),
        "bilstm_bwd": cuda_time_ms(
            lambda: (TL.bilstm_bwd_call(*vargs, kv[3], *vcot),
                     TL.bilstm_bwd_call(*qargs, kq[3], *qcot)), iters=5),
        "bilstm_bwd_general": general_bwd_ms(),
        "bilstm_bwd_plain": cuda_time_ms(
            lambda: (TL.bilstm_bwd_reference(*vargs, kv[3], *vcot),
                     TL.bilstm_bwd_reference(*qargs, kq[3], *qcot)),
            iters=2),
        "mega_exec_train": cuda_time_ms(
            lambda: TX.mega_exec_train_call(meta, margs, cfg.dropout, seed),
            iters=5),
        "mega_exec_train_general": general_mega_ms(
            lambda: TX.mega_exec_train_call(meta, margs, cfg.dropout, seed)),
        "mega_exec_train_plain": cuda_time_ms(
            lambda: TX.mega_exec_reference(meta, margs, rate=cfg.dropout,
                                           seed=seed), iters=2),
        "mega_exec_bwd": cuda_time_ms(
            lambda: TG.mega_exec_bwd_call(meta, margs, km, mcot,
                                          cfg.dropout, seed), iters=3),
        "mega_exec_bwd_general": general_mega_ms(
            lambda: TG.mega_exec_bwd_call(meta, margs, kmg, mcot, cfg.dropout,
                                          seed)),
        "mega_exec_bwd_plain": cuda_time_ms(
            lambda: TG.mega_exec_bwd_reference(meta, margs, km, mcot,
                                               cfg.dropout, seed,
                                               at_files=True),
            iters=1, warmup=1),
    }
    for k, v in t.items():
        log(f"[kernel time] {k}: {v:.3f} ms per call (CUDA events, bf16, "
            f"train-step shapes B={TRAIN_BATCH}); card {card}")
    b_lt = add_bounds(lstm_bound(vargs, kv), lstm_bound(qargs, kq))
    b_lb = add_bounds(lstm_bound(vargs, kbv, 3, (kv[3], vcot)),
                      lstm_bound(qargs, kbq, 3, (kq[3], qcot)))
    lib = [lstm_library_ms(TRAIN_BATCH, L, D, HIDDEN // 2, dev, dt,
                           train=True)
           for L, D in ((FRAMES, VIDEO_D), (QUESTION_LEN, TEXT_D))]
    lib_fwd, lib_bwd = (sum(x[i] for x in lib) for i in (0, 1))
    b_mt = bound(counted_flops(lambda: TX.mega_exec_reference(
        meta, margs, rate=cfg.dropout, seed=seed)),
        tensor_bytes(margs, km), dt)
    b_mb = bound(counted_flops(lambda: TG.mega_exec_bwd_reference(
        meta, margs, km, mcot, cfg.dropout, seed, at_files=True)),
        tensor_bytes(margs, km, mcot, kmb), dt)
    log(f"[bound] bilstm_train {b_lt}, bilstm_bwd {b_lb}, nn.LSTM (full "
        f"length, with its input projection) forward {lib_fwd:.3f} ms / "
        f"backward {lib_bwd:.3f} ms; mega_exec_train {b_mt}; mega_exec_bwd "
        f"{b_mb}; card {card}")
    extra = {"bilstm_train": {**b_lt, "library_ms": lib_fwd},
             "bilstm_bwd": {**b_lb, "library_ms": lib_bwd},
             "mega_exec_train": {**b_mt, "library_ms": None},
             "mega_exec_bwd": {**b_mb, "library_ms": None}}
    return [dict(k, **extra[k["name"]]) for k in [
        {"name": "bilstm_train", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/bilstm.cu",
         "replaces": "stair_tpu/ops/lstm.py:583",
         "launches": launches["bilstm_train_tc"], "max_abs_err": e_lt,
         "ms": t["bilstm_train"], "general_ms": t["bilstm_train_general"],
         "plain_ms": t["bilstm_train_plain"]},
        {"name": "bilstm_bwd", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/bilstm.cu",
         "replaces": "stair_tpu/ops/lstm.py:390",
         "launches": launches["bilstm_bwd_tc"], "max_abs_err": e_lb,
         "ms": t["bilstm_bwd"], "general_ms": t["bilstm_bwd_general"],
         "plain_ms": t["bilstm_bwd_plain"]},
        {"name": "mega_exec_train", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/mega_exec.cu",
         "replaces": "stair_tpu/ops/mega_grad.py:1016",
         "executor_route": "tc",
         "launches": launches["mega_exec_train_tc"], "max_abs_err": e_mt,
         "ms": t["mega_exec_train"],
         "general_ms": t["mega_exec_train_general"],
         "plain_ms": t["mega_exec_train_plain"]},
        {"name": "mega_exec_bwd", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/mega_grad_tc.cu",
         "replaces": "stair_tpu/ops/mega_grad.py:111",
         "executor_route": "tc",
         "launches": launches["mega_exec_bwd_tc"], "max_abs_err": e_mb,
         "ms": t["mega_exec_bwd"], "general_ms": t["mega_exec_bwd_general"],
         "plain_ms": t["mega_exec_bwd_plain"]},
    ]]


def attention_bound(q, k, v, valid_len, prefix_len, causal=True):
    """Attention forward on these inputs: 4 D operations per live (row,
    column) pair and head (two products); q, k and v rows below
    ``valid_len`` read once, out written once."""
    from stair_tpu_torch.ops.attention import attention_mask

    B, H, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    pairs = float(attention_mask(prefix_len, valid_len, Lq, Lkv,
                                 causal).sum())
    rows_q = float(valid_len.clamp(max=Lq).sum())
    rows_kv = float(valid_len.clamp(max=Lkv).sum())
    es = q.element_size()
    nbytes = es * D * (H * rows_q + 2 * Hkv * rows_kv + B * H * Lq)
    return bound(4.0 * D * H * pairs, nbytes, q.dtype)


def phase_attention(dev, card):
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.utils.device import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(9)
    L = 640
    # name, B, H, Hkv, Lq, Lkv, D, prefix_len, valid_len, causal, strided
    cases = [
        ("L640", 4, 32, 32, L, L, 128, [0] * 4, [L, 500, 0, 611], True, 0),
        ("ragged L611", 4, 32, 32, 611, 611, 128, [0] * 4, [611, 300, 1, 64],
         True, 1),
        ("GQA 32/8", 4, 32, 8, L, L, 128, [0, 100, 0, 0], [L, 333, 17, L],
         True, 1),
        ("D64 mixed prefix", 4, 12, 12, 128, 128, 64, [64, 10, 0, 128],
         [128, 100, 70, 128], True, 0),
        ("prefix > valid", 2, 12, 12, 200, 200, 64, [150, 300], [100, 200],
         True, 0),
        ("non-causal Lq != Lkv", 2, 4, 4, 100, 333, 64, [0, 0], [333, 90],
         False, 0),
        ("D40 (scalar kernel)", 2, 3, 3, 77, 91, 40, [5, 0], [91, 60], True,
         0),
        ("valid at query-tile edges", 4, 8, 8, 300, 300, 128,
         [0, 0, 5, 0], [1, 127, 128, 129], True, 1),
    ]
    for name, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal, strided in cases:
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            def draw(heads, n):
                shape = (B, n, heads, D) if strided else (B, heads, n, D)
                x = torch.randn(shape, generator=gen, device=dev).to(dtype)
                return x.transpose(1, 2) if strided else x

            q, k, v = draw(H, Lq), draw(Hkv, Lkv), draw(Hkv, Lkv)
            pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            out, lse = TA.flash_attention(q, k, v, pl, vl, causal=causal,
                                          return_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = TA.reference_attention(q, k, v, pl, vl, causal)
            # all rows: below valid_len the function, at and past it the
            # port's rule (0 and +inf) that kernel and plain version share
            e_out = float((out.float() - ref.float()).abs().max())
            fin = torch.isfinite(ref_lse)
            require(torch.equal(torch.isfinite(lse), fin),
                    f"attention {name} {dtype}: lse +inf pattern differs")
            e_lse = float((lse[fin] - ref_lse[fin]).abs().max()) if bool(
                fin.any()) else 0.0
            require(e_out <= atol and e_lse <= 1e-4,
                    f"attention {name} {dtype}: out {e_out} lse {e_lse}")
            for b, n in enumerate(valid):
                require(float(out[b, :, n:].abs().max()) == 0.0
                        if n < Lq else True,
                        f"attention {name}: padding rows not zero")
            log(f"[flash_attn] {name} B={B} H={H}/{Hkv} L={Lq}/{Lkv} D={D} "
                f"{dtype}: out max_abs_err {e_out:.3e} (atol {atol}), lse "
                f"{e_lse:.3e} (atol 1e-4) ok")

    # ---- time at B 4, H 32, D 128, L 640, bf16 -----------------------------
    q, k, v = (torch.randn(4, L, 32, 128, generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    pl = torch.zeros(4, dtype=torch.int32, device=dev)
    vl = torch.tensor([531, 560, 548, 537], dtype=torch.int32, device=dev)
    mask = TA.attention_mask(pl, vl, L, L)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = graph_ms(lambda: TA.flash_attention(q, k, v, pl, vl))
    plain = cuda_time_ms(lambda: TA.reference_attention(q, k, v, pl, vl),
                         iters=5)
    lib = graph_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    b = attention_bound(q, k, v, vl, pl)
    log(f"[flash_attn] B=4 H=32 L={L} D=128 bf16, valid 531-560: kernel "
        f"{ms:.4f} ms (CUDA graph replay), plain version {plain:.3f} ms, "
        f"scaled_dot_product_attention with the boolean mask {lib:.4f} ms "
        f"(yardstick only), bound {b['bound_ms']:.4f} ms by {b['bound_by']}; "
        f"card {card}")


def phase_videochat(dev, card):
    from stair_tpu_torch.llm import videochat_infer as VI
    from stair_tpu_torch.llm.decoder import DecoderConfig, _norm
    from stair_tpu_torch.llm.video_prefix import (
        VideoPrefixConfig, VideoPrefixLM,
    )
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.testing import videochat as VW
    from stair_tpu_torch.utils.device import cuda_time_ms

    bf16 = torch.bfloat16
    tokenizer = VW.tokenizer()
    frame_sets = VW.frame_sets()

    # ---- full width: Llama-7B + ViT-L/14 -----------------------------------
    t0 = time.perf_counter()
    model = VW.build_model(dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    log(f"[videochat] Llama-7B + CLIP ViT-L/14, {n_par / 1e9:.3f}e9 "
        f"parameters in bf16 made on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    VI.video_chatgpt_infer_batch(
        model, tokenizer, VW.QUESTIONS, [f[:2] for f in frame_sets],
        max_new_tokens=2, temperature=0.0)
    torch.cuda.synchronize()

    # ---- the counted main-path run -----------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    video_tokens = VI.encode_video_batch(model, frame_sets)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    answers = VI.video_chatgpt_infer_batch(
        model, tokenizer, VW.QUESTIONS, frame_sets,
        max_new_tokens=VW.NEW_TOKENS, temperature=0.0,
        video_tokens=video_tokens)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    n_layers = model.config.decoder.num_layers
    require(launches["flash_attn"] == n_layers,
            f"flash_attn launches {launches['flash_attn']} != {n_layers} "
            "for one prefill")
    require(len(answers) == VW.BATCH
            and all(isinstance(a, str) for a in answers), "answers")
    require(video_tokens.shape == (VW.BATCH, 356, 1024)
            and bool(torch.isfinite(video_tokens.float()).all()),
            "video tokens")

    # the same prompt batch again, piece by piece, for the times and checks
    ids, start, plen, _ = VI.build_prompt_batch(
        model, tokenizer, VW.QUESTIONS, max_new_tokens=VW.NEW_TOKENS)
    Lmax = ids.shape[1]
    zeros = torch.zeros(VW.BATCH, dtype=torch.int32, device=dev)
    with torch.no_grad():
        embeds = model.splice_embeds(ids, video_tokens, start)
        hidden, _ = model.decoder.prefill(embeds, zeros, plen)
        last = hidden[torch.arange(VW.BATCH, device=dev), plen.long() - 1]
        logits = model.decoder.logits_from_hidden(last).float()
    require(logits.shape == (VW.BATCH, 32000)
            and bool(torch.isfinite(logits).all()), "non-finite logits")
    prefill_ms = cuda_time_ms(
        lambda: model.decoder.prefill(embeds, zeros, plen), iters=3, warmup=1)
    gen_ms = (t2 - t1) * 1e3
    tok_ms = (gen_ms - prefill_ms) / VW.NEW_TOKENS
    log(f"[videochat] batch {VW.BATCH} x {VW.FRAMES} frames, prompt_len "
        f"{plen.tolist()}, L {Lmax}, {VW.NEW_TOKENS} new tokens, greedy: "
        f"CLIP + pooling {(t1 - t0) * 1e3:.1f} ms (host clock, with the "
        f"resize of {VW.BATCH * VW.FRAMES} frames), prefill {prefill_ms:.1f} "
        f"ms (CUDA events), generation {gen_ms:.1f} ms (host clock, "
        f"synchronized) = {tok_ms:.2f} ms per decoded token, "
        f"{VW.BATCH * VW.NEW_TOKENS / (gen_ms / 1e3):.1f} tokens/s; launches "
        f"{launches['flash_attn']} flash_attn; answers "
        f"{[a[:24] for a in answers]}; card {card}")

    # ---- the kernel on the main path's own q, k, v (layer 0) ---------------
    with torch.no_grad():
        p = model.decoder.param_tree()
        layer = p["layers"][0]
        pos = torch.arange(Lmax, device=dev)[None, :].expand(VW.BATCH, Lmax)
        q, k, v = model.decoder._project_qkv(
            layer, _norm(layer["ln1"], embeds, "rms",
                         model.config.decoder.rms_eps),
            model.decoder._rope_of(pos))
    out, lse = TA.flash_attention(q, k, v, zeros, plen, return_lse=True)
    ref, ref_lse = TA.reference_attention(q, k, v, zeros, plen)
    err = float((out.float() - ref.float()).abs().max())
    fin = torch.isfinite(ref_lse)
    # The model's own v reaches |v| ~ 6, where one bf16 step is 3.1e-2: the
    # bound is atol 2e-2 plus rtol 1e-2 (about two and a half steps).
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=2e-2)
    require(torch.equal(torch.isfinite(lse), fin)
            and float((lse[fin] - ref_lse[fin]).abs().max()) <= 1e-4,
            "flash_attn main-path lse")
    mask = TA.attention_mask(zeros, plen, Lmax, Lmax)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {
        "ms": graph_ms(lambda: TA.flash_attention(q, k, v, zeros, plen)),
        "plain_ms": cuda_time_ms(
            lambda: TA.reference_attention(q, k, v, zeros, plen), iters=5),
        "library_ms": graph_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
    }
    entry = {"name": "flash_attn", "route": "cuda",
             "source": "stair_tpu_torch/ops/csrc/flash_attn.cu",
             "replaces": "stair_tpu/ops/attention.py:73",
             "launches": launches["flash_attn"], "max_abs_err": err, **t,
             **attention_bound(q, k, v, plen, zeros)}
    log(f"[main-path inputs] flash_attn B={VW.BATCH} H=32 L={Lmax} D=128 "
        f"bf16: max_abs_err {err:.3e} (rtol 1e-2, atol 2e-2); {t['ms']:.4f} "
        f"ms, plain {t['plain_ms']:.3f} ms, scaled_dot_product_attention "
        f"{t['library_ms']:.4f} ms (kernel and SDPA by CUDA graph replay), "
        f"bound {entry['bound_ms']:.4f} ms by "
        f"{entry['bound_by']}; card {card}")
    del p, layer, embeds, hidden, q, k, v, out, ref, mask
    torch.cuda.empty_cache()

    # ---- 2 decoder + 2 tower layers: kernel route vs plain route -----------
    # After the final RMSNorm the hidden states have unit RMS (|x| up to
    # ~5, where one bf16 step is 3.1e-2; 3.9e-3 at |x| ~ 1), and the two
    # routes round the attention output at different sites: bounds of about
    # five steps of the largest values (max abs 1.5e-1) and two and a half
    # steps of a typical one (mean abs 1e-2). A masking or indexing fault
    # moves whole rows by O(1).
    small = VW.build_model(dev, 2, 2, seed=1)
    vt = VI.encode_video_batch(small, frame_sets)
    ids, start, plen, _ = VI.build_prompt_batch(
        small, tokenizer, VW.QUESTIONS, max_new_tokens=VW.NEW_TOKENS)

    def prefill():
        with torch.no_grad():
            h, _ = small.decoder.prefill(
                small.splice_embeds(ids, vt, start), zeros, plen)
            last = h[torch.arange(VW.BATCH, device=dev), plen.long() - 1]
            return h.float(), small.decoder.logits_from_hidden(last).argmax(-1)

    with kernel_route(("flash_attn",)):
        hk, tk = prefill()
    with plain_route():
        hp, tp = prefill()
    rows = (torch.arange(ids.shape[1], device=dev)[None, :]
            < plen[:, None])[..., None]
    diff = ((hk - hp).abs() * rows)
    e_max = float(diff.max())
    e_mean = float(diff.sum() / (rows.sum() * hk.shape[-1]))
    same = int((tk == tp).sum())
    require(e_max <= 1.5e-1 and e_mean <= 1e-2,
            f"videochat kernel vs plain hidden states: max {e_max} mean "
            f"{e_mean}")
    require(same >= VW.BATCH - 1,
            f"first greedy token equal on {same} of {VW.BATCH}")
    log(f"[videochat] 2 decoder + 2 tower layers, kernel vs plain route: "
        f"prefill hidden states below prompt_len max_abs_err {e_max:.3e} "
        f"(bound 1.5e-1), mean {e_mean:.3e} (bound 1e-2); first greedy token "
        f"equal on {same} of {VW.BATCH} (bound {VW.BATCH - 1})")
    del small, vt, hk, hp
    torch.cuda.empty_cache()

    # ---- VideoPrefixLM at GPT-2 widths, prefix mask (prefix_len > 0) -------
    # float32: summation order only. bf16: twelve layers of roundings at
    # different sites on unit-variance states whose largest values sit where
    # one bf16 step is 3.1e-2: six steps.
    F, Lt, B = 64, 64, 8
    for dtype, tol in ((torch.float32, 1e-4), (bf16, 2e-1)):
        lm = VideoPrefixLM(
            VideoPrefixConfig(video_size=1024, decoder=DecoderConfig.gpt2(),
                              max_video_length=F, max_text_length=Lt),
            generator=torch.Generator(device=dev).manual_seed(2), device=dev,
            dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(3)
        batch = {
            "video": torch.randn(B, F, 1024, generator=gen, device=dev)
            .to(dtype),
            "video_len": torch.randint(1, F + 1, (B,), generator=gen,
                                       device=dev).int(),
            "token_ids": torch.randint(0, 50257, (B, Lt), generator=gen,
                                       device=dev),
            "text_len": torch.randint(1, Lt + 1, (B,), generator=gen,
                                      device=dev).int(),
        }
        with torch.no_grad():
            with kernel_route(("flash_attn",)):
                _, hk = lm.forward(batch, video_visible=True)
                n_launch = _build.LAUNCHES["flash_attn"]
            with plain_route():
                _, hp = lm.forward(batch, video_visible=True)
        require(n_launch == 12, f"VideoPrefixLM launches {n_launch} != 12")
        total = (batch["video_len"] + batch["text_len"])[:, None]
        rows = (torch.arange(F + Lt, device=dev)[None, :] < total)[..., None]
        e = float(((hk.float() - hp.float()).abs() * rows).max())
        require(e <= tol, f"VideoPrefixLM {dtype} kernel vs plain: {e}")
        log(f"[video_prefix] GPT-2 widths (d 768, 12 heads, 12 layers), "
            f"F={F} + {Lt} text tokens, video visible (prefix_len = "
            f"video_len), {dtype}: hidden states max_abs_err {e:.3e} "
            f"(bound {tol}), 12 flash_attn launches ok")
        del lm
    torch.cuda.empty_cache()
    return [entry], model


def attention_bwd_bounds(q, k, v, valid_len, prefix_len, causal=True):
    """The two backward kernels on these inputs. dQ: three products per
    live (row, column) pair and head (``Q K^T``, ``dO V^T``, ``dS K``), 6 D
    operations; q, O, dO, k, v rows below ``valid_len`` and lse read, dQ
    and di written. dK/dV: four products (the first two again, ``P^T dO``,
    ``dS^T Q``), 8 D operations; q, dO, k, v rows below ``valid_len``, lse
    and di read, dK and dV written."""
    from stair_tpu_torch.ops.attention import attention_mask

    B, H, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    pairs = float(attention_mask(prefix_len, valid_len, Lq, Lkv,
                                 causal).sum())
    rows_q = float(valid_len.clamp(max=Lq).sum())
    rows_kv = float(valid_len.clamp(max=Lkv).sum())
    es = q.element_size()
    reads = es * D * (2 * H * rows_q + 2 * Hkv * rows_kv) + 4 * B * H * Lq
    stat = 4 * B * H * Lq                       # di, written then read
    return (bound(6.0 * D * H * pairs,
                  reads + es * D * H * rows_q + es * D * B * H * Lq + stat,
                  q.dtype),
            bound(8.0 * D * H * pairs,
                  reads + stat + 2 * es * D * B * Hkv * Lkv, q.dtype))


def check_di(TA, q, k, v, out, lse, dout, pl, vl, causal, scale, valid):
    """``di`` as the dQ launch writes it against ``reference_di``: within
    1e-5 of each live row's ``sum |f32(O) f32(dO)|`` (float32 sums in
    another order), exactly 0 on padding rows. Returns the largest
    relative error."""
    args, _, keep = TA._backward_args(q, k, v, out, lse, dout, pl, vl,
                                      causal, scale)
    TA._launch_dq(args, q.device)
    want = TA.reference_di(out, dout, vl)
    scale_ = TA.reference_di(out.float().abs(), dout.float().abs(), vl)
    got = keep["di"]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "di not finite")
    rel = float(((got - want).abs() / scale_.clamp(min=1e-30)).max())
    require(rel <= 1e-5, f"di of the dQ launch: {rel} of its row's scale")
    for b, n in enumerate(valid):
        require(float(got[b, :, n:].abs().sum()) == 0.0,
                "di not 0 on padding rows")
    return rel


def backward_launches(TA, q, k, v, out, lse, dout, pl, vl, causal, scale):
    """CUDA launches (kernels, copies, fills) of one ``_launch_backward``
    call, from ``torch.profiler``'s device events; fails unless they are
    exactly the dQ and the dK/dV kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        TA._launch_backward(q, k, v, out, lse, dout, pl, vl, causal, scale)
        torch.cuda.synchronize()
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA]
    require(len(names) == 2 and "flash_bwd_dq" in names[0]
            and "flash_bwd_dkv" in names[1],
            f"one attention backward launched {names}")
    return len(names)


def phase_attention_bwd(dev, card):
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import attention as TA

    gen = torch.Generator(device=dev).manual_seed(11)
    L = 640
    # name, B, H, Hkv, Lq, Lkv, D, prefix_len, valid_len, causal
    cases = [
        ("causal L640", 4, 32, 32, L, L, 128, [0] * 4, [L, 500, 0, 611], True),
        ("ragged L611", 4, 32, 32, 611, 611, 128, [0] * 4, [611, 300, 1, 64],
         True),
        ("GQA 32/8", 4, 32, 8, L, L, 128, [0, 100, 0, 0], [L, 333, 17, L],
         True),
        ("GQA 8/1 D64", 2, 8, 1, 130, 130, 64, [0, 30], [130, 99], True),
        ("D64 mixed prefix", 4, 12, 12, 128, 128, 64, [64, 10, 0, 128],
         [128, 100, 70, 128], True),
        ("prefix > valid", 2, 12, 12, 200, 200, 64, [150, 300], [100, 200],
         True),
        ("non-causal Lq != Lkv", 2, 4, 4, 100, 333, 64, [0, 0], [333, 90],
         False),
        ("causal Lq != Lkv GQA", 2, 4, 2, 100, 160, 64, [20, 0], [160, 90],
         True),
        ("D32 odd lengths", 2, 3, 3, 77, 77, 32, [5, 0], [77, 60], True),
        ("D40 (scalar kernels)", 2, 3, 3, 77, 91, 40, [5, 0], [91, 60], True),
    ]
    for name, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal in cases:
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            def draw(heads, n):       # [B, L, H, D] seen as [B, H, L, D]
                return torch.randn(B, n, heads, D, generator=gen,
                                   device=dev).to(dtype).transpose(1, 2)

            q, k, v = draw(H, Lq), draw(Hkv, Lkv), draw(Hkv, Lkv)
            dout = torch.randn(B, H, Lq, D + 8, generator=gen,
                               device=dev).to(dtype)[..., :D]
            pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            scale = D ** -0.5
            out, lse = TA.flash_attention(q, k, v, pl, vl, causal=causal,
                                          return_lse=True)
            with kernel_route(("flash_attn_bwd_dq", "flash_attn_bwd_dkv")):
                got = TA._launch_backward(q, k, v, out, lse, dout, pl, vl,
                                          causal, scale)
            again = TA._launch_backward(q, k, v, out, lse, dout, pl, vl,
                                        causal, scale)
            torch.cuda.synchronize()
            _build.reset_launches()
            want = TA.flash_backward_reference(q, k, v, out, lse, dout, pl,
                                               vl, causal, scale)
            require(not any(_build.LAUNCHES.values()),
                    "the plain backward launched a kernel")
            di_err = check_di(TA, q, k, v, out, lse, dout, pl, vl, causal,
                              scale, valid)
            n_launch = backward_launches(TA, q, k, v, out, lse, dout, pl, vl,
                                         causal, scale)
            errs = []
            for g, g2, w, n_rows in zip(got, again, want, (Lq, Lkv, Lkv)):
                require(torch.equal(g, g2),
                        f"attention backward {name} {dtype}: bits differ "
                        "between two launches")
                require(bool(torch.isfinite(g.float()).all()),
                        f"attention backward {name} {dtype}: not finite")
                require(g.transpose(1, 2).is_contiguous(),
                        "gradient not in [B, L, heads, D] memory")
                for b, n in enumerate(valid):
                    require(n >= n_rows
                            or float(g[b, :, n:].float().abs().max()) == 0.0,
                            f"attention backward {name}: padding rows not 0")
                errs.append(float((g.float() - w.float()).abs().max())
                            / max(float(w.float().abs().max()), 1e-30))
            require(max(errs) <= tol,
                    f"attention backward {name} {dtype}: dq/dk/dv {errs}")
            log(f"[flash_attn_bwd] {name} B={B} H={H}/{Hkv} L={Lq}/{Lkv} "
                f"D={D} {dtype}: max|a-b|/max|b| dq {errs[0]:.3e} dk "
                f"{errs[1]:.3e} dv {errs[2]:.3e} (bound {tol}), same bits "
                f"twice, padding rows 0 ok; di from the dQ launch "
                f"{di_err:.3e} of its row's sum |O dO| (bound 1e-5), 0 on "
                f"padding rows; {n_launch} CUDA launches in one backward")


def sft_attention_entries(dev, card, model, batch, launches):
    """Kernels #8 and #9 on the SFT step's own q, k, v (layer 0 of the
    full-width model) and a seeded cotangent: error against the plain
    version, time, bound, and autograd through
    ``scaled_dot_product_attention`` as the yardstick. ``launches`` are the
    counts read after the counted SFT run."""
    from stair_tpu_torch.llm.decoder import _norm
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.utils.device import cuda_time_ms

    B, L = batch["token_ids"].shape
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    vl = batch["valid_len"]
    with torch.no_grad():
        p = model.decoder.param_tree()
        layer = p["layers"][0]
        embeds = model.splice_embeds(batch["token_ids"],
                                     batch["video_tokens"],
                                     batch["splice_start"])
        pos = torch.arange(L, device=dev)[None, :].expand(B, L)
        q, k, v = model.decoder._project_qkv(
            layer, _norm(layer["ln1"], embeds, "rms",
                         model.config.decoder.rms_eps),
            model.decoder._rope_of(pos))
    D = q.shape[-1]
    scale = D ** -0.5
    gen = torch.Generator(device=dev).manual_seed(12)
    dout = torch.randn(B, L, q.shape[1], D, generator=gen, device=dev).to(
        q.dtype).transpose(1, 2)
    out, lse = TA.flash_attention(q, k, v, zeros, vl, return_lse=True)
    got = TA._launch_backward(q, k, v, out, lse, dout, zeros, vl, True, scale)
    want = TA.flash_backward_reference(q, k, v, out, lse, dout, zeros, vl,
                                       True, scale)
    errs = [float((g.float() - w.float()).abs().max()) for g, w in
            zip(got, want)]
    rel = [e / max(float(w.float().abs().max()), 1e-30)
           for e, w in zip(errs, want)]
    require(max(rel) <= 2e-2, f"attention backward on the SFT step's inputs: "
            f"max|a-b|/max|b| {rel}")
    args, _, keep = TA._backward_args(q, k, v, out, lse, dout, zeros, vl,
                                      True, scale)
    mask = TA.attention_mask(zeros, vl, L, L)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        a, b, c = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa(a, b, c, attn_mask=mask).backward(dout)

    def library_forward():
        with torch.no_grad():
            sdpa(q, k, v, attn_mask=mask)

    # the dK/dV launch reads the di that the dQ launch wrote: one dQ launch
    # first, then each kernel and the whole backward by graph replay
    TA._launch_dq(args, dev)
    t = {
        "dq": graph_ms(lambda: TA._launch_dq(args, dev)),
        "dkv": graph_ms(lambda: TA._launch_dkv(args, dev)),
        "whole": graph_ms(
            lambda: TA._launch_backward(q, k, v, out, lse, dout, zeros, vl,
                                        True, scale)),
        "plain": cuda_time_ms(
            lambda: TA.flash_backward_reference(q, k, v, out, lse, dout,
                                                zeros, vl, True, scale),
            iters=3, warmup=1),
        "forward": cuda_time_ms(
            lambda: TA.flash_attention(q, k, v, zeros, vl, return_lse=True),
            iters=30, warmup=3),
    }
    lib = max(graph_ms(library) - graph_ms(library_forward), 0.0)
    b_dq, b_dkv = attention_bwd_bounds(q, k, v, vl, zeros)
    log(f"[main-path inputs] flash_attn backward B={B} H={q.shape[1]} L={L} "
        f"D={D} bf16, valid {vl.tolist()}: max_abs_err dq {errs[0]:.3e} dk "
        f"{errs[1]:.3e} dv {errs[2]:.3e} (max|a-b|/max|b| {max(rel):.3e}, "
        f"bound 2e-2); dQ kernel {t['dq']:.4f} ms (bound "
        f"{b_dq['bound_ms']:.4f} ms by {b_dq['bound_by']}), dK/dV kernel "
        f"{t['dkv']:.4f} ms (bound {b_dkv['bound_ms']:.4f} ms by "
        f"{b_dkv['bound_by']}), the whole backward (both launches, di "
        f"included) {t['whole']:.4f} ms, all three by CUDA-graph replay; "
        f"forward with lse {t['forward']:.4f} ms; plain backward "
        f"{t['plain']:.3f} ms; scaled_dot_product_attention backward "
        f"through autograd (boolean mask, forward + backward less forward, "
        f"by CUDA-graph replay) {lib:.4f} ms for dQ, dK and dV together "
        f"(yardstick only); card {card}")
    # the plain version and the library call compute all three gradients at
    # once: their times stand in both rows
    src = "stair_tpu_torch/ops/csrc/flash_attn_bwd.cu"
    return [
        {"name": "flash_attn_bwd_dq", "route": "cuda", "source": src,
         "replaces": "stair_tpu/ops/attention.py:238",
         "launches": launches["flash_attn_bwd_dq"], "max_abs_err": errs[0],
         "ms": t["dq"], "whole_ms": t["whole"], "plain_ms": t["plain"],
         "library_ms": lib, **b_dq},
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": src,
         "replaces": "stair_tpu/ops/attention.py:292",
         "launches": launches["flash_attn_bwd_dkv"],
         "max_abs_err": max(errs[1:]), "ms": t["dkv"],
         "whole_ms": t["whole"], "plain_ms": t["plain"], "library_ms": lib,
         **b_dkv},
    ]


def phase_sft(dev, card, model):
    import dataclasses

    from stair_tpu_torch.llm import optim as TO
    from stair_tpu_torch.llm import videochat_train as VT
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.testing import videochat as VW

    n_layers = model.config.decoder.num_layers
    batch = VW.sft_batch(seed=0, batch=SFT_BATCH, length=SFT_LEN, device=dev)
    n_targets = int((batch["labels"][:, 1:] >= 0).sum())

    # ---- full width, projector-only: the decoder is frozen in bf16, the
    # projector is tuned in float32; the backward crosses every layer
    for key, p in model.weights.items():
        p.data = p.data.float()
    step = VT.make_sft_step(model, TO.make_adamw(
        VT.trainable_parameters(model, projector_only=True),
        TO.warmup_cosine_decay_schedule(0.0, SFT_LR, 1, 2 * SFT_STEPS),
        weight_decay=0.0))

    def run(steps):
        """``steps`` steps; returns (losses, ms per step after the first,
        peak GiB, launches)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses = [step(batch)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps - 1):
            losses.append(step(batch))
        end.record()
        torch.cuda.synchronize()
        return ([float(x) for x in losses],
                start.elapsed_time(end) / (steps - 1),
                torch.cuda.max_memory_allocated() / 2**30,
                dict(_build.LAUNCHES))

    losses, ms, peak, launches = run(SFT_STEPS)
    require(all(np.isfinite(losses)), f"SFT loss not finite: {losses}")
    # the schedule's first rate is 0: the loss can fall from step 2 on
    require(losses[-1] < losses[1], f"SFT loss does not fall: {losses}")
    for key in ("flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        require(launches[key] == n_layers * SFT_STEPS,
                f"{key}: {launches[key]} launches in {SFT_STEPS} steps of "
                f"{n_layers} layers")
    require(all(p.grad is None for p in model.decoder.parameters()),
            "a frozen decoder parameter got a gradient")
    per_step = {k: v // SFT_STEPS for k, v in launches.items() if v}
    log(f"[sft] Llama-7B bf16, projector-only (float32 projector), batch "
        f"{SFT_BATCH} x {SFT_LEN} tokens, valid_len "
        f"{batch['valid_len'].tolist()}, {n_targets} targets, AdamW peak lr "
        f"{SFT_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{SFT_STEPS} steps on a repeated batch ({[round(x, 4) for x in losses]}); "
        f"{ms:.1f} ms per step (CUDA events), peak memory {peak:.2f} GiB "
        f"without remat; launches per step {per_step}; card {card}")

    model.decoder.config = dataclasses.replace(
        model.decoder.config, remat=True, remat_policy="full")
    r_losses, r_ms, r_peak, r_launches = run(3)
    model.decoder.config = dataclasses.replace(
        model.decoder.config, remat=False)
    require(all(np.isfinite(r_losses)), f"SFT loss with remat: {r_losses}")
    require(r_launches["flash_attn"] == 2 * n_layers * 3
            and r_launches["flash_attn_bwd_dq"] == n_layers * 3
            and r_launches["flash_attn_bwd_dkv"] == n_layers * 3,
            f"launches with remat='full': {r_launches}")
    require(r_peak < peak, "remat='full' did not lower the peak memory")
    log(f"[sft] the same with remat='full': {r_ms:.1f} ms per step, peak "
        f"memory {r_peak:.2f} GiB, {2 * n_layers} flash_attn + {n_layers} + "
        f"{n_layers} backward launches per step (each layer's forward runs "
        f"again in the backward); loss {r_losses[0]:.4f} -> {r_losses[-1]:.4f}")

    return sft_attention_entries(dev, card, model, batch, launches)


def phase_sft_routes(dev):
    """2 decoder layers of full width: every gradient leaf of the kernel
    route against the plain route (autograd through the dense attention) in
    float32, and the bf16 loss of both."""
    from stair_tpu_torch.testing import videochat as VW
    from stair_tpu_torch.weights import flatten_tree

    batch = VW.sft_batch(seed=1, batch=4, length=SFT_LEN, device=dev)
    keys = ("flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    for dtype in (torch.float32, torch.bfloat16):
        small = VW.build_model(dev, 2, 2, seed=1, dtype=dtype)

        def loss_and_grads():
            small.zero_grad(set_to_none=True)
            loss = small.sft_loss(batch)
            loss.backward()
            return float(loss.detach()), {
                k: p.grad.clone() for k, p in
                flatten_tree(small.param_tree()).items()
                if p.grad is not None}

        with kernel_route(keys):
            loss_k, grads_k = loss_and_grads()
        with plain_route():
            loss_p, grads_p = loss_and_grads()
        rel_loss = abs(loss_k - loss_p) / abs(loss_p)
        if dtype == torch.bfloat16:
            # both routes round the attention output to bf16, at different
            # sites; the loss is a mean over some 500 targets
            require(rel_loss <= 5e-3, f"bf16 SFT loss kernel {loss_k} vs "
                    f"plain {loss_p}")
            log(f"[sft] 2 layers of full width, bf16: loss kernel route "
                f"{loss_k:.5f} vs plain route {loss_p:.5f}, relative "
                f"{rel_loss:.3e} (bound 5e-3)")
            continue
        require(grads_k.keys() == grads_p.keys() and len(grads_k) >= 22,
                "the routes gave gradients to different leaves")
        worst = ("", 0.0)
        for key, g in grads_p.items():
            err = float((grads_k[key] - g).norm() / g.norm().clamp(min=1e-30))
            if err > worst[1]:
                worst = (key, err)
        # float32 on both routes: only the order of the sums differs
        require(rel_loss <= 1e-5 and worst[1] <= 1e-3,
                f"float32 SFT routes: loss {rel_loss}, worst leaf {worst}")
        log(f"[sft] 2 layers of full width, float32, batch 4 x {SFT_LEN}: "
            f"loss kernel route {loss_k:.6f} vs plain route {loss_p:.6f}; "
            f"{len(grads_k)} gradient leaves, worst ||kernel - plain|| / "
            f"||plain|| {worst[1]:.3e} at {worst[0]} (bound 1e-3)")
        del grads_k, grads_p
        del small
        torch.cuda.empty_cache()


def phase_trainers(dev):
    """Both trainer CLIs on the card at their defaults, on seeded tiny data
    written to a temporary directory."""
    import argparse
    import shutil
    import tempfile

    from stair_tpu_torch.llm import videochat_infer as VI
    from stair_tpu_torch.llm import videochat_train as VT
    from stair_tpu_torch.llm import with_video_lm as WL
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.testing import videochat as VW

    root = tempfile.mkdtemp(prefix="stair_smoke_")
    try:
        paths = VW.write_tiny_data(root)
        keys = ("flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")

        out = f"{root}/sft"
        with kernel_route(keys):
            loss = VT.main(["--data-path", paths["conv"], "--features-dir",
                            paths["chat_features"], "--output", out,
                            "--num-epochs", "1", "--report-interval", "1"])
            launches = dict(_build.LAUNCHES)
        # 16 conversations, batch 8: 2 steps of 4 layers
        require(np.isfinite(loss) and all(launches[k] == 8 for k in keys),
                f"videochat_train: loss {loss}, launches {launches}")
        model, tok = VI.initialize_model(argparse.Namespace(
            model_path=None, vision_path=None, model_ckpt=out, device=None))
        require(model.decoder.embed.is_cuda
                and model.config.decoder.d_model == 256, "reloaded model")
        with kernel_route(("flash_attn",)):
            answers = VI.video_chatgpt_infer_batch(
                model, tok, VW.QUESTIONS, VW.frame_sets(frames=8),
                max_new_tokens=8)
        require(len(answers) == 4 and all(isinstance(a, str)
                                          for a in answers), "answers")
        log(f"[trainers] videochat_train.main (defaults: d 256, 4 layers, "
            f"head_dim 64, float32, batch 8 x 512), 1 epoch = 2 steps: loss "
            f"{loss:.4f}, launches {({k: launches[k] for k in keys})}; "
            f"videochat_infer --model-ckpt on what it saved answered "
            f"{[a[:16] for a in answers]}")

        common = ["--rgb-path", paths["rgb"], "--train-filename",
                  paths["train"], "--valid-filename", paths["valid"],
                  "--test-filename", paths["test"],
                  "--gpt-filter-result-path", paths["filter"],
                  "--report-interval", "1"]
        for family, extra in (("VideoGPT", []), ("Llama", ["--llm-lora"])):
            out = f"{root}/{family}"
            with kernel_route(keys):
                best = WL.main([*common, "--lm-model", family, "--output",
                                out, "--num-epochs", "1",
                                "--gpt-video-loss-weight", "1", *extra])
                launches = dict(_build.LAUNCHES)
            with kernel_route(("flash_attn",)):
                acc = WL.main([*common, "--func", "test", "--model-ckpt",
                               out])
            require(0.0 <= best <= 1.0 and acc == best,
                    f"with_video_lm {family}: valid {best} test {acc} (the "
                    "same records)")
            log(f"[trainers] with_video_lm.main --lm-model {family} "
                f"{' '.join(extra)} (defaults: d 512, 4 layers, head_dim 64, "
                f"float32) with the video loss (prefix_len > 0), 1 epoch: "
                f"launches {({k: launches[k] for k in keys})}; --func test "
                f"on what it saved: acc {acc:.4f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def slot_files(dev, dtype, gen):
    """The three register files at the training shapes with random values,
    and per file a slot index per example (the scratch slot among them) and
    a value block."""
    B = TRAIN_BATCH
    shapes = {"rv": (B, 25, HIDDEN), "rf": (B, 9, FRAMES, HIDDEN),
              "ra": (B, 11, FRAMES)}
    out = {}
    for name, shape in shapes.items():
        file = torch.randn(shape, generator=gen).to(dev, dtype)
        val = torch.randn(shape[0], *shape[2:], generator=gen).to(dev, dtype)
        idx = torch.randint(0, shape[1], (B,), generator=gen).to(
            dev, torch.int32)
        idx[:4] = shape[1] - 1
        out[name] = (file, idx, val)
    return out


#: the slot calls of one step of the reversible executor, by file
SLOT_CALLS = {"slot_set": ("rv", "rf", "ra", "ra"),
              "slot_zero": ("ra", "ra", "rf", "rv") * 2,
              "slot_add": ("rv", "rv", "rv", "rf", "rf", "ra", "ra")}


def step_adds(dev, dtype, gen):
    """The three register files at the training shapes, and the seven adds
    of one step of the reversible executor on them (``SLOT_CALLS``'s
    files), each with its own slot index per example: vb == va on half the
    examples, vc == va on a quarter, fb == fa and ab == aa on half, as an
    instruction that reads one register twice makes them."""
    files = {n: f for n, (f, _, _) in slot_files(dev, dtype, gen).items()}
    entries = []
    for n in SLOT_CALLS["slot_add"]:
        f = files[n]
        idx = torch.randint(0, f.shape[1], (f.shape[0],), generator=gen).to(
            dev, torch.int32)
        val = torch.randn(f.shape[0], *f.shape[2:], generator=gen).to(
            dev, dtype)
        entries.append((n, idx, val))
    half = TRAIN_BATCH // 2
    for first, later, rows in ((0, 1, half), (0, 2, half // 2),
                               (3, 4, half), (5, 6, half)):
        entries[later][1][:rows] = entries[first][1][:rows]
    return files, entries


def slot_add_bytes(files, entries):
    """Compulsory bytes of the adds: each value block read once, each slot
    the adds touch read and written once however many add to it, and the
    indices."""
    nbytes = 0
    for n, f in files.items():
        mine = [(i, v) for m, i, v in entries if m == n]
        if not mine:
            continue
        slots = torch.unique(torch.stack([
            torch.arange(f.shape[0], device=f.device) * f.shape[1] + i.long()
            for i, _ in mine]))
        per = f[0, 0].numel() * f.element_size()
        nbytes += 2 * per * slots.numel() + sum(
            v.numel() * v.element_size() + i.numel() * i.element_size()
            for i, v in mine)
    return nbytes


def phase_slots(dev, card):
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import regslots as TR
    from stair_tpu_torch.utils.device import cuda_time_ms

    gen = torch.Generator().manual_seed(14)
    ops = {"slot_set": (TR.slot_set, TR.slot_set_reference, True),
           "slot_zero": (TR.slot_zero, TR.slot_zero_reference, False),
           "slot_add": (TR.slot_add, TR.slot_add_reference, True)}
    SEEN["slot_err"] = dict.fromkeys(ops, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        files = slot_files(dev, dtype, gen)
        for key, (kern, plain, takes_val) in ops.items():
            for name, (file, idx, val) in files.items():
                args = (idx, val) if takes_val else (idx,)
                _build.reset_launches()
                got = kern(file.clone(), *args)
                torch.cuda.synchronize()
                require(_build.LAUNCHES[key] == 1, f"{key} did not launch")
                want = plain(file.clone(), *args)
                require(torch.equal(got, want),
                        f"{key} {name} {dtype}: kernel != plain version")
                SEEN["slot_err"][key] = max(SEEN["slot_err"][key], float(
                    (got.float() - want.float()).abs().max()))
                keep = torch.ones(file.shape[:2], dtype=torch.bool,
                                  device=dev)
                keep[torch.arange(file.shape[0], device=dev),
                     idx.long()] = False
                require(torch.equal(got[keep], file[keep]),
                        f"{key} {name} {dtype}: an untouched slot changed")
                require(not torch.equal(got[~keep], file[~keep]),
                        f"{key} {name} {dtype}: the indexed slots kept "
                        "their values")
        log(f"[slots] set / zero / add on rv {tuple(files['rv'][0].shape)}, "
            f"rf {tuple(files['rf'][0].shape)}, ra "
            f"{tuple(files['ra'][0].shape)} {dtype}: equal bits to the plain "
            "versions, untouched slots unchanged ok")
        # the seven adds of a step in one launch, repeated slots included
        base, entries = step_adds(dev, dtype, gen)
        outs = {}
        for how in ("many", "kernel", "plain"):
            fs = {n: f.clone() for n, f in base.items()}
            _build.reset_launches()
            if how == "many":
                TR.slot_add_many((fs[n], i, v) for n, i, v in entries)
            else:
                add = TR.slot_add if how == "kernel" else \
                    TR.slot_add_reference
                for n, i, v in entries:
                    add(fs[n], i, v)
            torch.cuda.synchronize()
            want = {"many": {"slot_add_many": 1},
                    "kernel": {"slot_add": len(entries)}, "plain": {}}[how]
            require({k: v for k, v in _build.LAUNCHES.items() if v} == want,
                    f"slot_add_many check, {how}: {_build.LAUNCHES}")
            outs[how] = fs
        for n, f in base.items():
            require(torch.equal(outs["many"][n], outs["plain"][n])
                    and torch.equal(outs["many"][n], outs["kernel"][n]),
                    f"slot_add_many {n} {dtype}: not the seven adds in turn")
            keep = torch.ones(f.shape[:2], dtype=torch.bool, device=dev)
            for m, i, _ in entries:
                if m == n:
                    keep[torch.arange(f.shape[0], device=dev),
                         i.long()] = False
            require(torch.equal(outs["many"][n][keep], f[keep]),
                    f"slot_add_many {n} {dtype}: an untouched slot changed")
        log(f"[slots] slot_add_many, the {len(entries)} adds of a step in "
            f"one launch (files {'/'.join(SLOT_CALLS['slot_add'])}, vb = va "
            f"on half the examples, vc = va on a quarter, fb = fa and ab = "
            f"aa on half) {dtype}: equal bits to the seven plain adds and to "
            "seven slot_add launches in turn, untouched slots unchanged ok")

    # ---- times at the train step's shapes (bf16), per step of the scan --
    files = slot_files(dev, torch.bfloat16, gen)
    rows = torch.arange(TRAIN_BATCH, device=dev)
    zero = torch.zeros((), dtype=torch.bfloat16, device=dev)

    def library(key, file, idx, val):
        """One PyTorch call that computes the same function."""
        ix = (rows, idx.long())
        if key == "slot_set":
            return file.index_put_(ix, val)
        if key == "slot_zero":
            return file.index_put_(ix, zero)
        return file.index_put_(ix, val, accumulate=True)

    entries = {}
    for key, (kern, plain, takes_val) in ops.items():
        calls = [files[n] for n in SLOT_CALLS[key]]

        def run(fn, with_key=False):
            for file, idx, val in calls:
                a = (idx, val) if takes_val else (idx,)
                fn(key, file, idx, val) if with_key else fn(file, *a)

        ms = cuda_time_ms(lambda: run(kern), iters=20)
        plain_ms = cuda_time_ms(lambda: run(plain), iters=20)
        lib_ms = cuda_time_ms(lambda: run(library, True), iters=20)
        nbytes = 0
        for file, idx, val in calls:
            slot = val.numel() * val.element_size()
            moved = {"slot_set": 2, "slot_zero": 1, "slot_add": 3}[key]
            nbytes += moved * slot + idx.numel() * idx.element_size()
        b = bound(0.0, nbytes, torch.bfloat16)
        entries[key] = {"ms": ms, "plain_ms": plain_ms, **b,
                        "library_ms": lib_ms}
        log(f"[kernel time] {key}: the {len(calls)} calls of one executor "
            f"step (files {'/'.join(SLOT_CALLS[key])}) {ms:.4f} ms, plain "
            f"version {plain_ms:.4f} ms, index_put_ {lib_ms:.4f} ms, bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({nbytes} bytes) "
            f"(CUDA events, bf16, B={TRAIN_BATCH}); card {card}")

    # one launch for the seven adds, beside the seven slot_add launches
    base, adds = step_adds(dev, torch.bfloat16, gen)
    many = [(base[n], i, v) for n, i, v in adds]

    def each(fn):
        for f, i, v in many:
            fn(f, i, v)

    def library():
        for f, i, v in many:
            f.index_put_((rows, i.long()), v, accumulate=True)

    ms = cuda_time_ms(lambda: TR.slot_add_many(many), iters=20)
    seven_ms = cuda_time_ms(lambda: each(TR.slot_add), iters=20)
    plain_ms = cuda_time_ms(lambda: TR.slot_add_many_reference(many),
                            iters=20)
    lib_ms = cuda_time_ms(library, iters=20)
    # the device's own time, without the wrappers' Python between launches
    dev_ms = graph_ms(lambda: TR.slot_add_many(many))
    seven_dev_ms = graph_ms(lambda: each(TR.slot_add))
    nbytes = slot_add_bytes(base, adds)
    b = bound(0.0, nbytes, torch.bfloat16)
    entries["slot_add_many"] = {"ms": ms, "plain_ms": plain_ms, **b,
                                "library_ms": lib_ms, "seven_ms": seven_ms,
                                "graph_ms": dev_ms,
                                "seven_graph_ms": seven_dev_ms}
    log(f"[kernel time] slot_add_many: the {len(many)} adds of one executor "
        f"step in one launch {ms:.4f} ms, the same as {len(many)} slot_add "
        f"launches {seven_ms:.4f} ms (back to back: the wrappers' Python "
        f"paces both); by CUDA-graph replay {dev_ms:.4f} ms and "
        f"{seven_dev_ms:.4f} ms; plain version {plain_ms:.4f} ms, "
        f"{len(many)} index_put_(accumulate=True) {lib_ms:.4f} ms, bound "
        f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({nbytes} bytes: repeated "
        f"slots read and written once) (CUDA events, bf16, B={TRAIN_BATCH}); "
        f"card {card}")
    return entries


def step_bound(args, dtype):
    """One launch of the fused step on these inputs: the products of the
    live tiles (two [F, H] @ [H, H] per live stage 1, one per stage-2
    projection, two [H] @ [H, H] per Localize tile) over the peak rate,
    against every operand row read once (the frames operand, two vec rows,
    the masks and schedule), the weights of each expert present read once,
    and every output written once."""
    from stair_tpu_torch.ops import executor_step as TE

    scal, rv, rf = args[0], args[1], args[2]
    B, _, F, H = rf.shape
    es = rf.element_size()
    e1, e2 = scal[TE.S_E1], scal[TE.S_E2]
    stage1 = e1 != TE.E1_NULL
    proj = (e2 == TE.E2_FF) | (e2 == TE.E2_TEMPORAL)
    writes = proj | (e2 == TE.E2_ATTNVIDEO)
    loc = e1 == TE.E1_LOCALIZE
    n1, n2 = int(stage1.sum()), int(proj.sum())
    flops = 2.0 * F * H * H * (2 * n1 + n2) + 4.0 * H * H * int(loc.sum())
    experts1 = len(torch.unique(e1[stage1]))
    experts2 = len(torch.unique(e2[proj]))
    nbytes = (
        B * (F * H + 2 * H + 2 * F) * es + scal.numel() * 4 + B * 4
        + int((e2 == TE.E2_ATTNVIDEO).sum()) * F * es
        + (experts1 * 2 + experts2 + bool(loc.any())) * (H * H + H) * es
        + int(writes.sum()) * F * H * es
        + B * H * es + 2 * B * F * es + 2 * B * F * 4)
    return bound(flops, nbytes, dtype)


@contextlib.contextmanager
def step_route(route):
    """Send the fused step through ``route`` (``"tc"`` or ``"general"``)
    whatever ``executor_step.step_route`` picks; ``None``: as it picks."""
    from stair_tpu_torch.ops import executor_step as TE

    pick = TE.step_route
    if route is not None:
        TE.step_route = lambda *a: route
    try:
        yield
    finally:
        TE.step_route = pick


#: the fused step's launch key on each route
STEP_KEYS = {"tc": "executor_step_tc", "general": "executor_step"}


def phase_step_kernel(dev):
    """Kernel #10 against its plain version at every step of the all-opcode
    programs: the model runs on the ``"step"`` executor and each call of
    ``fused_step`` is made twice, kernel and plain version, on clones; bf16
    on both routes, float32 on the general one. Returns the launches of the
    float32 forward at F = 64, the general route's own path."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.testing import workload as W

    names = ("rf", "pooled", "hasitem", "existsframe", "loc_a", "loc_b")
    real = TE.fused_step
    general_launches = 0
    for F in (16, FRAMES):
        for dtype, routes in ((torch.float32, ("general",)),
                              (torch.bfloat16, ("tc", "general"))):
            cfg = NMNConfig(
                hidden_size=HIDDEN, video_size=VIDEO_D, text_size=TEXT_D,
                max_video_length=F, object_types=3, max_steps=16,
                num_vec=10, num_frames=6, num_attn=8,
                compute_dtype="float32" if dtype == torch.float32
                else "bfloat16")
            require(TE.step_route(dtype, F, HIDDEN) == routes[0],
                    f"step_route({dtype}, {F}, {HIDDEN})")
            model = W.build_model(cfg, seed=3, device=dev, executor="step")
            batch = W.to_device(W.opcode_batch(
                cfg, W.OPCODE_PROGRAMS * 8, seed=F), dev)
            tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 3e-2)
            for route in routes:
                seen = {"err": 0.0, "e1": set(), "e2": set()}

                def both(*args):
                    want = TE.fused_step_reference(*(a.clone() for a in args))
                    got = real(*args)
                    torch.cuda.synchronize()
                    for g, w, what in zip(got, want, names):
                        torch.testing.assert_close(
                            g.float(), w.float(), rtol=tol[0], atol=tol[1],
                            msg=lambda m: f"executor_step {route} {what}: {m}")
                    seen["err"] = max(seen["err"], max_err(got, want))
                    seen["e1"] |= set(args[0][TE.S_E1].tolist())
                    seen["e2"] |= set(args[0][TE.S_E2].tolist())
                    return got

                TE.fused_step = both
                try:
                    with step_route(None if route == routes[0] else route):
                        _build.reset_launches()
                        out = model(batch)
                        launches = dict(_build.LAUNCHES)
                finally:
                    TE.fused_step = real
                T = batch["trace"]["opcode"].shape[1]
                key = STEP_KEYS[route]
                require(launches[key] == T and all(
                    launches[k] == 0 for k in STEP_KEYS.values() if k != key),
                        f"{key} launches {launches}")
                if dtype == torch.float32 and F == FRAMES:
                    general_launches = launches[key]
                require(seen["e2"] == set(range(5)) and {0, 4, 8, 9, 10}
                        <= seen["e1"], f"families not covered: {seen}")
                require(bool(torch.isfinite(out["logits"]).all()),
                        "non-finite logits on the step route")
                log(f"[executor_step] all {len(W.OPCODE_PROGRAMS)} opcode "
                    f"programs x8 H={HIDDEN} F={F} "
                    f"{'conv' if cfg.conv_temporal else 'linear'}-temporal "
                    f"{dtype} on the {route} route ({key}): {T} steps, every "
                    f"output and the whole frames file, max_abs_err "
                    f"{seen['err']:.3e} (rtol {tol[0]}, atol {tol[1]}), "
                    f"stage-1 experts {sorted(seen['e1'])} ok")
    return general_launches


def phase_step_slice(dev, card, general_launches):
    """The serving path on the scan executor, beside the megakernel route
    of ``phase_slice`` (the same configuration, batches and weights)."""
    from stair_tpu_torch.models.nmn import VideoNMN
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.testing.workload import choose_flips
    from stair_tpu_torch.utils.device import cuda_time_ms

    serving, mega = SEEN["serving"], SEEN["mega_model"]
    cfg = serving.cfg
    model = VideoNMN(cfg, mega.param_tree(), device=dev, executor="step")
    host_batch, device_batch = serving.host_batch, serving.device_batch

    def forward(b):
        return model(b)["logits"]

    hb0 = host_batch(NUM_BATCHES)
    b0 = device_batch(hb0)
    T = b0["trace"]["opcode"].shape[1]
    forward(b0)                                   # warm-up
    torch.cuda.synchronize()

    # ---- the counted main-path run ------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    fetched = [forward(device_batch(host_batch(i))).float().cpu()
               for i in range(STEP_BATCHES)]
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    require(launches["executor_step_tc"] == T * STEP_BATCHES
            and launches["executor_step"] == 0
            and launches["bilstm_tc"] == 2 * STEP_BATCHES
            and launches["bilstm"] == 0 and launches["mega_exec"] == 0
            and launches["mega_exec_tc"] == 0,
            f"step route launches {launches} (T = {T})")
    for lg in fetched:
        require(lg.shape == (BATCH, cfg.answer_vocab_length)
                and bool(torch.isfinite(lg).all()), "step route logits")
    qps = STEP_BATCHES * BATCH / wall
    log(f"[step slice] {STEP_BATCHES} batches x {BATCH} questions on "
        f"executor='step': {qps:.1f} q/s end to end (megakernel route "
        f"{SEEN['mega_qps']:.1f}), launches per batch: executor_step_tc "
        f"{T}, executor_step 0, bilstm_tc 2, bilstm 0, mega_exec_tc 0, "
        f"mega_exec 0; card {card}")

    # ---- against the megakernel route on one batch ------------------------
    with kernel_route(("bilstm_tc", "executor_step_tc")):
        out = model(b0)
    with kernel_route(("bilstm_tc", "mega_exec_tc")):
        ref = mega(b0)
    agree = (out["logits"].argmax(-1) == ref["logits"].argmax(-1)
             ).float().mean().item()
    require(agree >= 0.98, f"step / mega argmax agreement {agree}")
    # Two routes that round to bf16 at the same sites but for one: the
    # Filter head pools the float32 feat tile in the step kernel and the
    # rounded one in the megakernel (as the two TPU kernels do), and the
    # sums run in other orders. So: the executor's bf16 tolerance (atol
    # 3e-2 + rtol 1e-2) on all but 1e-5 of a file's elements, and twice
    # that on every element. Choose is the one module with a hard select:
    # where its two cosines tie within CHOOSE_TIE the routes may keep
    # different keywords, and such an example is held to that and left out.
    flipped, margin = choose_flips(b0["trace"], out["regs_vec"],
                                   ref["regs_vec"])
    n_flipped = int(flipped.sum())
    worst_tie = float(margin[flipped].max()) if n_flipped else 0.0
    require(n_flipped <= BATCH // 200 and worst_tie <= CHOOSE_TIE,
            f"step vs mega: {n_flipped} examples chose another keyword, "
            f"cosines apart by up to {worst_tie:.3e}")
    same = ~flipped
    errs, outside = {}, {}
    for k in ("regs_vec", "regs_frames", "regs_attn"):
        diff = (out[k][same] - ref[k][same]).abs()
        tol = 3e-2 + 1e-2 * ref[k][same].abs()
        outside[k] = int((diff > tol).sum())
        errs[k] = float(diff.max())
        require(outside[k] <= 1e-5 * diff.numel()
                and bool((diff <= 2 * tol).all()),
                f"step vs mega {k}: {outside[k]} of {diff.numel()} elements "
                f"outside the tolerance, worst {float((diff / tol).max()):.2f}"
                " of it")
    require(float(out["regs_frames"][:, cfg.num_frames].abs().max()) == 0.0,
            "the scratch frames slot is not zero")
    dev_ms = cuda_time_ms(lambda: forward(b0), iters=5, warmup=1)
    with plain_route():
        plain = model(b0)["logits"]
        plain_ms = cuda_time_ms(lambda: forward(b0), iters=2, warmup=1)
    p_agree = (plain.argmax(-1) == out["logits"].argmax(-1)
               ).float().mean().item()
    require(p_agree >= 0.98, f"step kernel / plain route agreement {p_agree}")
    log(f"[step slice] vs the megakernel route on one batch: argmax "
        f"agreement {agree:.4f}, logits max_abs_err "
        f"{float((out['logits'] - ref['logits']).abs().max()):.3e}, register "
        f"files max_abs_err {({k: f'{v:.3e}' for k, v in errs.items()})}, "
        f"elements outside atol 3e-2 + rtol 1e-2: {outside} (at most 1e-5 "
        f"of a file, none beyond twice the tolerance; {n_flipped} of "
        f"{int(torch.isfinite(margin).sum())} examples with a Choose kept "
        f"the other keyword, cosines apart by {worst_tie:.3e} <= "
        f"{CHOOSE_TIE}, least gap in the batch {float(margin.min()):.3e}); "
        f"kernel vs plain "
        f"route argmax agreement {p_agree:.4f}")
    log(f"[step slice] device forward per batch of {BATCH} (CUDA events): "
        f"executor='step' {dev_ms:.3f} ms (plain route {plain_ms:.3f} ms), "
        f"megakernel route {SEEN['mega_dev_ms']:.3f} ms; card {card}")

    # ---- the kernel on the main path's own inputs, step by step -----------
    calls = []
    real = TE.fused_step

    def record(*args):
        calls.append(tuple(a.clone() for a in args))
        return real(*args)

    TE.fused_step = record
    try:
        model(b0)
    finally:
        TE.fused_step = real
    require(len(calls) == T, "fused_step calls")
    errs, ms = {}, {}
    for route in STEP_KEYS:
        err = 0.0
        with step_route(route):
            for args in calls:
                _build.reset_launches()
                got = real(*(a.clone() for a in args))
                require(_build.LAUNCHES[STEP_KEYS[route]] == 1,
                        f"{route} route: {_build.LAUNCHES}")
                want = TE.fused_step_reference(*(a.clone() for a in args))
                for g, w in zip(got, want):
                    torch.testing.assert_close(g.float(), w.float(),
                                               rtol=1e-2, atol=3e-2)
                err = max(err, max_err(got, want))
            # timed in place: a repeat rewrites the same frames slots
            ms[route] = cuda_time_ms(lambda: [real(*a) for a in calls],
                                     iters=5)
        errs[route] = err
    plain_ms = cuda_time_ms(
        lambda: [TE.fused_step_reference(*a) for a in calls], iters=2)
    b = add_bounds(*[step_bound(a, model.compute_dtype) for a in calls])
    log(f"[main-path inputs] executor_step over the {T} steps of one batch: "
        f"tensor-core route max_abs_err {errs['tc']:.3e} and {ms['tc']:.3f} "
        f"ms, general route max_abs_err {errs['general']:.3e} and "
        f"{ms['general']:.3f} ms (rtol 1e-2, atol 3e-2); plain version "
        f"{plain_ms:.3f} ms, bound {b} (CUDA events, bf16); card {card}")
    source = "stair_tpu_torch/ops/csrc/executor_step.cu"
    return [
        {"name": "executor_step_tc", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/executor_step.py:49",
         "launches": launches["executor_step_tc"], "max_abs_err": errs["tc"],
         "ms": ms["tc"], "general_ms": ms["general"], "plain_ms": plain_ms,
         **b, "library_ms": None},
        # the general route: timed on the same inputs; its launches are
        # those of its own path, the float32 forward of phase 15
        {"name": "executor_step", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/executor_step.py:49",
         "launches": general_launches, "launches_path": "float32 forward "
         "on executor='step', F 64 (phase 15)",
         "max_abs_err": errs["general"], "ms": ms["general"],
         "plain_ms": plain_ms, **b, "library_ms": None},
    ]


def phase_rev_train(dev, card, slot_entries):
    """The train step on the reversible executor, beside ``phase_train``'s
    (the same configuration, batch and trainer arguments)."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import regslots as TR
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.train.loop import make_train_step
    from stair_tpu_torch.train.losses import total_loss
    from stair_tpu_torch.utils.device import cuda_time_ms

    cfg, batch, args = (SEEN["train_cfg"], SEEN["train_batch"],
                        SEEN["train_args"])
    T = batch["trace"]["opcode"].shape[1]
    want = {**TRAIN_LAUNCHES, "mega_exec_train_tc": 0, "mega_exec_bwd_tc": 0,
            "mega_exec_wgrad_tc": 0, "executor_step": 0,
            "executor_step_tc": 0, "slot_set": 4 * T, "slot_zero": 8 * T,
            "slot_add": 0, "slot_add_many": T}

    # ---- one float32 step: "rev" against "step" under the same seed ------
    cfg32 = NMNConfig(**{**cfg.to_dict(), "compute_dtype": "float32"})
    got = {}
    for executor in ("step", "rev"):
        m = W.build_model(cfg32, seed=0, device=dev, executor=executor)
        _build.reset_launches()
        loss, _ = total_loss(m, batch, torch.Generator().manual_seed(7), 1.0,
                             1.0, 1.0, 1.0,
                             contrastive_window=args.contrastive_window)
        loss.backward()
        torch.cuda.synchronize()
        # a leaf the loss does not reach has no gradient on the autograd
        # route and a zero one on the reversible route
        got[executor] = (float(loss.detach()), {
            k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in m.weights.items()}, dict(_build.LAUNCHES))
        del m
    require(all(got["step"][2][k] == 0 for k in (
        "slot_set", "slot_zero", "slot_add", "slot_add_many",
        "mega_exec_train", "mega_exec_train_tc")),
        f"step route launches {got['step'][2]}")
    ls, lr = got["step"][0], got["rev"][0]
    require(abs(ls - lr) <= 1e-5 * abs(ls), f"rev loss {lr} vs step {ls}")
    worst = max(((rel_err(got["rev"][1][k], g), k)
                 for k, g in got["step"][1].items()
                 if float(g.abs().max()) > 0))
    # the same step function and masks on both routes; the weight
    # cotangents are summed over steps in another order
    require(worst[0] <= 1e-4, f"rev vs step gradients: worst {worst}")
    log(f"[rev train] one float32 step, executor='rev' vs 'step' under one "
        f"seed: loss {lr:.6f} vs {ls:.6f}; {len(got['step'][1])} gradient "
        f"leaves, worst max|a-b|/max|b| {worst[0]:.3e} at {worst[1]} (bound "
        f"1e-4)")
    del got

    # ---- the counted main-path run: 10 steps ------------------------------
    model = W.build_model(cfg, seed=0, device=dev, executor="rev")
    step = make_train_step(model, args)
    # Warm-up, with every slot call of the step made twice: the kernel on
    # the file, the plain version on a copy of it (one copy per file for
    # the adds, whose entries share files).
    plains = {"slot_set": TR.slot_set_reference,
              "slot_zero": TR.slot_zero_reference,
              "slot_add_many": TR.slot_add_many_reference}
    reals = {k: getattr(TR, k) for k in plains}
    slot_err = dict.fromkeys(plains, 0.0)

    def checked(key):
        def call(file, idx, *val):
            want = plains[key](file.clone(), idx, *val)
            got = reals[key](file, idx, *val)
            slot_err[key] = max(slot_err[key], float(
                (got.float() - want.float()).abs().max()))
            return got

        def call_many(entries):
            entries = list(entries)
            copies = {id(f): f.clone() for f, _, _ in entries}
            plains[key]([(copies[id(f)], i, v) for f, i, v in entries])
            got = reals[key](entries)
            for f, _, _ in entries:
                slot_err[key] = max(slot_err[key], float(
                    (f.float() - copies[id(f)].float()).abs().max()))
            return got
        return call_many if key == "slot_add_many" else call

    for k in plains:
        setattr(TR, k, checked(k))
    try:
        step(batch, torch.Generator().manual_seed(100), 1.0, 1.0)
    finally:
        for k, fn in reals.items():
            setattr(TR, k, fn)
    require(all(v == 0.0 for v in slot_err.values()),
            f"slot kernels differ from their plain versions: {slot_err}")
    log(f"[main-path inputs] slot_set / slot_zero / slot_add_many over every "
        f"call of one train step: max_abs_err {slot_err} (equal bits "
        "required) ok")
    torch.cuda.synchronize()
    _build.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        losses.append(step(batch, torch.Generator().manual_seed(i), 1.0,
                           1.0)["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    losses = [float(x) for x in losses]
    for k, n in want.items():
        require(launches[k] == n * TRAIN_STEPS,
                f"{k} launches {launches[k]} != {n * TRAIN_STEPS}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(np.mean(losses[-3:]) < np.mean(losses[:3]),
            f"loss did not fall: {losses}")
    k_ms = cuda_time_ms(lambda: step(batch, torch.Generator().manual_seed(
        200), 1.0, 1.0), iters=3, warmup=1)
    log(f"[rev train] {TRAIN_STEPS} steps B={TRAIN_BATCH} on executor='rev' "
        f"(T = {T}): losses {[round(x, 4) for x in losses]}; launches per "
        f"step: slot_set {4 * T}, slot_zero {8 * T}, slot_add_many {T} (the "
        f"seven adds of a step in one launch), slot_add 0, "
        f"bilstm_train_tc 2, bilstm_bwd_tc 2, no megakernel; "
        f"{wall * 1e3 / TRAIN_STEPS:.3f} ms per step (host clock), "
        f"{k_ms:.3f} ms (CUDA events) beside the megakernel route's "
        f"{SEEN['mega_train_ms']:.3f} ms; card {card}")
    source = "stair_tpu_torch/ops/csrc/regslots.cu"
    return [
        {"name": "slot_set", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:76",
         "launches": launches["slot_set"],
         "max_abs_err": slot_err["slot_set"], **slot_entries["slot_set"]},
        {"name": "slot_zero", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:82",
         "launches": launches["slot_zero"],
         "max_abs_err": slot_err["slot_zero"], **slot_entries["slot_zero"]},
        # the seven adds of a step, now one slot_add_many launch: no
        # slot_add on this path; its time is the seven launches' of phase
        # 14, its error that of its launches there against the plain
        # version (equal bits required)
        {"name": "slot_add", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:87",
         "launches": launches["slot_add"],
         "max_abs_err": SEEN["slot_err"]["slot_add"],
         **slot_entries["slot_add"]},
        {"name": "slot_add_many", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:87",
         "launches": launches["slot_add_many"],
         "max_abs_err": slot_err["slot_add_many"],
         **slot_entries["slot_add_many"]},
    ]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs only on an "
                         "NVIDIA GPU")
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.utils.device import card_identity, exact_f32

    dev = torch.device("cuda", 0)
    card = card_identity().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")
    exact_f32()

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f} s "
        f"({'cached' if _build.BUILD_INFO['cached'] else 'compiled'})")
    report = _build.ptxas_report(_build.BUILD_INFO["log"])
    # the attention backward's and the executor's tensor-core kernels are
    # designed to keep their accumulators and state in registers
    no_spill = ("flash_bwd_dq_mma", "flash_bwd_dkv_mma",
                "mega_exec_tc_kernel<false>", "mega_exec_tc_kernel<true>",
                "mega_bwd_tc_kernel", "mega_wgrad_tc_kernel",
                "executor_step_tc_kernel")
    require(_build.BUILD_INFO["cached"] or all(
        any(r["kernel"].startswith(k) for r in report) for k in no_spill),
        f"the build log names not all of {no_spill}")
    for r in report:
        log(f"[build] ptxas {r['kernel']}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads")
        if r["kernel"].startswith(no_spill):
            require(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                    f"ptxas spills in {r['kernel']}: {r}")

    phase_lstm(dev)
    phase_mega(dev)
    kernels = phase_slice(dev, card)
    phase_lstm_train(dev)
    phase_mega_train(dev)
    kernels += phase_train(dev, card)
    phase_attention(dev, card)
    entries, model = phase_videochat(dev, card)
    kernels += entries
    phase_attention_bwd(dev, card)
    kernels += phase_sft(dev, card, model)
    del model
    torch.cuda.empty_cache()
    phase_sft_routes(dev)
    phase_trainers(dev)
    slot_entries = phase_slots(dev, card)
    general_launches = phase_step_kernel(dev)
    kernels += phase_step_slice(dev, card, general_launches)
    kernels += phase_rev_train(dev, card, slot_entries)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
