#!/usr/bin/env python3
"""Drive the PyTorch port's serving forward on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device: refuse to run without CUDA; print the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. build: compile the CUDA kernels from ``stair_tpu_torch/ops/csrc``;
3. BiLSTM kernel vs its plain version at the slice's shapes (B = 1024,
   h = 256; video L = 64 / D = 1024, question L = 16 / D = 300), with
   non-suffix masks and an all-padding row, float32 and bf16;
4. executor kernel vs its plain version over the all-opcode program set at
   H = 512, both Filter modes and both temporal modes (F = 16 linear,
   F = 64 conv), float32 and bf16;
5. the slice end to end at the bench configuration (H = 512, video 1024,
   text 300, F = 64, 172 answers, bf16, B = 1024, the 128-program pool):
   native parse/lower with span linking, tokenization to ids, pinned H2D,
   device embedding gather, ``VideoNMN.forward``, logits fetch — for a few
   batches, with launch counters proving both kernels ran, and kernel vs
   plain route on one batch.

The last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. Every time printed is measured in this
run, on the card named above it.
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


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def plain_route():
    """Route the model's two kernel calls to their plain PyTorch versions
    (on the same CUDA tensors) for a comparison run; fails if a kernel was
    launched inside it all the same."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX

    saved = TL.bilstm, TX.mega_exec_call
    TL.bilstm, TX.mega_exec_call = TL.bilstm_reference, \
        TX.mega_exec_reference
    _build.reset_launches()
    try:
        yield
    finally:
        TL.bilstm, TX.mega_exec_call = saved
    require(not any(_build.LAUNCHES.values()),
            f"the plain route launched kernels: {_build.LAUNCHES}")


@contextlib.contextmanager
def kernel_route():
    """Fail unless every kernel was launched inside the block."""
    from stair_tpu_torch.ops import _build

    _build.reset_launches()
    yield
    require(all(_build.LAUNCHES.values()),
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


def phase_lstm(dev):
    from stair_tpu_torch.ops import lstm as TL

    gen = torch.Generator().manual_seed(0)
    errs = {}
    for name, L, D in (("video", 64, 1024), ("question", 16, 300)):
        for dtype, tol in ((torch.float32, (1e-4, 1e-4)),
                           (torch.bfloat16, (0.0, 2e-2))):
            args = lstm_inputs(gen, dev, BATCH, L, D, 256, dtype)
            out = TL.bilstm(*args, token_dtype=dtype)
            torch.cuda.synchronize()
            ref = TL.bilstm_reference(*args, token_dtype=dtype)
            for o, r, what in zip(out, ref, ("tok_f", "tok_b", "sent")):
                torch.testing.assert_close(o.float(), r.float(), rtol=tol[0],
                                           atol=tol[1], msg=what)
            require(out[0][5].abs().max().item() == 0.0,
                    "all-padding row has nonzero tokens")
            e = max_err(out, ref)
            errs[(name, str(dtype))] = e
            log(f"[lstm] {name} B={BATCH} L={L} D={D} h=256 {dtype}: "
                f"max_abs_err {e:.3e} (rtol {tol[0]}, atol {tol[1]}) ok")
    return errs


def phase_mega(dev):
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
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
            mods = tree_map(lambda x: x.to(dtype),
                            model.param_tree()["modules"])
            meta, args = TX.prepare_args(
                cfg, mods, VideoNMN._fused_tables(mods), batch["trace"],
                halves[:2], batch["video_mask"], halves[2:],
                batch["question_mask"])
            out = TX.mega_exec_call(meta, args)
            torch.cuda.synchronize()
            ref = TX.mega_exec_reference(meta, args)
            if dtype == torch.float32:
                tol = (1e-4, 1e-4)
            else:
                # a bf16 step is 2^-7 to 2^-8 of the value (0.0625 in
                # [8, 16)), so rtol 1e-2 allows about 1.3 to 2.6 steps; the
                # float32 check at 1e-4 is what catches logic errors
                tol = (1e-2, 3e-2)
            for o, r, what in zip(out, ref, ("regs_vec", "regs_frames",
                                             "regs_attn")):
                torch.testing.assert_close(o.float(), r.float(), rtol=tol[0],
                                           atol=tol[1], msg=what)
            agree = np.mean([
                (o.float().argmax(-1) == r.float().argmax(-1)).float()
                .mean().item() for o, r in zip(out, ref)])
            if dtype == torch.bfloat16:
                require(agree >= 0.98, f"register argmax agreement {agree}")
            e = max_err(out, ref)
            errs[(F, attention, str(dtype))] = e
            log(f"[mega_exec] all {len(W.OPCODE_PROGRAMS)} opcode programs "
                f"x8 H=512 F={F} {attention} "
                f"{'conv' if cfg.conv_temporal else 'linear'}-temporal "
                f"{dtype}: max_abs_err {e:.3e}, row argmax agreement "
                f"{agree:.4f} (rtol {tol[0]}, atol {tol[1]}) ok")
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
    require(launches["bilstm"] == 2 * NUM_BATCHES,
            f"bilstm launches {launches['bilstm']} != {2 * NUM_BATCHES}")
    require(launches["mega_exec"] == NUM_BATCHES,
            f"mega_exec launches {launches['mega_exec']} != {NUM_BATCHES}")
    for lg in fetched:
        require(lg.shape == (BATCH, cfg.answer_vocab_length), "logits shape")
        require(bool(torch.isfinite(lg).all()), "non-finite logits")
    qps = NUM_BATCHES * BATCH / wall
    log(f"[slice] {NUM_BATCHES} batches x {BATCH} questions: {qps:.1f} q/s "
        f"end to end (host parse/lower/tokenize {host_s * 1e3:.1f} ms total, "
        f"sequential with the device), launches {launches}; card {card}")

    # ---- kernel route vs plain route on one batch -------------------------
    b0 = device_batch(hb0)
    with kernel_route():
        kern = forward(b0).float()
    with plain_route():
        plain = forward(b0).float()
    torch.cuda.synchronize()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    require(agree >= 0.98, f"kernel/plain argmax agreement {agree}")
    with kernel_route():
        dev_ms = cuda_time_ms(lambda: forward(b0), iters=5, warmup=1)
    with plain_route():
        plain_dev_ms = cuda_time_ms(lambda: forward(b0), iters=3, warmup=1)
    log(f"[slice] kernel vs plain route argmax agreement {agree:.4f}; "
        f"logits max_abs_err {float((kern - plain).abs().max()):.3e}")
    log(f"[slice] device forward per batch of {BATCH} (CUDA events): "
        f"kernel route {dev_ms:.3f} ms, plain route {plain_dev_ms:.3f} ms; "
        f"card {card}")

    # ---- each kernel on the main path's own inputs ----------------------
    dt = model.compute_dtype
    p = model.param_tree()
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
    km = TX.mega_exec_call(meta, args)
    rm = TX.mega_exec_reference(meta, args)
    mega_err = max_err(km, rm)
    for o, r in zip(km, rm):
        torch.testing.assert_close(o.float(), r.float(), rtol=1e-2, atol=3e-2)
    log(f"[main-path inputs] bilstm max_abs_err {lstm_err:.3e} (atol 2e-2); "
        f"mega_exec max_abs_err {mega_err:.3e} (rtol 1e-2, atol 3e-2) ok")

    t = {
        "bilstm_video": cuda_time_ms(lambda: TL.bilstm(*vargs,
                                                       token_dtype=dt)),
        "bilstm_question": cuda_time_ms(lambda: TL.bilstm(*qargs,
                                                          token_dtype=dt)),
        "bilstm_video_plain": cuda_time_ms(
            lambda: TL.bilstm_reference(*vargs, token_dtype=dt), iters=3),
        "bilstm_question_plain": cuda_time_ms(
            lambda: TL.bilstm_reference(*qargs, token_dtype=dt), iters=3),
        "mega_exec": cuda_time_ms(lambda: TX.mega_exec_call(meta, args),
                                  iters=5),
        "mega_exec_plain": cuda_time_ms(
            lambda: TX.mega_exec_reference(meta, args), iters=3),
    }
    for k, v in t.items():
        log(f"[kernel time] {k}: {v:.3f} ms per call (CUDA events, bf16, "
            f"main-path shapes); card {card}")
    return [
        {"name": "bilstm", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/bilstm.cu",
         "replaces": "stair_tpu/ops/lstm.py:136",
         "launches": launches["bilstm"], "max_abs_err": lstm_err,
         "ms": t["bilstm_video"] + t["bilstm_question"],
         "plain_ms": t["bilstm_video_plain"] + t["bilstm_question_plain"]},
        {"name": "mega_exec", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/mega_exec.cu",
         "replaces": "stair_tpu/ops/mega_exec.py:123",
         "launches": launches["mega_exec"], "max_abs_err": mega_err,
         "ms": t["mega_exec"], "plain_ms": t["mega_exec_plain"]},
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
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    phase_lstm(dev)
    phase_mega(dev)
    kernels = phase_slice(dev, card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
