"""Where the device time of the NMN serving forward, the NMN train step or
Video-ChatGPT serving goes, on one NVIDIA GPU.

    python -m stair_tpu_torch.scripts.profile_slice [--train | --videochat]
        [--steps 3] [--trace PATH]

Serving (the default): builds the bench configuration
(``testing.workload.ServingBatches`` defaults: H = 512, video 1024, text
300, F = 64, 172 answers, bf16, B = 1024, the 128-program pool), times the
host parse/lower/tokenize of a batch, then runs ``--steps`` steady serving
steps (H2D, embedding gather, ``VideoNMN.forward``, logits fetch).

``--train``: the train step at ``scripts/bench_train_step.py``'s
configuration (``workload_config``: H = 512, video 1024, text 300, F = 64,
172 answers, 64 object types; bf16, dropout 0.25, B = 128, fake
supervision, Adam with the trainer's schedule), ``--steps`` steady steps
of ``train.loop.make_train_step`` on one device-resident batch.

``--videochat``: Video-ChatGPT serving at full width (Llama-7B + CLIP
ViT-L/14 in bf16, weights from a seed, batch 4, 100 frames of 240 x 320 per
video, 64 new tokens, greedy; ``--layers`` cuts the decoder's depth), as
three parts profiled one after the other: the CLIP tower with resize and
pooling (``encode_video_batch``), the prefill (``Decoder.prefill``: GEMMs,
the attention kernel, eager rope / norm / activation passes) and the whole
generation (``video_chatgpt_infer_batch``: prompt building, splice,
prefill, 64 KV-cache decode steps).

Each part's steps run under ``torch.profiler``; it prints the device time
per step of the heaviest operators and the device's busy share of the wall
time (host gaps are the rest). ``--trace`` writes the Chrome trace (of the
last part).
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from stair_tpu_torch.ops import _build
from stair_tpu_torch.testing import workload as W
from stair_tpu_torch.utils.device import card_identity, exact_f32


def busy_ms(prof) -> float:
    """Union of the device kernel intervals, in milliseconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for s, t in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e3


def serving_step(dev):
    """The serving forward of one batch of the bench configuration."""
    serving = W.ServingBatches(dev)
    model = W.build_model(serving.cfg, seed=0, device=dev)

    host_ms = []
    for i in range(5):
        t0 = time.perf_counter()
        hb = serving.host_batch(i)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    print("host parse+lower+tokenize ms per batch of "
          f"{serving.batch_size}: {[round(x, 3) for x in host_ms]}")

    def step():
        return model(serving.device_batch(hb))["logits"].float().cpu()

    return step


def train_step(dev):
    """One train step of ``scripts/bench_train_step.py``'s configuration."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.train.loop import make_train_step, trainer_defaults

    cfg = NMNConfig(**{**W.workload_config().to_dict(),
                       "compute_dtype": "bfloat16", "dropout": 0.25})
    batch = W.to_device(W.add_fake_supervision(
        W.make_batch(cfg, batch_size=128), cfg), dev)
    model = W.build_model(cfg, seed=0, device=dev)
    update = make_train_step(model, trainer_defaults())
    gen = torch.Generator().manual_seed(0)
    print(f"train step: {cfg.to_dict()}, B = 128")

    def step():
        return update(batch, gen, 1.0, 1.0)["loss"].item()

    return step


def videochat_steps(dev, layers):
    """The three parts of one Video-ChatGPT serving batch at full width."""
    from stair_tpu_torch.llm import videochat_infer as VI
    from stair_tpu_torch.testing import videochat as VW

    questions, tokenizer, frames = VW.QUESTIONS, VW.tokenizer(), VW.frame_sets()
    model = VW.build_model(dev, decoder_layers=layers)
    new_tokens = VW.NEW_TOKENS
    video_tokens = VI.encode_video_batch(model, frames)
    ids, start, plen, _ = VI.build_prompt_batch(
        model, tokenizer, questions, max_new_tokens=new_tokens)
    with torch.no_grad():
        embeds = model.splice_embeds(ids, video_tokens, start)
    zeros = torch.zeros(len(questions), dtype=torch.int32, device=dev)
    print(f"videochat: Llama ({layers} layers, d 4096) + CLIP ViT-L/14, "
          f"bf16, batch {len(questions)}, prompt_len {plen.tolist()}, "
          f"L {ids.shape[1]}, {new_tokens} new tokens")
    return {
        "CLIP tower + resize + pooling (encode_video_batch)":
            lambda: VI.encode_video_batch(model, frames),
        "prefill (Decoder.prefill)":
            lambda: model.decoder.prefill(embeds, zeros, plen),
        f"generation (prefill + {new_tokens} decode steps)":
            lambda: VI.video_chatgpt_infer_batch(
                model, tokenizer, questions, frames,
                max_new_tokens=new_tokens, temperature=0.0,
                video_tokens=video_tokens),
    }


def profile_steps(name, step, n, trace=None, warmup=2, top=20):
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(prof.key_averages(),
                  key=lambda e: e.self_device_time_total, reverse=True)
    print(f"== {name}")
    print(f"{'operator':70s} {'device ms/step':>14s} {'calls/step':>10s}")
    for e in rows[:top]:
        if e.self_device_time_total <= 0:
            break
        print(f"{e.key[:70]:70s} {e.self_device_time_total / n / 1e3:14.3f} "
              f"{e.count / n:10.1f}")
    busy = busy_ms(prof)
    print(f"device busy {busy:.3f} ms of {wall:.3f} ms wall for {n} steps: "
          f"busy share {busy / wall:.3f}")
    if trace:
        prof.export_chrome_trace(trace)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile the NMN train step instead of serving")
    ap.add_argument("--videochat", action="store_true",
                    help="profile Video-ChatGPT serving at full width")
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth for --videochat")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    dev = torch.device("cuda", 0)
    print(card_identity().splitlines()[0])
    exact_f32()
    _build.build()
    if args.videochat:
        steps = videochat_steps(dev, args.layers)
    elif args.train:
        steps = {"train step": train_step(dev)}
    else:
        steps = {"serving step": serving_step(dev)}
    for name, step in steps.items():
        profile_steps(name, step, args.steps, args.trace,
                      warmup=1 if args.videochat else 2)


if __name__ == "__main__":
    main()
