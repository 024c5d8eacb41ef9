"""Where the device time of the NMN serving forward, the NMN train step,
Video-ChatGPT serving or the Video-ChatGPT SFT step goes, on one NVIDIA GPU.

    python -m stair_tpu_torch.scripts.profile_slice
        [--train | --videochat | --sft] [--executor mega|step|rev]
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

``--executor`` picks the NMN model's executor for both: ``mega`` (the
default), ``step`` (serving through the per-step kernel) or, with
``--train``, ``rev`` (the reversible executor and the slot kernels) or
``step`` (the grouped stages under autograd).

``--videochat``: Video-ChatGPT serving at full width (Llama-7B + CLIP
ViT-L/14 in bf16, weights from a seed, batch 4, 100 frames of 240 x 320 per
video, 64 new tokens, greedy; ``--layers`` cuts the decoder's depth), as
three parts profiled one after the other: the CLIP tower with resize and
pooling (``encode_video_batch``), the prefill (``Decoder.prefill``: GEMMs,
the attention kernel, eager rope / norm / activation passes) and the whole
generation (``video_chatgpt_infer_batch``: prompt building, splice,
prefill, 64 KV-cache decode steps).

``--sft``: the projector-only SFT step at full width (Llama-7B in bf16,
frozen; the projector in float32; batch 8 x 512 tokens with ragged
``valid_len``; ``videochat_train.make_sft_step``; ``--layers`` cuts the
depth, ``--remat full|dots`` rematerialises the layers): forward, backward
through every layer with the attention forward and backward kernels, one
AdamW update of the projector.

Each part's steps run under ``torch.profiler``; it prints the device time
per step of the heaviest operators (and of every kernel of the port, however
light) and the device's busy share of the wall time (host gaps are the
rest). ``--trace`` writes the Chrome trace (of the
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


#: substrings of the port's own kernels' names: their rows are printed
#: even where they fall below the heaviest operators
PORT_KERNELS = ("bilstm_", "mega_", "flash_", "step_kernel", "_many_kernel")


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


def serving_step(dev, executor):
    """The serving forward of one batch of the bench configuration."""
    serving = W.ServingBatches(dev)
    model = W.build_model(serving.cfg, seed=0, device=dev, executor=executor)
    print(f"serving step: executor {executor!r}")

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


def train_step(dev, executor):
    """One train step of ``scripts/bench_train_step.py``'s configuration."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.train.loop import make_train_step, trainer_defaults

    cfg = NMNConfig(**{**W.workload_config().to_dict(),
                       "compute_dtype": "bfloat16", "dropout": 0.25})
    batch = W.to_device(W.add_fake_supervision(
        W.make_batch(cfg, batch_size=128), cfg), dev)
    model = W.build_model(cfg, seed=0, device=dev, executor=executor)
    update = make_train_step(model, trainer_defaults())
    gen = torch.Generator().manual_seed(0)
    print(f"train step: executor {executor!r}, {cfg.to_dict()}, B = 128")

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


def sft_step(dev, layers, remat):
    """One projector-only SFT step at full width on a seeded batch."""
    import dataclasses

    from stair_tpu_torch.llm import optim as TO
    from stair_tpu_torch.llm import videochat_train as VT
    from stair_tpu_torch.testing import videochat as VW

    model = VW.build_model(dev, decoder_layers=layers, vision_layers=1)
    for p in model.weights.values():
        p.data = p.data.float()
    if remat:
        model.decoder.config = dataclasses.replace(
            model.decoder.config, remat=True, remat_policy=remat)
    batch = VW.sft_batch(device=dev)
    update = VT.make_sft_step(model, TO.make_adamw(
        VT.trainable_parameters(model, projector_only=True),
        lambda step: 3e-4, weight_decay=0.0))
    print(f"sft step: Llama ({layers} layers, d 4096) bf16 frozen, float32 "
          f"projector tuned, batch {tuple(batch['token_ids'].shape)}, "
          f"valid_len {batch['valid_len'].tolist()}, remat {remat or 'off'}")
    return lambda: update(batch).item()


def profile_steps(name, step, n, trace=None, warmup=2, top=24):
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
    shown = [e for e in rows[:top] if e.self_device_time_total > 0]
    shown += [e for e in rows[top:] if e.self_device_time_total > 0
              and any(k in e.key for k in PORT_KERNELS)]
    for e in shown:
        print(f"{e.key[:70]:70s} {e.self_device_time_total / n / 1e3:14.3f} "
              f"{e.count / n:10.1f}")
    busy = busy_ms(prof)
    launches = sum(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.events())
    print(f"device busy {busy:.3f} ms of {wall:.3f} ms wall for {n} steps: "
          f"busy share {busy / wall:.3f}; {launches / n:.0f} device "
          "launches and copies per step")
    if trace:
        prof.export_chrome_trace(trace)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile the NMN train step instead of serving")
    ap.add_argument("--videochat", action="store_true",
                    help="profile Video-ChatGPT serving at full width")
    ap.add_argument("--sft", action="store_true",
                    help="profile the projector-only SFT step at full width")
    ap.add_argument("--executor", choices=["mega", "step", "rev"],
                    default="mega",
                    help="the NMN executor (serving and --train)")
    ap.add_argument("--remat", choices=["full", "dots"], default=None,
                    help="rematerialisation policy for --sft")
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth for --videochat and --sft")
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
    elif args.sft:
        steps = {"SFT step": sft_step(dev, args.layers, args.remat)}
    elif args.train:
        steps = {"train step": train_step(dev, args.executor)}
    else:
        steps = {"serving step": serving_step(dev, args.executor)}
    for name, step in steps.items():
        profile_steps(name, step, args.steps, args.trace,
                      warmup=1 if args.videochat or args.sft else 2)
    if args.sft:
        print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              "GiB (under the profiler)")


if __name__ == "__main__":
    main()
