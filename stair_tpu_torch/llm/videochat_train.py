"""Video-ChatGPT SFT trainer: conversation data + video features -> tuned LM
(port of ``stair_tpu/llm/videochat_train.py``).

    python -m stair_tpu_torch.llm.videochat_train --data-path conv.json \\
        --features-dir feats --output out [--tune-mm-projector-only]

LLaVA-format conversation JSON, ``<video>`` placeholders expanded to the
patch-token block, labels masked to assistant replies only (token spans are
recorded while the prompt is assembled), precomputed spatio-temporal video
features (``<features-dir>/<video>.npy``) spliced through ``mm_projector``.
AdamW without weight decay under a warmup-cosine schedule (3% warmup), as
``optax`` steps it (``llm/optim.py``). ``--tune-mm-projector-only`` freezes
everything but the projector (``requires_grad_(False)``; the optimizer
holds the projector alone) and saves the projector alone. The attention of
every layer runs forward and backward through ``ops.attention``'s kernels.

Runs on the first CUDA device unless ``--device cpu`` is given.
``--model-path`` is a local directory with a HF tokenizer; nothing is
downloaded. Without it a word-level tokenizer is built from the data.
The output directory holds ``params.msgpack`` (the JAX package's format,
``train/checkpoint.py``), ``config.json`` and ``tokenizer.json``;
``videochat_infer --model-ckpt`` loads it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from stair_tpu_torch.llm.clip import ClipVisionConfig
from stair_tpu_torch.llm.conversation import conv_templates
from stair_tpu_torch.llm.decoder import DecoderConfig
from stair_tpu_torch.llm.optim import (
    make_adamw,
    make_step,
    warmup_cosine_decay_schedule,
)
from stair_tpu_torch.llm.video_prefix import SimpleTokenizer
from stair_tpu_torch.llm.videochat import (
    DEFAULT_VIDEO_TOKEN,
    VideoChatConfig,
    VideoChatModel,
)
from stair_tpu_torch.runtime.loader import device_prefetch
from stair_tpu_torch.train.checkpoint import save_params
from stair_tpu_torch.utils.device import pick_device

IGNORE = -1


def build_example(sample, tokenizer, conv_mode, video_token_len, max_len):
    """One conversation record -> (token_ids, labels, splice_start, valid).

    Assistant-reply token spans get labels; everything else is IGNORE.
    """
    conv = conv_templates[conv_mode].copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    msgs = sample["conversations"]
    if roles.get(msgs[0]["from"]) != conv.roles[0]:
        msgs = msgs[1:]

    segments = []  # (text, is_reply)
    sep = [conv.sep, conv.sep2]
    segments.append((conv.system + sep[0], False))
    for j, msg in enumerate(msgs):
        role = roles[msg["from"]]
        text = msg["value"]
        is_reply = role == conv.roles[1]
        segments.append((role + ": ", False))
        segments.append((text + sep[j % 2], is_reply))

    token_ids, labels = [], []
    splice_start = None
    for text, is_reply in segments:
        if DEFAULT_VIDEO_TOKEN in text:
            pre, _, post = text.partition(DEFAULT_VIDEO_TOKEN)
            pre_ids = list(tokenizer.encode(pre)) if pre.strip() else []
            post_ids = list(tokenizer.encode(post)) if post.strip() else []
            token_ids.extend(pre_ids)
            splice_start = len(token_ids)
            token_ids.extend([0] * video_token_len)
            token_ids.extend(post_ids)
            labels.extend([IGNORE] * (len(pre_ids) + video_token_len
                                      + len(post_ids)))
            continue
        ids = list(tokenizer.encode(text))
        token_ids.extend(ids)
        labels.extend(ids if is_reply else [IGNORE] * len(ids))

    token_ids = token_ids[:max_len]
    labels = labels[:max_len]
    pad = max_len - len(token_ids)
    valid = len(token_ids)
    token_ids = token_ids + [0] * pad
    labels = labels + [IGNORE] * pad
    return (
        np.asarray(token_ids, np.int32),
        np.asarray(labels, np.int32),
        splice_start if splice_start is not None else 0,
        valid,
    )


class SFTData:
    def __init__(self, data_path, features_dir, tokenizer, conv_mode,
                 video_token_len, vision_dim, max_len):
        with open(data_path) as f:
            self.samples = json.load(f)
        self.features_dir = features_dir
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self.video_token_len = video_token_len
        self.vision_dim = vision_dim
        self.max_len = max_len

    def __len__(self):
        return len(self.samples)

    def batches(self, batch_size, shuffle=True, seed=0):
        order = np.arange(len(self.samples))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            tok = np.zeros((batch_size, self.max_len), np.int32)
            lab = np.full((batch_size, self.max_len), IGNORE, np.int32)
            vid = np.zeros(
                (batch_size, self.video_token_len, self.vision_dim),
                np.float32,
            )
            start = np.zeros((batch_size,), np.int32)
            valid = np.zeros((batch_size,), np.int32)
            for b, j in enumerate(idx):
                s = self.samples[j]
                tok[b], lab[b], start[b], valid[b] = build_example(
                    s, self.tokenizer, self.conv_mode,
                    self.video_token_len, self.max_len,
                )
                vname = s.get("video", s.get("id", "")) or ""
                feat_path = os.path.join(
                    self.features_dir, os.path.splitext(vname)[0] + ".npy"
                )
                if os.path.exists(feat_path):
                    f = np.load(feat_path)[: self.video_token_len]
                    vid[b, : len(f)] = f
            yield {
                "token_ids": tok, "labels": lab, "video_tokens": vid,
                "splice_start": start, "valid_len": valid,
            }


def trainable_parameters(model, projector_only):
    """Freeze what the recipe does not tune and return the parameters the
    optimizer holds: the projector alone, or every parameter."""
    if not projector_only:
        return list(model.parameters())
    for p in model.parameters():
        p.requires_grad_(False)
    tuned = [p for k, p in model.weights.items()
             if k.startswith("mm_projector/")]
    for p in tuned:
        p.requires_grad_(True)
    return tuned


def make_sft_step(model, optimizer):
    """``step(batch) -> loss`` for ``model.sft_loss``: backward through
    every decoder layer (the attention backward kernels on the card), one
    AdamW update of the parameters ``optimizer`` (``optim.make_adamw``'s
    pair) holds. ``batch`` is a dict of tensors on the model's device."""
    return make_step(model.sft_loss, optimizer)


def train(args):
    device = pick_device(args.device)
    if args.model_path:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_path,
                                                  local_files_only=True)
    else:
        with open(args.data_path) as f:
            texts = [
                m["value"] for s in json.load(f)
                for m in s["conversations"]
            ]
        tokenizer = SimpleTokenizer.build(texts)

    dec = DecoderConfig.llama(
        vocab_size=max(len(tokenizer), 64), d_model=args.hidden_size,
        num_heads=max(2, args.hidden_size // 64), num_layers=args.lm_layers,
        d_ff=args.hidden_size * 3, max_len=args.max_len,
    )
    vis = ClipVisionConfig(
        image_size=args.vision_image_size, patch_size=14,
        d_model=args.vision_dim, num_heads=4, num_layers=2,
        d_ff=args.vision_dim * 4,
    )
    cfg = VideoChatConfig(decoder=dec, vision=vis,
                          max_temporal=args.max_temporal)
    model = VideoChatModel(
        cfg, generator=torch.Generator().manual_seed(args.seed)).to(device)

    data = SFTData(
        args.data_path, args.features_dir, tokenizer, args.conv_mode,
        cfg.video_token_len, args.vision_dim, args.max_len,
    )
    steps_total = max(1, (len(data) // args.batch_size) * args.num_epochs)
    schedule = warmup_cosine_decay_schedule(
        0.0, args.lr, max(1, int(0.03 * steps_total)), steps_total
    )
    params = trainable_parameters(model, args.tune_mm_projector_only)
    step = make_sft_step(model, make_adamw(params, schedule,
                                           weight_decay=0.0))

    os.makedirs(args.output, exist_ok=True)
    it, t0 = 0, time.time()
    loss = torch.zeros(())
    for epoch in range(args.num_epochs):
        for dbatch in device_prefetch(
            data.batches(args.batch_size, seed=args.seed + epoch), device
        ):
            loss = step(dbatch)
            it += 1
            if it % args.report_interval == 0:
                print(f"it {it}/{steps_total} loss {float(loss):.4f} "
                      f"({it / (time.time() - t0):.2f} it/s)")
    save(args.output, model, tokenizer,
         projector_only=args.tune_mm_projector_only)
    print("saved to", args.output)
    return float(loss)


def save(out_dir, model, tokenizer, projector_only=False):
    """``params.msgpack`` (the whole tree, or ``{"mm_projector"}`` alone),
    ``config.json`` (the JAX package's keys, plus the decoder and vision
    configs so that ``videochat_infer --model-ckpt`` can rebuild the model)
    and ``tokenizer.json`` for a word-level tokenizer."""
    cfg = model.config
    params = model.param_tree()
    save_params(out_dir, {"mm_projector": params["mm_projector"]}
                if projector_only else params)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "video_token_len": cfg.video_token_len,
            "max_temporal": cfg.max_temporal,
            "d_model": cfg.decoder.d_model,
            "vision_dim": cfg.vision.d_model,
            "projector_only": projector_only,
            "decoder": cfg.decoder.to_dict(),
            "vision": cfg.vision.to_dict(),
        }, f)
    if hasattr(tokenizer, "word2id"):
        with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
            json.dump({"word2id": tokenizer.word2id,
                       "eos": tokenizer.eos_token_id,
                       "pad": tokenizer.pad_token_id}, f)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-path", required=True)
    p.add_argument("--features-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model-path", default=None)
    p.add_argument("--conv-mode", default="video-chatgpt_v1")
    p.add_argument("--hidden-size", type=int, default=256)
    p.add_argument("--lm-layers", type=int, default=4)
    p.add_argument("--vision-dim", type=int, default=64)
    p.add_argument("--vision-image-size", type=int, default=56)
    p.add_argument("--max-temporal", type=int, default=100)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--report-interval", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tune-mm-projector-only", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; fails without one "
                        "unless 'cpu' is given)")
    return train(p.parse_args(argv))


if __name__ == "__main__":
    main()
