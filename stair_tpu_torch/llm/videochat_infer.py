"""Video-ChatGPT inference + zero-shot QA evaluation CLI (port of
``stair_tpu/llm/videochat_infer.py``).

    python -m stair_tpu_torch.llm.videochat_infer --video-dir D \\
        --gt-file samples.json --output-dir out [--consistency]

Load model weights, decode each sample's video, build the conversation
prompt with the ``<vid_start><vid_patch>*N<vid_end>`` block, splice CLIP
spatio-temporal features, sample an answer (T = 0.2) and write the
predictions JSON. Runs batched: prompts are padded per batch and the whole
batch generates in one prefill + decode loop. Runs on the first CUDA
device unless ``--device cpu`` is given.

Air-gapped mode: without ``--model-path`` a randomly-initialized tiny model
exercises the full pipeline (smoke tests only). With ``--model-path`` /
``--vision-path`` (local directories and files; nothing is downloaded) the
Llama and CLIP weights are imported through ``transformers``. Loading a
``--model-ckpt`` of the JAX trainer (``params.msgpack``) is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from stair_tpu_torch.llm.clip import ClipVisionConfig, preprocess_frames
from stair_tpu_torch.llm.conversation import conv_templates
from stair_tpu_torch.llm.decoder import DecoderConfig
from stair_tpu_torch.llm.frames import load_video_frames
from stair_tpu_torch.llm.video_prefix import SimpleTokenizer
from stair_tpu_torch.llm.videochat import (
    DEFAULT_VIDEO_PATCH_TOKEN,
    KeywordsStoppingCriteria,
    VideoChatConfig,
    VideoChatModel,
    build_video_prompt,
)
from stair_tpu_torch.weights import params_from_numpy


def _device(args):
    name = getattr(args, "device", None)
    if name:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device("cuda", 0)


def initialize_model(args):
    """Build (model, tokenizer) on ``args.device``. Loads HF weights when
    ``args.model_path`` is a local directory."""
    device = _device(args)
    if getattr(args, "model_ckpt", None):
        raise NotImplementedError(
            "--model-ckpt (the JAX trainer's params.msgpack) is not ported "
            "yet; pass --model-path/--vision-path or neither")
    if args.model_path and os.path.isdir(args.model_path):
        from transformers import AutoConfig, AutoTokenizer

        from stair_tpu_torch.llm.clip import import_clip_vision
        from stair_tpu_torch.llm.import_weights import (
            import_llama,
            llama_config_from_hf,
        )

        tokenizer = AutoTokenizer.from_pretrained(
            args.model_path, local_files_only=True)
        state = torch.load(
            os.path.join(args.model_path, "pytorch_model.bin"),
            map_location="cpu",
        )
        hf_cfg = AutoConfig.from_pretrained(
            args.model_path, local_files_only=True)
        cfg = VideoChatConfig(decoder=llama_config_from_hf(hf_cfg),
                              vision=ClipVisionConfig())  # ViT-L/14
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        params = params_from_numpy({
            "decoder": import_llama(state),
            "vision": import_clip_vision(
                torch.load(args.vision_path, map_location="cpu")),
            "mm_projector": {
                "w": np.asarray(state["model.mm_projector.weight"].float()).T,
                "b": np.asarray(state["model.mm_projector.bias"].float()),
            },
        })
        model = VideoChatModel(cfg, params).to(device=device, dtype=dtype)
        return model, tokenizer
    # Air-gapped tiny model.
    dec_cfg = DecoderConfig.llama(
        vocab_size=512, d_model=64, num_heads=4, num_layers=2, d_ff=128,
        max_len=1024,
    )
    vis_cfg = ClipVisionConfig(
        image_size=56, patch_size=14, d_model=32, num_heads=2,
        num_layers=2, d_ff=64,
    )
    cfg = VideoChatConfig(decoder=dec_cfg, vision=vis_cfg, max_temporal=20)
    model = VideoChatModel(
        cfg, generator=torch.Generator().manual_seed(0)).to(device)
    tokenizer = SimpleTokenizer.build([
        DEFAULT_VIDEO_PATCH_TOKEN, "<vid_start>", "<vid_end>",
        "question answer video what did they do ?",
    ])
    return model, tokenizer


def _model_device(model):
    return model.decoder.embed.device


@torch.no_grad()
def encode_video_batch(model, frame_sets):
    """CLIP-encode each sample's frames -> [B, V, D] spliceable features.

    Split out of the infer path so multi-question flows (the consistency
    benchmark asks two questions of the same video) encode each video once
    and reuse the features across questions.
    """
    cfg = model.config
    device = _model_device(model)
    video_tokens = []
    for frames in frame_sets:
        images = preprocess_frames(frames, size=cfg.vision.image_size,
                                   device=device)
        video_tokens.append(model.encode_video(images))
    return torch.stack(video_tokens)


def build_prompt_batch(model, tokenizer, questions,
                       conv_mode="video-chatgpt_v1", max_new_tokens=64):
    """The host side of one batch: conversation prompts with the video
    placeholder block, tokenized and padded.

    Returns ``(token_ids [B, Lmax] int64, splice_start [B] int32,
    prompt_len [B] int32, stop_str)`` as tensors on the model's device.
    The patch block becomes ``video_token_len`` consecutive placeholder
    slots (id 0) that ``splice_embeds`` writes over; ``Lmax`` leaves room
    for ``max_new_tokens`` and is rounded up to a multiple of 128 as in
    the JAX package (the attention kernel itself takes any length).
    """
    cfg = model.config
    device = _model_device(model)
    V = cfg.video_token_len
    template = conv_templates[conv_mode]
    enc, splice_starts, lens = [], [], []
    for q in questions:
        conv = template.copy()
        conv.append_message(
            conv.roles[0], build_video_prompt(q, V, cfg.use_vid_start_end)
        )
        conv.append_message(conv.roles[1], None)
        pre, _, post = conv.get_prompt().partition(
            DEFAULT_VIDEO_PATCH_TOKEN * V)
        pre_ids = list(tokenizer.encode(pre))
        post_ids = list(tokenizer.encode(post))
        splice_starts.append(len(pre_ids))
        enc.append(pre_ids + [0] * V + post_ids)
        lens.append(len(enc[-1]))
    Lmax = ((max(lens) + max_new_tokens + 127) // 128) * 128
    token_ids = np.zeros((len(enc), Lmax), np.int64)
    for b, ids in enumerate(enc):
        token_ids[b, : len(ids)] = ids
    return (torch.from_numpy(token_ids).to(device),
            torch.tensor(splice_starts, dtype=torch.int32, device=device),
            torch.tensor(lens, dtype=torch.int32, device=device),
            template.copy().stop_str)


@torch.no_grad()
def video_chatgpt_infer_batch(model, tokenizer, questions, frame_sets,
                              conv_mode="video-chatgpt_v1", max_new_tokens=64,
                              temperature=0.2, generator=None,
                              video_tokens=None):
    """Answer a batch of (question, frames) pairs; returns strings.

    ``video_tokens`` (precomputed [B, V, D]) skips the vision tower: pass
    ``encode_video_batch``'s output to reuse features across calls. With
    ``temperature`` > 0 and no ``generator``, one seeded with 0 on the
    model's device is used.
    """
    if video_tokens is None:
        video_tokens = encode_video_batch(model, frame_sets)
    token_ids, splice_start, prompt_len, stop_str = build_prompt_batch(
        model, tokenizer, questions, conv_mode, max_new_tokens)
    if temperature and temperature > 0 and generator is None:
        generator = torch.Generator(
            device=_model_device(model)).manual_seed(0)
    toks = model.generate(
        token_ids, video_tokens, splice_start, prompt_len=prompt_len,
        max_new_tokens=max_new_tokens, temperature=temperature,
        generator=generator,
        eos_id=getattr(tokenizer, "eos_token_id", None),
    ).cpu().numpy()
    stopper = KeywordsStoppingCriteria([stop_str], tokenizer, 0)
    return [stopper.truncate(tokenizer.decode(t)) for t in toks]


def _write(args, results, what):
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, args.output_name + ".json")
    with open(out, "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} {what} -> {out}")


def run_inference(args):
    with open(args.gt_file) as f:
        samples = json.load(f)
    model, tokenizer = initialize_model(args)
    results = []
    batch_q, batch_f, batch_meta = [], [], []

    def flush():
        nonlocal batch_q, batch_f, batch_meta
        if not batch_q:
            return
        answers = video_chatgpt_infer_batch(
            model, tokenizer, batch_q, batch_f, conv_mode=args.conv_mode,
        )
        for meta, pred in zip(batch_meta, answers):
            results.append(dict(meta, pred=pred))
        batch_q, batch_f, batch_meta = [], [], []

    for sample in samples:
        video_path = os.path.join(
            args.video_dir, sample.get("video_name", sample.get("video", ""))
        )
        if not os.path.exists(video_path):
            continue
        try:
            frames = load_video_frames(video_path, args.num_frames)
        except Exception as err:
            print("skipping", video_path, err)
            continue
        batch_q.append(sample.get("question", sample.get("Q", "")))
        batch_f.append(frames)
        batch_meta.append({
            "id": sample.get("id") or sample.get("question_id"),
            "question": batch_q[-1],
            "answer": sample.get("answer", sample.get("A", "")),
        })
        if len(batch_q) == args.batch_size:
            flush()
    flush()
    _write(args, results, "predictions")


def run_inference_consistency(args):
    """Consistency benchmark: TWO questions per sample against the SAME
    video; predictions ``pred1``/``pred2`` are appended to each sample
    record. The video is CLIP-encoded once per sample; both questions
    generate against the cached [V, D] features."""
    with open(args.gt_file) as f:
        samples = json.load(f)
    model, tokenizer = initialize_model(args)
    video_formats = [".mp4", ".avi", ".mov", ".mkv", ""]
    results = []
    batch_samples, batch_f = [], []

    def flush():
        nonlocal batch_samples, batch_f
        if not batch_samples:
            return
        video_tokens = encode_video_batch(model, batch_f)
        preds = {}
        for qkey, pkey in (("Q1", "pred1"), ("Q2", "pred2")):
            qs = [s.get(qkey, "") for s in batch_samples]
            preds[pkey] = video_chatgpt_infer_batch(
                model, tokenizer, qs, batch_f,
                conv_mode=args.conv_mode, video_tokens=video_tokens,
            )
        for i, sample in enumerate(batch_samples):
            results.append(dict(
                sample, pred1=preds["pred1"][i], pred2=preds["pred2"][i],
            ))
        batch_samples, batch_f = [], []

    for sample in samples:
        video_name = sample.get("video_name", sample.get("video", ""))
        video_path = None
        for fmt in video_formats:
            cand = os.path.join(args.video_dir, f"{video_name}{fmt}")
            if os.path.exists(cand):
                video_path = cand
                break
        if video_path is None:
            continue
        try:
            frames = load_video_frames(video_path, args.num_frames)
        except Exception as err:
            print("skipping", video_path, err)
            continue
        batch_samples.append(sample)
        batch_f.append(frames)
        if len(batch_samples) == args.batch_size:
            flush()
    flush()
    _write(args, results, "consistency predictions")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--video-dir", required=True)
    p.add_argument("--gt-file", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--output-name", default="preds")
    p.add_argument("--model-path", default=None)
    p.add_argument("--vision-path", default=None)
    p.add_argument("--model-ckpt", default=None)
    p.add_argument("--conv-mode", default="video-chatgpt_v1")
    p.add_argument("--num-frames", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; fails without one "
                        "unless 'cpu' is given)")
    p.add_argument("--consistency", action="store_true",
                   help="two-questions-per-sample (Q1/Q2 -> pred1/pred2) "
                        "consistency-benchmark flow")
    args = p.parse_args(argv)
    if args.consistency:
        run_inference_consistency(args)
    else:
        run_inference(args)


if __name__ == "__main__":
    main()
