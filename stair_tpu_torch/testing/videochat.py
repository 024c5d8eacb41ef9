"""The Video-ChatGPT workloads ``chip_smoke.py``, ``scripts/
profile_slice.py`` and the tests drive. Serving: Llama-class decoder + CLIP
ViT-L/14 at their published widths with weights made from a seed on the
device, a word-level tokenizer, four questions of different lengths and
random frames; depth is the only thing a caller cuts. Training: a seeded
SFT batch (``sft_batch``) and a seeded tiny data directory for the two
trainer CLIs (``write_tiny_data``): conversation JSON + ``.npy`` features
for ``videochat_train``, AGQA-style record pickles + ``.npy`` features and
a filter-output pickle for ``with_video_lm``.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from stair_tpu_torch.llm.clip import ClipVisionConfig
from stair_tpu_torch.llm.conversation import conv_templates
from stair_tpu_torch.llm.decoder import DecoderConfig
from stair_tpu_torch.llm.video_prefix import SimpleTokenizer
from stair_tpu_torch.llm.videochat import (
    DEFAULT_VIDEO_PATCH_TOKEN, VideoChatConfig, VideoChatModel,
)

#: ``videochat_infer.py``'s defaults: batch 4, 100 frames, 64 new tokens
BATCH, FRAMES, NEW_TOKENS = 4, 100, 64
QUESTIONS = [
    "what is the person doing ?",
    "what did the person do after they opened the door of the kitchen ?",
    "is the person holding a cup or a dish while they watch television ?",
    "where is the laptop ?",
]


def tokenizer(conv_mode="video-chatgpt_v1") -> SimpleTokenizer:
    """A vocabulary over the conversation template, the video markers and
    the questions."""
    return SimpleTokenizer.build(
        [DEFAULT_VIDEO_PATCH_TOKEN, "<vid_start>", "<vid_end>",
         conv_templates[conv_mode].system, "USER ASSISTANT", *QUESTIONS])


def frame_sets(seed=0, frames=FRAMES, height=240, width=320):
    """One ``[frames, height, width, 3]`` uint8 array per question."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (frames, height, width, 3), dtype=np.uint8)
            for _ in QUESTIONS]


def build_model(device, decoder_layers=32, vision_layers=24, seed=0,
                dtype=torch.bfloat16) -> VideoChatModel:
    """Llama-7B widths (d 4096, 32 heads, d_ff 11008, vocab 32000) and CLIP
    ViT-L/14 widths at the given depths, made on ``device`` in ``dtype``."""
    cfg = VideoChatConfig(
        decoder=DecoderConfig.llama(num_layers=decoder_layers),
        vision=ClipVisionConfig(num_layers=vision_layers), max_temporal=100)
    return VideoChatModel(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        device=device, dtype=dtype)


def sft_batch(seed=0, batch=8, length=512, video_tokens=356, vision_dim=1024,
              vocab_size=32000, device=None):
    """A seeded ``VideoChatModel.sft_loss`` batch (numpy draws, tensors on
    ``device``): ragged ``valid_len`` in [3 L / 4, L] with the first row
    full, the video span after a short system prefix, and labels on the
    reply span between the video block and ``valid_len`` (-1 elsewhere)."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(3, vocab_size, (batch, length)).astype(np.int32)
    valid = rng.randint(3 * length // 4, length + 1, (batch,)).astype(np.int32)
    valid[0] = length
    start = rng.randint(4, 12, (batch,)).astype(np.int32)
    lab = np.full((batch, length), -1, np.int32)
    for b in range(batch):
        reply = int(start[b]) + video_tokens + int(rng.randint(4, 16))
        lab[b, reply:valid[b]] = tok[b, reply:valid[b]]
        tok[b, valid[b]:] = 0
    out = {
        "token_ids": tok, "labels": lab,
        "video_tokens": rng.randn(batch, video_tokens, vision_dim).astype(
            np.float32),
        "splice_start": start, "valid_len": valid,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


ANSWERS = ["yes", "no", "before", "after", "cup", "laptop", "door"]


def write_tiny_data(root, seed=0, num_videos=6, num_conversations=16,
                    num_records=24, video_token_len=116, vision_dim=64,
                    video_size=32, frames=24):
    """Write the trainers' seeded tiny inputs under ``root`` and return their
    paths: ``conv`` (conversation JSON), ``chat_features`` (one
    ``[video_token_len, vision_dim]`` ``.npy`` per video), ``train`` /
    ``valid`` / ``test`` (pickled AGQA-style record lists), ``rgb`` (one
    ``[frames, video_size]`` ``.npy`` per video; the loader takes every
    second frame) and ``filter`` (a ``%s`` template of per-split
    filter-output pickles)."""
    rng = np.random.RandomState(seed)
    paths = {"conv": os.path.join(root, "conv.json"),
             "chat_features": os.path.join(root, "chat_features"),
             "rgb": os.path.join(root, "rgb"),
             "filter": os.path.join(root, "filter_%s.pkl")}
    for d in (paths["chat_features"], paths["rgb"]):
        os.makedirs(d, exist_ok=True)
    vids = [f"V{i:03d}" for i in range(num_videos)]
    for v in vids:
        np.save(os.path.join(paths["chat_features"], v + ".npy"),
                rng.randn(video_token_len, vision_dim).astype(np.float32))
        np.save(os.path.join(paths["rgb"], v + ".npy"),
                rng.randn(frames - int(rng.randint(0, 6)),
                          video_size).astype(np.float32))
    convs = []
    for i in range(num_conversations):
        q = QUESTIONS[i % len(QUESTIONS)]
        a = ANSWERS[int(rng.randint(len(ANSWERS)))]
        convs.append({
            "id": i, "video": vids[i % num_videos] + ".mp4",
            "conversations": [
                {"from": "human", "value": "<video>\n" + q},
                {"from": "gpt", "value": f"the answer is {a} ."},
                {"from": "human", "value": "are you sure ?"},
                {"from": "gpt", "value": "yes ."},
            ]})
    with open(paths["conv"], "w") as f:
        json.dump(convs, f)
    records = []
    for i in range(num_records):
        records.append({
            "qa_id": f"q{i}", "video_id": vids[int(rng.randint(num_videos))],
            "question": QUESTIONS[int(rng.randint(len(QUESTIONS)))],
            "answer": ANSWERS[int(rng.randint(len(ANSWERS)))],
            "novel_comp": int(i % 2), "more_steps": int(i % 3 == 0)})
    cut = (num_records * 2) // 3
    splits = {"train": records[:cut], "valid": records[cut:],
              "test": records[cut:]}
    for split, recs in splits.items():
        paths[split] = os.path.join(root, f"{split}.pkl")
        with open(paths[split], "wb") as f:
            pickle.dump(recs, f)
        with open(paths["filter"] % split, "wb") as f:
            pickle.dump({
                r["qa_id"]: {
                    0: (1, "holding", ["cup", "dish"]),
                    1: (2, "before", ["opening the door"]),
                } for r in recs[::2]}, f)
    return paths
