"""The Video-ChatGPT serving workload ``chip_smoke.py`` and
``scripts/profile_slice.py`` drive: Llama-class decoder + CLIP ViT-L/14 at
their published widths with weights made from a seed on the device, a
word-level tokenizer, four questions of different lengths and random
frames. Depth is the only thing a caller cuts.
"""

from __future__ import annotations

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
