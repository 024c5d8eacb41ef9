"""Video-ChatGPT path: CLIP features -> spatio-temporal tokens -> Llama
(port of ``stair_tpu/llm/videochat.py``, serving half).

Raw video frames are encoded by the CLIP tower (``llm/clip.py``), pooled
into ``max_temporal`` temporal + S spatial tokens, projected by
``mm_projector`` and written into the Llama embedding stream over the
``<vid_patch>`` span, whose start is known when the prompt is made. Generation is
the decoder's prefill + KV-cache loop with keyword stopping. ``sft_loss``
waits for the LLM training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stair_tpu_torch.llm.clip import ClipVisionConfig, ClipVisionTower
from stair_tpu_torch.llm.decoder import Decoder, DecoderConfig, init_linear
from stair_tpu_torch.models.modules import linear
from stair_tpu_torch.weights import ParamModule

DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_VIDEO_PATCH_TOKEN = "<vid_patch>"
DEFAULT_VID_START_TOKEN = "<vid_start>"
DEFAULT_VID_END_TOKEN = "<vid_end>"


def spatio_temporal_pool(features, max_temporal: int = 100):
    """[T, S, C] frame-patch features -> [max_temporal + S, C] tokens.

    Temporal tokens: per-frame spatial means, zero-padded (or cut) to
    ``max_temporal``; spatial tokens: per-patch temporal means.
    """
    t, s, c = features.shape
    temporal = torch.mean(features, dim=1)
    if t < max_temporal:
        temporal = torch.cat(
            [temporal, temporal.new_zeros(max_temporal - t, c)])
    else:
        temporal = temporal[:max_temporal]
    spatial = torch.mean(features, dim=0)
    return torch.cat([temporal, spatial], dim=0)


@dataclass(frozen=True)
class VideoChatConfig:
    decoder: DecoderConfig
    vision: ClipVisionConfig
    max_temporal: int = 100
    use_vid_start_end: bool = True

    @property
    def video_token_len(self):
        return self.max_temporal + self.vision.num_patches


class VideoChatModel(ParamModule):
    """mm_projector + Llama decoder over spliced video tokens. The params
    tree is ``{"decoder", "vision", "mm_projector"}`` as in the JAX package:
    the first two live in the ``decoder`` and ``vision`` sub-modules."""

    def __init__(self, config: VideoChatConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = params or {}
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.decoder = Decoder(config.decoder, params.get("decoder"), **kw)
        self.vision = ClipVisionTower(config.vision, params.get("vision"),
                                      **kw)
        self._hold({"mm_projector": params.get("mm_projector") or init_linear(
            generator, config.vision.d_model, config.decoder.d_model,
            device, dtype)}, device)

    def param_tree(self) -> dict:
        return {"decoder": self.decoder.param_tree(),
                "vision": self.vision.param_tree(),
                **super().param_tree()}

    @torch.no_grad()
    def encode_video(self, frames):
        """[T, H, W, 3] normalized frames -> [video_token_len, vision_d]."""
        dt = self.vision.weights["patch_proj"].dtype
        feats = self.vision.patch_features(frames.to(dt))
        return spatio_temporal_pool(feats, self.config.max_temporal)

    def splice_embeds(self, token_ids, video_tokens, splice_start):
        """Project video tokens and write them over the patch span.

        token_ids [B, L]; video_tokens [B, V, vision_d];
        splice_start [B]: first ``<vid_patch>`` position.
        """
        embeds = self.decoder.embed[token_ids]             # a fresh tensor
        projected = linear(super().param_tree()["mm_projector"],
                           video_tokens.to(embeds.dtype))
        V = projected.shape[1]
        # the start is clamped so the span fits, as dynamic_update_slice does
        start = torch.clamp(splice_start.long(), 0, embeds.shape[1] - V)
        cols = start[:, None] + torch.arange(
            V, device=embeds.device)[None, :]
        rows = torch.arange(embeds.shape[0], device=embeds.device)[:, None]
        return embeds.index_put((rows, cols), projected)

    def forward(self, token_ids, video_tokens, splice_start, valid_len):
        embeds = self.splice_embeds(token_ids, video_tokens, splice_start)
        B = embeds.shape[0]
        hidden = self.decoder.hidden_states(
            embeds, torch.zeros(B, dtype=torch.int32, device=embeds.device),
            valid_len.to(torch.int32))
        return self.decoder.logits_from_hidden(hidden)

    @torch.no_grad()
    def generate(self, token_ids, video_tokens, splice_start, prompt_len,
                 max_new_tokens=64, temperature=0.2, generator=None,
                 eos_id=None):
        embeds = self.splice_embeds(token_ids, video_tokens, splice_start)
        return self.decoder.generate(
            embeds, prompt_len, max_new_tokens, temperature=temperature,
            generator=generator, eos_id=eos_id)


# ---------------------------------------------------------------------------
# Prompt building + stopping
# ---------------------------------------------------------------------------

def build_video_prompt(question: str, video_token_len: int,
                       use_start_end: bool = True) -> str:
    """Insert the video placeholder block into the question."""
    if use_start_end:
        block = (
            DEFAULT_VID_START_TOKEN
            + DEFAULT_VIDEO_PATCH_TOKEN * video_token_len
            + DEFAULT_VID_END_TOKEN
        )
    else:
        block = DEFAULT_VIDEO_PATCH_TOKEN * video_token_len
    return question + "\n" + block


class KeywordsStoppingCriteria:
    """Cut the decoded text at the first occurrence of any keyword."""

    def __init__(self, keywords, tokenizer, prompt_len: int):
        self.keywords = keywords
        self.tokenizer = tokenizer
        self.prompt_len = prompt_len

    def truncate(self, text: str) -> str:
        for kw in self.keywords:
            idx = text.find(kw)
            if idx >= 0:
                text = text[:idx]
        return text.strip()
