"""Video-prefix language model: video features spliced ahead of the text
(port of ``stair_tpu/llm/video_prefix.py``).

Video features pass through a ``video_ff`` adapter into the embedding
stream ahead of the text; sequences are packed contiguously ``[video |
prompt | answer | pad]`` with per-example lengths. With
``video_visible=True`` the video tokens are visible to every position: the
attention kernel's per-example ``prefix_len`` (this is its one caller with
``prefix_len > 0``, in ``video_loss``). Here too: the reply and video
losses, ``splice_filter_outputs``, the tokenizer protocol
(``SimpleTokenizer``, ``load_tokenizer``), batch packing and the
exact-match metric; the trainer is ``llm/with_video_lm.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stair_tpu_torch.llm.decoder import Decoder, DecoderConfig, init_linear
from stair_tpu_torch.llm.videochat import shifted_cross_entropy
from stair_tpu_torch.models.modules import linear
from stair_tpu_torch.weights import ParamModule
from stair_tpu_torch.programs.text import tokenize

IGNORE = -1


# ---------------------------------------------------------------------------
# Tokenizer protocol: word-level fallback or HF tokenizer
# ---------------------------------------------------------------------------

class SimpleTokenizer:
    """Deterministic word-level tokenizer for environments without HF
    tokenizer data; shares the Vocab special-token layout."""

    def __init__(self, word2id: dict[str, int], eos_token_id: int,
                 pad_token_id: int):
        self.word2id = word2id
        self.id2word = {i: w for w, i in word2id.items()}
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id

    @classmethod
    def build(cls, texts):
        words = sorted({
            w.lower() for t in texts for w in tokenize(t)
        })
        word2id = {"<pad>": 0, "<eos>": 1, "<unk>": 2}
        for w in words:
            word2id[w] = len(word2id)
        return cls(word2id, eos_token_id=1, pad_token_id=0)

    def encode(self, text: str, max_length: int | None = None):
        ids = [
            self.word2id.get(w.lower(), 2) for w in tokenize(text)
        ]
        return ids[:max_length] if max_length else ids

    def decode(self, ids):
        return " ".join(
            self.id2word.get(int(i), "<unk>")
            for i in ids
            if int(i) not in (self.pad_token_id, self.eos_token_id)
        )

    def __len__(self):
        return len(self.word2id)


def load_tokenizer(path_or_none, corpus_texts=None):
    if path_or_none:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path_or_none,
                                            local_files_only=True)
        if tok.pad_token_id is None:
            tok.pad_token = tok.eos_token
        return tok
    return SimpleTokenizer.build(corpus_texts or [])


# ---------------------------------------------------------------------------
# Filter-output prompt splicing
# ---------------------------------------------------------------------------

def splice_filter_outputs(
    question_text: str,
    filter_outputs: dict | None,
    max_per_module: int = 1,
    max_total: int = 5,
    by_level: int = 0,
) -> str:
    """Prepend '<keyword> <answer>.' strings from STAIR Filter retrievals."""
    if not filter_outputs:
        return question_text
    entries = list(filter_outputs.values())
    if by_level:
        entries = [e for e in entries if e[0] <= by_level]
    entries.sort(key=lambda e: -e[0])       # low tree level last -> first
    texts = []
    for _level, keyword, answers in entries:
        for ans in answers[:max_per_module]:
            texts.append(f"{keyword} {ans}.")
    if not by_level and len(texts) > max_total:
        texts = texts[:max_total]
    if texts:
        return " ".join(texts) + " " + question_text
    return question_text


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VideoPrefixConfig:
    video_size: int
    decoder: DecoderConfig
    max_video_length: int = 64
    max_text_length: int = 64


class VideoPrefixLM(ParamModule):
    """Params tree ``{"decoder", "video_ff", "video_inverse_ff"}`` as in the
    JAX package; the decoder's leaves live in the ``decoder`` sub-module."""

    def __init__(self, config: VideoPrefixConfig, params: dict | None = None,
                 *, generator: torch.Generator | None = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = params or {}
        D = config.decoder.d_model
        self.decoder = Decoder(config.decoder, params.get("decoder"),
                               generator=generator, device=device,
                               dtype=dtype)
        self._hold({
            "video_ff": params.get("video_ff") or init_linear(
                generator, config.video_size, D, device, dtype),
            "video_inverse_ff": params.get("video_inverse_ff") or init_linear(
                generator, D, config.video_size, device, dtype),
        }, device)

    def param_tree(self) -> dict:
        return {"decoder": self.decoder.param_tree(),
                **super().param_tree()}

    def build_embeds(self, video, video_len, token_ids):
        """Pack [video | tokens] into one embedding stream.

        video: [B, Fmax, video_size]; video_len: [B]; token_ids: [B, Ltext]
        (already prompt+answer+pad). Returns embeds [B, Fmax+Ltext, D]: per
        example the video rows, then from ``video_len`` on the text rows
        (written over the video padding), zeros after.
        """
        B, Fmax, _ = video.shape
        Lt = token_ids.shape[1]
        p = super().param_tree()
        video_emb = linear(p["video_ff"], video)               # [B, Fmax, D]
        text_emb = self.decoder.embed[token_ids]               # [B, Lt, D]
        D = video_emb.shape[-1]
        out = video_emb.new_zeros(B, Fmax + Lt, D)
        out[:, :Fmax] = video_emb
        cols = video_len.long()[:, None] + torch.arange(
            Lt, device=out.device)[None, :]
        rows = torch.arange(B, device=out.device)[:, None]
        return out.index_put((rows, cols), text_emb.to(out.dtype))

    def forward(self, batch, video_visible=False):
        """batch keys: video [B,F,vd], video_len [B], token_ids [B,Lt],
        text_len [B]. Returns (logits, hidden)."""
        embeds = self.build_embeds(batch["video"], batch["video_len"],
                                   batch["token_ids"])
        total_len = (batch["video_len"] + batch["text_len"]).to(torch.int32)
        prefix = (batch["video_len"].to(torch.int32) if video_visible
                  else torch.zeros_like(total_len))
        hidden = self.decoder.hidden_states(embeds, prefix, total_len)
        return self.decoder.logits_from_hidden(hidden), hidden

    # -- losses --------------------------------------------------------------

    def reply_loss(self, batch):
        """Answer-span CE with shifted labels; returns ``(loss, logits)``.

        batch['labels'] [B, F+Lt]: token id at answer positions, IGNORE
        elsewhere (already aligned to the packed stream).
        """
        logits, _ = self.forward(batch, video_visible=False)
        return shifted_cross_entropy(logits, batch["labels"]), logits

    def video_loss(self, batch):
        """Next-frame feature regression under the video-visible mask (the
        attention's ``prefix_len > 0`` path): per-example means over the
        valid frames, summed over the batch."""
        _, hidden = self.forward(batch, video_visible=True)
        p = super().param_tree()
        pred = linear(p["video_inverse_ff"], hidden).float()   # [B, L, vd]
        video = batch["video"].float()                         # [B, F, vd]
        Fmax = video.shape[1]
        target = video[:, 1:]                                  # predict t+1
        pred = pred[:, : Fmax - 1]
        steps = torch.arange(Fmax - 1, device=video.device)[None, :]
        valid = (steps < (batch["video_len"][:, None] - 1)).float()
        se = torch.mean(torch.square(pred - target), dim=-1) * valid
        per_example = torch.sum(se, dim=1) / torch.clamp(
            torch.sum(valid, dim=1), min=1.0)
        return torch.sum(per_example)


# ---------------------------------------------------------------------------
# Batch construction (host side)
# ---------------------------------------------------------------------------

def pack_text_batch(
    tokenizer, questions, answers, max_text_len, video_lens, total_len,
):
    """Tokenize prompts/answers; build token_ids, text_len and packed labels.

    Returns token_ids [B, Lt], text_len [B], labels [B, total_len] where
    labels carry answer token ids (plus EOS) at their packed positions.
    """
    B = len(questions)
    token_ids = np.zeros((B, max_text_len), np.int32)
    text_len = np.zeros((B,), np.int32)
    labels = np.full((B, total_len), IGNORE, np.int32)
    eos = tokenizer.eos_token_id
    for b, (q, a) in enumerate(zip(questions, answers)):
        q_ids = tokenizer.encode(q, max_length=max_text_len)
        if hasattr(q_ids, "ids"):
            q_ids = q_ids.ids
        a_ids = list(tokenizer.encode(a, max_length=8)) + [eos]
        ids = (list(q_ids) + a_ids)[:max_text_len]
        token_ids[b, : len(ids)] = ids
        text_len[b] = len(ids)
        ans_start = min(len(q_ids), max_text_len)
        # answer positions within the packed stream
        for j, tok in enumerate(a_ids):
            pos = int(video_lens[b]) + ans_start + j
            if pos < total_len and ans_start + j < max_text_len:
                labels[b, pos] = tok
    return token_ids, text_len, labels


def answer_exact_match(logits, labels):
    """Teacher-forced: all answer tokens predicted correctly."""
    if torch.is_tensor(logits):
        logits = logits.detach().float().cpu().numpy()
    logits = np.asarray(logits)[:, :-1]
    labels = np.asarray(labels)[:, 1:]
    preds = logits.argmax(-1)
    hits = []
    for b in range(labels.shape[0]):
        pos = labels[b] != IGNORE
        if pos.sum() == 0:
            continue
        hits.append(bool((preds[b][pos] == labels[b][pos]).all()))
    return hits
