"""T5 encoder-decoder, the pretrained Flan-T5 program-parser path (port of
``stair_tpu/seq2seq/t5.py``).

Runs the reference's best parser recipe (fine-tuned Flan-T5,
yellow-binary-tree/STAIR ``hf_program_parser.py:142-205``) from imported HF
weights (``llm/import_weights.import_t5``), or trains from scratch on the
word-level program vocabulary (``--arch t5``). Plain torch ops; it reaches
no kernel, in JAX or here.

Architecture notes (as the JAX package's):

  * RMS layer norm (no mean subtraction, no bias), computed in float32;
  * attention projections without bias, inner dim = num_heads * d_kv, and
    NO 1/sqrt(d) score scaling (T5 folds it into initialization);
  * bucketed relative-position bias, embedded once per stack and added to
    every self-attention's scores; encoder buckets are bidirectional,
    decoder causal; cross-attention has none;
  * feed-forward: ``relu`` (t5 v1.0) or ``gated-gelu`` (v1.1 / Flan);
  * logits: tied embeddings scale hidden by d_model**-0.5 (v1.0); untied
    checkpoints (Flan) use a separate lm_head without scaling.

Exposes the same ``encode`` / ``init_state`` / ``step`` protocol as the
other parsers (decoder start token = pad id, per T5 convention).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from stair_tpu_torch.seq2seq.transformer import decode_step
from stair_tpu_torch.weights import ParamModule

NEG_INF = -1e9


@dataclass(frozen=True)
class T5Config:
    vocab_size: int
    d_model: int = 512
    d_kv: int = 64
    num_heads: int = 8
    num_layers: int = 6
    num_decoder_layers: int = 6
    d_ff: int = 2048
    feed_forward: str = "relu"          # 'relu' | 'gated-gelu'
    num_buckets: int = 32
    max_distance: int = 128
    rms_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_src_len: int = 32
    max_tgt_len: int = 48

    # beam_search reads the target vocab size from config.tgt_vocab.
    @property
    def tgt_vocab(self) -> int:
        return self.vocab_size


def rms_norm(scale, x, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def relative_position_bucket(relative_position, bidirectional, num_buckets,
                             max_distance):
    """Standard T5 bucketing of (memory_pos - query_pos) distances, with the
    JAX package's 1e-9 inside the log (``t5.py:82``)."""
    ret = torch.zeros_like(relative_position)
    n = relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(n.dtype) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(n.dtype)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def _position_bias(table, q_len, k_len, bidirectional, num_buckets,
                   max_distance):
    """[heads, q_len, k_len] from the bucket-embedding ``table``."""
    ctx = torch.arange(q_len, device=table.device)[:, None]
    mem = torch.arange(k_len, device=table.device)[None, :]
    buckets = relative_position_bucket(
        mem - ctx, bidirectional, num_buckets, max_distance)  # [q, k]
    return table[buckets].permute(2, 0, 1)                   # [h, q, k]


def _attn(p, q_in, kv_in, bias, num_heads, d_kv):
    """T5 attention: unscaled scores + additive ``bias`` [h or 1, Lq, Lk]."""
    B, Lq, _ = q_in.shape
    Lk = kv_in.shape[1]
    q = (q_in @ p["q"]["w"]).reshape(B, Lq, num_heads, d_kv)
    k = (kv_in @ p["k"]["w"]).reshape(B, Lk, num_heads, d_kv)
    v = (kv_in @ p["v"]["w"]).reshape(B, Lk, num_heads, d_kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Lq, -1)
    return out @ p["o"]["w"]


def _ffn(p, x, kind):
    if kind == "gated-gelu":
        h = F.gelu(x @ p["wi_0"]["w"], approximate="tanh") * (
            x @ p["wi_1"]["w"])
    else:
        h = torch.relu(x @ p["wi"]["w"])
    return h @ p["wo"]["w"]


class T5Seq2Seq(ParamModule):
    def __init__(self, config: T5Config, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.config = config
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = self.init(generator)
        self._hold(params, device)

    # -- init -----------------------------------------------------------------

    def init(self, gen: torch.Generator) -> dict:
        """A fresh params tree with the JAX package's keys and shapes, drawn
        from ``gen`` (a CPU generator)."""
        cfg = self.config
        D, inner = cfg.d_model, cfg.num_heads * cfg.d_kv

        def randn(shape, scale=1.0):
            return torch.randn(shape, generator=gen) * scale

        def dense(d_in, d_out):
            return {"w": randn((d_in, d_out), 1.0 / math.sqrt(d_in))}

        def attn_block():
            return {"q": dense(D, inner), "k": dense(D, inner),
                    "v": dense(D, inner), "o": dense(inner, D)}

        def ffn_block():
            if cfg.feed_forward == "gated-gelu":
                return {"wi_0": dense(D, cfg.d_ff),
                        "wi_1": dense(D, cfg.d_ff),
                        "wo": dense(cfg.d_ff, D)}
            return {"wi": dense(D, cfg.d_ff), "wo": dense(cfg.d_ff, D)}

        params = {
            "shared": randn((cfg.vocab_size, D)),
            "enc_rel": randn((cfg.num_buckets, cfg.num_heads), 0.1),
            "dec_rel": randn((cfg.num_buckets, cfg.num_heads), 0.1),
            "enc": [{"ln1": torch.ones(D), "attn": attn_block(),
                     "ln2": torch.ones(D), "ffn": ffn_block()}
                    for _ in range(cfg.num_layers)],
            "dec": [{"ln1": torch.ones(D), "self": attn_block(),
                     "ln2": torch.ones(D), "cross": attn_block(),
                     "ln3": torch.ones(D), "ffn": ffn_block()}
                    for _ in range(cfg.num_decoder_layers)],
            "enc_ln": torch.ones(D),
            "dec_ln": torch.ones(D),
        }
        if not cfg.tie_word_embeddings:
            params["lm_head"] = dense(D, cfg.vocab_size)
        return params

    # -- stacks ---------------------------------------------------------------

    def encode(self, src_ids, src_mask, params=None):
        cfg = self.config
        p = params if params is not None else self.param_tree()
        x = p["shared"][src_ids]
        L = x.shape[1]
        bias = _position_bias(p["enc_rel"], L, L, True, cfg.num_buckets,
                              cfg.max_distance)[None]          # [1, h, L, L]
        bias = bias + torch.where(src_mask[:, None, None, :] > 0, 0.0,
                                  NEG_INF)
        for layer in p["enc"]:
            h = rms_norm(layer["ln1"], x, cfg.rms_eps)
            x = x + _attn(layer["attn"], h, h, bias, cfg.num_heads, cfg.d_kv)
            x = x + _ffn(layer["ffn"], rms_norm(layer["ln2"], x, cfg.rms_eps),
                         cfg.feed_forward)
        return rms_norm(p["enc_ln"], x, cfg.rms_eps)

    def _decode(self, p, encoded, src_mask, tgt_in, tgt_mask):
        cfg = self.config
        B, T = tgt_in.shape
        x = p["shared"][tgt_in]
        self_bias = _position_bias(p["dec_rel"], T, T, False,
                                   cfg.num_buckets, cfg.max_distance)[None]
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                       device=x.device))
        legal = causal[None, :, :] & (tgt_mask[:, None, :] > 0)
        self_bias = self_bias + torch.where(legal[:, None], 0.0, NEG_INF)
        cross_bias = torch.where(src_mask[:, None, None, :] > 0, 0.0,
                                 NEG_INF)                       # [B, 1, 1, Lk]
        for layer in p["dec"]:
            h = rms_norm(layer["ln1"], x, cfg.rms_eps)
            x = x + _attn(layer["self"], h, h, self_bias, cfg.num_heads,
                          cfg.d_kv)
            x = x + _attn(layer["cross"],
                          rms_norm(layer["ln2"], x, cfg.rms_eps), encoded,
                          cross_bias, cfg.num_heads, cfg.d_kv)
            x = x + _ffn(layer["ffn"], rms_norm(layer["ln3"], x, cfg.rms_eps),
                         cfg.feed_forward)
        x = rms_norm(p["dec_ln"], x, cfg.rms_eps)
        if cfg.tie_word_embeddings:
            return (x * cfg.d_model ** -0.5) @ p["shared"].T
        return x @ p["lm_head"]["w"]

    def logits(self, src_ids, src_mask, tgt_in):
        p = self.param_tree()
        encoded = self.encode(src_ids, src_mask, p)
        tgt_mask = torch.ones(tgt_in.shape, device=tgt_in.device)
        return self._decode(p, encoded, src_mask, tgt_in, tgt_mask)

    # -- incremental interface for beam search -------------------------------

    def init_state(self, encoded, src_mask):
        B = encoded.shape[0]
        return {
            "encoded": encoded,
            "src_mask": src_mask,
            "tokens": torch.zeros(B, self.config.max_tgt_len,
                                  dtype=torch.long, device=encoded.device),
            "pos": 0,
        }

    def step(self, state, token):
        return decode_step(self, state, token)
