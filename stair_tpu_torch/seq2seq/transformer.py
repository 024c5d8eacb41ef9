"""Pre-norm encoder-decoder transformer, the T5-class program parser (port
of ``stair_tpu/seq2seq/transformer.py``).

A compact from-scratch encoder-decoder with sinusoid positions, trained on
the same data contract as the LSTM parser. Sequence lengths are tiny
(<=48), so attention is plain torch ops, as in JAX; it reaches no kernel.
Incremental decoding re-runs the decoder prefix each step: at these
lengths that is cheaper than a KV cache and keeps the beam-search state a
plain token buffer. Parameters are held under the JAX key paths
(``weights.ParamModule``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from stair_tpu_torch.models.modules import _init_linear, linear
from stair_tpu_torch.weights import ParamModule

NEG_INF = -1e30


@dataclass(frozen=True)
class TransformerSeq2SeqConfig:
    src_vocab: int
    tgt_vocab: int
    d_model: int = 256
    num_heads: int = 4
    num_layers: int = 3
    d_ff: int = 512
    max_src_len: int = 32
    max_tgt_len: int = 48


def _layer_norm(p, x, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _mha(p, q_in, kv_in, mask, num_heads):
    """mask: [B, Lq, Lk] boolean, True where a key may be attended."""
    B, Lq, D = q_in.shape
    Lk = kv_in.shape[1]
    h = num_heads
    d = D // h
    q = linear(p["q"], q_in).reshape(B, Lq, h, d)
    k = linear(p["k"], kv_in).reshape(B, Lk, h, d)
    v = linear(p["v"], kv_in).reshape(B, Lk, h, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    scores = torch.where(mask[:, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Lq, D)
    return linear(p["o"], out)


def _ffn(p, x):
    # jax.nn.gelu's default is the tanh approximation
    return linear(p["w2"], F.gelu(linear(p["w1"], x), approximate="tanh"))


def _sinusoid(max_len, d, device=None):
    pos = torch.arange(max_len, device=device)[:, None].float()
    dim = torch.arange(d // 2, device=device)[None, :].float()
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _randn(gen, shape, scale):
    return torch.randn(shape, generator=gen) * scale


class TransformerSeq2Seq(ParamModule):
    def __init__(self, config: TransformerSeq2SeqConfig,
                 params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.config = config
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = self.init(generator)
        self._hold(params, device)

    def init(self, gen: torch.Generator) -> dict:
        """A fresh params tree with the JAX package's keys and shapes, drawn
        from ``gen`` (a CPU generator)."""
        cfg = self.config
        D, Fd = cfg.d_model, cfg.d_ff

        def ln():
            return {"scale": torch.ones(D), "bias": torch.zeros(D)}

        def attn():
            return {n: _init_linear(gen, D, D) for n in "qkvo"}

        def ffn():
            return {"w1": _init_linear(gen, D, Fd),
                    "w2": _init_linear(gen, Fd, D)}

        def enc_layer():
            return {"ln1": ln(), "attn": attn(), "ln2": ln(), "ffn": ffn()}

        def dec_layer():
            return {"ln1": ln(), "self": attn(), "ln2": ln(),
                    "cross": attn(), "ln3": ln(), "ffn": ffn()}

        scale = 1.0 / math.sqrt(D)
        return {
            "src_embed": _randn(gen, (cfg.src_vocab, D), scale),
            "tgt_embed": _randn(gen, (cfg.tgt_vocab, D), scale),
            "enc": [enc_layer() for _ in range(cfg.num_layers)],
            "dec": [dec_layer() for _ in range(cfg.num_layers)],
            "enc_ln": ln(),
            "dec_ln": ln(),
            "logit": _init_linear(gen, D, cfg.tgt_vocab),
        }

    def encode(self, src_ids, src_mask, params=None):
        cfg = self.config
        p = params if params is not None else self.param_tree()
        x = p["src_embed"][src_ids]
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.device)[None]
        attn_mask = (src_mask[:, None, :] > 0).expand(-1, x.shape[1], -1)
        for layer in p["enc"]:
            h = _layer_norm(layer["ln1"], x)
            x = x + _mha(layer["attn"], h, h, attn_mask, cfg.num_heads)
            x = x + _ffn(layer["ffn"], _layer_norm(layer["ln2"], x))
        return _layer_norm(p["enc_ln"], x)

    def _decode(self, p, encoded, src_mask, tgt_in, tgt_mask):
        """tgt_in [B, T] -> logits [B, T, V] (causal)."""
        cfg = self.config
        B, T = tgt_in.shape
        x = p["tgt_embed"][tgt_in]
        x = x + _sinusoid(T, cfg.d_model, x.device)[None]
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                       device=x.device))
        self_mask = causal[None] & (tgt_mask[:, None, :] > 0)
        cross_mask = (src_mask[:, None, :] > 0).expand(
            B, T, src_mask.shape[1])
        for layer in p["dec"]:
            h = _layer_norm(layer["ln1"], x)
            x = x + _mha(layer["self"], h, h, self_mask, cfg.num_heads)
            x = x + _mha(layer["cross"], _layer_norm(layer["ln2"], x),
                         encoded, cross_mask, cfg.num_heads)
            x = x + _ffn(layer["ffn"], _layer_norm(layer["ln3"], x))
        return linear(p["logit"], _layer_norm(p["dec_ln"], x))

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


def decode_step(model, state, token):
    """One incremental step of a prefix-rerunning decoder (the transformer
    and T5 parsers): write ``token`` at ``pos``, decode the whole buffer
    with keys up to ``pos`` visible, return the logits at ``pos``."""
    pos = state["pos"]
    tokens = state["tokens"].clone()
    tokens[:, pos] = token
    T = model.config.max_tgt_len
    tgt_mask = (torch.arange(T, device=tokens.device) <= pos).float()
    tgt_mask = tgt_mask[None].expand(tokens.shape[0], T)
    logits = model._decode(model.param_tree(), state["encoded"],
                           state["src_mask"], tokens, tgt_mask)
    return dict(state, tokens=tokens, pos=pos + 1), logits[:, pos, :]
