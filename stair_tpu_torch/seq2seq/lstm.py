"""Attention LSTM encoder-decoder, the fairseq-class program parser (port of
``stair_tpu/seq2seq/lstm.py``).

BiLSTM encoder over question tokens; unidirectional LSTM decoder with dot
attention over the encoder states. The parameters are the JAX package's
tree key path by key path (``weights.ParamModule``), so a params tree of
either package loads in the other.

The encoder is the batched BiLSTM of ``ops/lstm.py``: ``bilstm_forward``
(kernel #1 on the card) when gradients are off, ``bilstm_forward_train``
(the training forward #2 with its state stacks and the backward #3) when
they are on; on CPU tensors both run their plain versions. The JAX
package runs ``jax.vmap(bilstm)``, the same function on the batch. The
decoder cell, the attention and the projections (``init_state``, ``step``,
``logits``) are plain torch ops, as they lie outside any kernel in JAX.
Exposes the incremental-decode interface ``seq2seq/beam.py`` expects:
``encode``, ``init_state``, ``step``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stair_tpu_torch.models.modules import _init_linear, _uniform, linear
from stair_tpu_torch.ops.lstm import (
    bilstm_forward,
    bilstm_forward_train,
    init_lstm_params,
)
from stair_tpu_torch.weights import ParamModule, tree_map


@dataclass(frozen=True)
class LSTMSeq2SeqConfig:
    src_vocab: int
    tgt_vocab: int
    embed_dim: int = 256
    hidden: int = 256
    max_src_len: int = 32
    max_tgt_len: int = 48


class LSTMSeq2Seq(ParamModule):
    def __init__(self, config: LSTMSeq2SeqConfig, params: dict | None = None,
                 *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.config = config
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = self.init(generator)
        self._hold(params, device)

    def init(self, gen: torch.Generator) -> dict:
        """A fresh params tree with the JAX package's keys and shapes, drawn
        from ``gen`` (a CPU generator; the numbers differ from
        ``jax.random``'s)."""
        cfg = self.config
        E, H = cfg.embed_dim, cfg.hidden
        return {
            "src_embed": _uniform(gen, (cfg.src_vocab, E), 0.1),
            "tgt_embed": _uniform(gen, (cfg.tgt_vocab, E), 0.1),
            "encoder": init_lstm_params(gen, E, H // 2),
            # decoder input: embedding + previous context
            "decoder": init_lstm_params(gen, E + H, H)["fwd"],
            "attn_proj": _init_linear(gen, H, H),
            "out_proj": _init_linear(gen, 2 * H, H),
            "logit": _init_linear(gen, H, cfg.tgt_vocab),
        }

    # -- encoder -------------------------------------------------------------

    def encode(self, src_ids, src_mask):
        """[B, S] -> encoder states [B, S, H]."""
        p = self.param_tree()
        emb = p["src_embed"][src_ids]
        if torch.is_grad_enabled():
            return bilstm_forward_train(p["encoder"], emb, src_mask)[0]
        # the eval kernel takes detached tensors
        enc = tree_map(lambda t: t.detach(), p["encoder"])
        return bilstm_forward(enc, emb, src_mask)[0]

    def init_state(self, encoded, src_mask):
        B = encoded.shape[0]
        zeros = encoded.new_zeros(B, self.config.hidden)
        return {"h": zeros, "c": zeros, "ctx": zeros, "encoded": encoded,
                "src_mask": src_mask}

    # -- one decode step -----------------------------------------------------

    def step(self, state, token, params=None):
        """token [B] -> (new_state, logits [B, V])."""
        p = params if params is not None else self.param_tree()
        emb = p["tgt_embed"][token]                            # [B, E]
        x = torch.cat([emb, state["ctx"]], dim=-1)
        d = p["decoder"]
        gates = x @ d["wi"] + d["bi"] + d["bh"] + state["h"] @ d["wh"]
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * state["c"] + i * torch.tanh(g)
        h = o * torch.tanh(c)

        # Dot attention over encoder states.
        query = linear(p["attn_proj"], h)                      # [B, H]
        scores = torch.einsum("bh,bsh->bs", query, state["encoded"])
        scores = torch.where(state["src_mask"] > 0, scores,
                             torch.full_like(scores, -torch.inf))
        w = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bs,bsh->bh", w, state["encoded"])

        out = torch.tanh(linear(p["out_proj"], torch.cat([h, ctx], dim=-1)))
        logits = linear(p["logit"], out)
        return dict(state, h=h, c=c, ctx=ctx), logits

    # -- teacher-forced training ---------------------------------------------

    def logits(self, src_ids, src_mask, tgt_in):
        """Teacher forcing: tgt_in [B, T] (BOS-shifted) -> logits [B, T, V]."""
        p = self.param_tree()
        state = self.init_state(self.encode(src_ids, src_mask), src_mask)
        out = []
        for t in range(tgt_in.shape[1]):
            state, logits = self.step(state, tgt_in[:, t], p)
            out.append(logits)
        return torch.stack(out, dim=1)
