"""Batched beam search over the incremental seq2seq interface (port of
``stair_tpu/seq2seq/beam.py``).

A Python loop over ``max_len`` steps with a static beam width; works with
any model exposing ``encode`` / ``init_state`` / ``step`` (the LSTM,
transformer and T5 parsers). Finished beams are frozen by forcing PAD
continuations at zero cost, matching fairseq-style n-best output (the
reference decodes beam=5, n-best=5, hf_program_parser.py:180-205).

Ties are broken as the JAX package breaks them: ``lax.top_k`` and
``jnp.argsort`` keep the lower index first, which a stable sort does
(``torch.topk`` leaves the order of ties unspecified).
"""

from __future__ import annotations

import torch

from stair_tpu_torch.seq2seq.vocab import BOS, EOS, PAD

NEG_INF = -1e30


def _reorder(state, rows, n):
    """Index every tensor of ``state`` whose leading axis has ``n`` rows."""
    return {k: v[rows] if torch.is_tensor(v) and v.dim() >= 1
            and v.shape[0] == n else v for k, v in state.items()}


@torch.no_grad()
def beam_search(model, src_ids, src_mask, beam_size=5, max_len=48,
                bos=BOS, eos=EOS, pad=PAD):
    """Returns (tokens [B, K, max_len] int32, scores [B, K]) sorted
    best-first.

    ``bos``/``eos``/``pad`` default to the word-level parser vocabulary;
    pretrained T5 decodes with bos=pad=0, eos=1 (sentencepiece convention).
    """
    B = src_ids.shape[0]
    K = beam_size
    V = model.config.tgt_vocab
    dev = src_ids.device

    encoded = model.encode(src_ids, src_mask)
    state = model.init_state(encoded.repeat_interleave(K, dim=0),
                             src_mask.repeat_interleave(K, dim=0))

    scores = torch.full((B, K), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    tokens = torch.full((B, K, max_len), pad, dtype=torch.int32, device=dev)
    prev = torch.full((B * K,), bos, dtype=torch.long, device=dev)
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    # Finished beams may only extend with PAD, for free.
    pad_only = torch.full((V,), NEG_INF, device=dev)
    pad_only[pad] = 0.0
    base = (torch.arange(B, device=dev) * K)[:, None]

    for t in range(max_len):
        state, logits = model.step(state, prev)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        logp = torch.where(finished[:, :, None], pad_only, logp)

        total = scores[:, :, None] + logp                      # [B, K, V]
        flat = total.reshape(B, K * V)
        top, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        scores, flat_idx = top[:, :K], idx[:, :K]              # [B, K]
        parent = flat_idx // V
        token = flat_idx % V

        # Reorder beam-major state rows.
        state = _reorder(state, (base + parent).reshape(-1), B * K)
        tokens = torch.gather(
            tokens, 1, parent[:, :, None].expand(B, K, max_len)).clone()
        tokens[:, :, t] = token.to(torch.int32)
        finished = torch.gather(finished, 1, parent) | (token == eos)
        prev = token.reshape(-1)

    order = torch.argsort(-scores, dim=1, stable=True)
    scores = torch.gather(scores, 1, order)
    tokens = torch.gather(tokens, 1, order[:, :, None].expand(B, K, max_len))
    return tokens, scores
