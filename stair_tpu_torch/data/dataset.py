"""Supervision constants and gold-attention rasterisation.

The port's own copy of what its ported paths use from
``stair_tpu/data/dataset.py``: the ``SUP_*`` supervision channel codes
(read by ``train/losses.py``) and ``span_to_attention`` (the numpy
fallback of ``runtime.loader.span_to_attention_batch``). The batcher
(``AGQADataset``, ``collate``, the device tables) comes with the trainer
CLI and is not copied yet.
"""

from __future__ import annotations

import math

import numpy as np


def span_to_attention(gold: tuple, num_frames: int) -> np.ndarray:
    """Fractional frame interval -> per-frame weight vector.
    Exact port of the reference semantics (train_module.py:67-81)."""
    out = np.zeros((num_frames,), dtype=np.float32)
    start = min(num_frames - 0.002, max(0.001, gold[0]))
    end = min(num_frames - 0.001, gold[1])
    s_int, e_int = math.ceil(start), math.floor(end)
    if s_int < e_int:
        out[s_int:e_int] += 1.0
    if s_int <= e_int:
        out[s_int - 1] += s_int - start
        out[e_int] += end - e_int
    else:
        out[e_int] += end - start
    return out


# Supervision channel codes (routing inside the loss).
(SUP_NONE, SUP_BOOL, SUP_EQUALS, SUP_ATTN1, SUP_ATTN2, SUP_CONTRAST,
 SUP_FRAME) = range(7)
