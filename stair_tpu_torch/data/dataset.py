"""Supervision constants, gold-attention rasterisation, video features.

The port's own copy of what its ported paths use from
``stair_tpu/data/dataset.py``: the ``SUP_*`` supervision channel codes
(read by ``train/losses.py``), ``span_to_attention`` (the numpy
fallback of ``runtime.loader.span_to_attention_batch``) and
``load_video_features`` (read by ``llm/with_video_lm.py``). The batcher
(``AGQADataset``, ``collate``, the device tables) comes with the trainer
CLI and is not copied yet.
"""

from __future__ import annotations

import math
import os

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


# ---------------------------------------------------------------------------
# Video features
# ---------------------------------------------------------------------------

def load_video_features(
    appearance_path: str,
    motion_path: str | None,
    video_ids: set[str],
    max_video_length: int,
    str2num: dict | None = None,
) -> dict[str, np.ndarray]:
    """Preload per-video features, in the reference's two regimes:

    * npy directory (I3D): stride-2 temporal subsample then truncate;
    * h5 file: ``resnet_features`` mean over the clip axis, optional
      ``resnext_features`` motion concat.
    """
    feats: dict[str, np.ndarray] = {}
    if os.path.isdir(appearance_path):
        for fname in os.listdir(appearance_path):
            vid = fname.split(".")[0]
            if vid not in video_ids:
                continue
            arr = np.load(os.path.join(appearance_path, fname))
            arr = arr[::2][:max_video_length]
            feats[vid] = np.squeeze(np.asarray(arr, dtype=np.float32))
    elif os.path.isfile(appearance_path):
        import h5py

        with h5py.File(appearance_path, "r") as f:
            ids = {id_: i for i, id_ in enumerate(f["ids"][()])}
            for vid, num in (str2num or {}).items():
                if vid not in video_ids:
                    continue
                arr = f["resnet_features"][ids[num]][:max_video_length]
                feats[vid] = np.asarray(arr, dtype=np.float32).mean(axis=1)
    else:
        raise ValueError("appearance feature path not found: %s"
                         % appearance_path)

    if motion_path is not None and os.path.isfile(motion_path):
        import h5py

        with h5py.File(motion_path, "r") as f:
            ids = {id_: i for i, id_ in enumerate(f["ids"][()])}
            for vid, num in (str2num or {}).items():
                if vid in feats:
                    arr = f["resnext_features"][ids[num]][:max_video_length]
                    feats[vid] = np.concatenate(
                        [feats[vid], np.asarray(arr, dtype=np.float32)],
                        axis=-1)
    return feats
