"""Host-side video decode + uniform frame sampling.

Replaces the reference's decord pipeline
(yellow-binary-tree/STAIR ``video_chatgpt/eval/model_utils.py:35-102``) with
whatever decoder the host has: decord when installed, else OpenCV, else
imageio. Sampling semantics match ``get_seq_frames``: n segments over the
clip, the center... start frame of each segment.
"""

from __future__ import annotations

import numpy as np


def uniform_frame_indices(total: int, num: int) -> list[int]:
    """Start-of-segment uniform sampling (ref model_utils.py:78-102)."""
    seg = float(total - 1) / num
    return [int(np.round(seg * i)) for i in range(num)]


def load_video_frames(path: str, num_frames: int = 100) -> np.ndarray:
    """Decode a video file -> [num_frames, H, W, 3] uint8."""
    try:
        import decord

        vr = decord.VideoReader(path, num_threads=1)
        idx = uniform_frame_indices(len(vr), num_frames)
        return vr.get_batch(idx).asnumpy()
    except ImportError:
        pass
    try:
        import cv2

        cap = cv2.VideoCapture(path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        wanted = set(uniform_frame_indices(max(total, 1), num_frames))
        frames, i = [], 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if i in wanted:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            i += 1
        cap.release()
        if frames:
            while len(frames) < num_frames:
                frames.append(frames[-1])
            return np.stack(frames[:num_frames])
    except ImportError:
        pass
    import imageio.v3 as iio

    video = iio.imread(path)
    idx = uniform_frame_indices(len(video), num_frames)
    return np.stack([video[i] for i in idx])
