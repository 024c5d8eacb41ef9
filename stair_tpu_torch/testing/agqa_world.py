"""A synthetic AGQA world on disk, preprocessed and split, for the NMN
trainer and evaluate CLIs: what ``chip_smoke.py`` phase 18 and the tests
train on.

``write_agqa_world`` runs ``testing/synthetic.make_world``, converts every
question with ``programs/preprocess.convert_split`` (the symbolic executor
of ``programs/scene_graph.py`` joins the gold step results) and writes the
70 / 15 / 15 splits as ``out/{train,valid,test}.pkl``, the ``.pkl`` files
the trainer reads. ``trainer_argv`` gives the CLI words for it.
"""

from __future__ import annotations

import json
import os
import pickle


def write_agqa_world(root, synthetic=None, preprocess=None, scene_graph=None,
                     **world_kw):
    """A synthetic AGQA world under ``root`` (``make_world(**world_kw)``),
    converted and split 70 / 15 / 15 into ``out/{train,valid,test}.pkl``,
    plus ``filter_answers.json`` (40 vocabulary words for the Filter
    audit). The three modules default to the port's copies; a test hands
    the JAX package's, which write what a user of its preprocess has on
    disk. Returns make_world's paths with ``train``, ``valid``, ``test``,
    ``vocab`` and ``filter`` added."""
    if synthetic is None:
        from stair_tpu_torch.testing import synthetic
    if preprocess is None:
        from stair_tpu_torch.programs import preprocess
    if scene_graph is None:
        from stair_tpu_torch.programs import scene_graph

    root = str(root)
    w = synthetic.make_world(root, **world_kw)
    with open(w["questions"]) as f:
        qs = json.load(f)
    preprocess.set_executor(scene_graph.SceneGraphExecutor(
        w["scene_graphs"], w["id2word"], w["word2id"]))
    recs = preprocess.convert_split([dict(r, qa_id=k) for k, r in qs.items()])
    out = os.path.join(root, "out")
    os.makedirs(out, exist_ok=True)
    n = len(recs)
    parts = {"train": recs[: int(n * 0.7)],
             "valid": recs[int(n * 0.7): int(n * 0.85)],
             "test": recs[int(n * 0.85):]}
    paths = dict(w)
    for name, part in parts.items():
        paths[name] = os.path.join(out, f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(part, f)
    paths["vocab"] = os.path.join(out, "vocab.json")
    paths["filter"] = os.path.join(root, "filter_answers.json")
    with open(w["id2word"]) as f:
        words = sorted(set(json.load(f).values()))[:40]
    with open(paths["filter"], "w") as f:
        json.dump(words, f)
    return paths


def data_argv(w, output, *extra):
    """The trainer / evaluate CLI words that name a world from
    ``write_agqa_world`` and the output directory, and nothing else: with
    them alone the CLIs run at their own defaults (``train/args.py``)."""
    return ["--rgb-path", w["features"], "--glove-filename", w["glove"],
            "--train-filename", w["train"], "--valid-filename", w["valid"],
            "--test-filename", w["test"], "--video-secs-path",
            w["video_secs"], "--word2id-filename", w["word2id"],
            "--vocab-filename", w["vocab"], "--output", str(output), *extra]


def trainer_argv(w, output, *extra, hidden=32, video=64, frames=24,
                 batch=16):
    """The trainer / evaluate CLI words (the JAX CLIs' flags) for a world
    from ``write_agqa_world``, writing under ``output``."""
    return data_argv(w, output, "--video-size", str(video), "--hidden-size",
                     str(hidden), "--max-video-length", str(frames),
                     "--batch-size", str(batch), *extra)
