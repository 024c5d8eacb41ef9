"""Port parity: the Video-ChatGPT serving path (stair_tpu_torch/llm/
videochat.py, videochat_infer.py).

``spatio_temporal_pool`` on both sides of ``max_temporal``, ``splice_embeds``
and ``VideoChatModel.forward`` logits against the JAX package at atol 1e-4
(float32, rows below ``valid_len``), and ``video_chatgpt_infer_batch`` end
to end at the air-gapped tiny configuration with the JAX model's weights
and greedy decoding: the same token ids and the same strings. The
consistency flow encodes each video once; the CLI writes its JSON from a
directory of tiny synthetic videos when a video encoder is importable.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from stair_tpu_torch.llm import videochat as TV
from stair_tpu_torch.llm import videochat_infer as TI
from stair_tpu_torch.weights import params_from_numpy, params_to_numpy
from torch_port_util import assert_trees_equal, to_numpy_tree, tree_shapes

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.llm import videochat as JV
    from stair_tpu.llm import videochat_infer as JI
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

ARGS = dict(model_path=None, vision_path=None, model_ckpt=None, device="cpu")
QUESTIONS = ["what did they do ?", "question video", "what video ?"]


def _pair():
    """The air-gapped tiny models: JAX (model, params, tokenizer) and the
    port's (model, tokenizer) holding the JAX weights."""
    jmodel, params, jtok = JI.initialize_model(argparse.Namespace(**ARGS))
    model, tok = TI.initialize_model(argparse.Namespace(**ARGS))
    port = TV.VideoChatModel(model.config,
                             params_from_numpy(to_numpy_tree(params)))
    return jmodel, params, jtok, port, tok


def _frame_sets(n, T=6, size=56):
    return [np.random.RandomState(i).randint(0, 255, (T, size, size, 3))
            .astype(np.uint8) for i in range(n)]


@needs_jax
@pytest.mark.parametrize("t", [5, 20, 31], ids=lambda t: f"T{t}")
def test_spatio_temporal_pool(t):
    feats = np.random.RandomState(t).randn(t, 16, 8).astype(np.float32)
    ref = np.asarray(JV.spatio_temporal_pool(jnp.asarray(feats), 20))
    out = TV.spatio_temporal_pool(torch.from_numpy(feats), 20).numpy()
    assert out.shape == ref.shape == (36, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@needs_jax
def test_tiny_model_matches_jax_config_and_tree():
    jmodel, params, jtok, port, tok = _pair()
    assert port.config.video_token_len == jmodel.config.video_token_len == 36
    assert port.config.decoder.to_dict() == jmodel.config.decoder.__dict__
    assert port.config.vision.to_dict() == jmodel.config.vision.__dict__
    assert tok.word2id == jtok.word2id
    fresh, _ = TI.initialize_model(argparse.Namespace(**ARGS))
    assert tree_shapes(params_to_numpy(fresh)) == tree_shapes(params)
    assert_trees_equal(to_numpy_tree(params), params_to_numpy(port))
    for name in ("DEFAULT_VIDEO_TOKEN", "DEFAULT_VIDEO_PATCH_TOKEN",
                 "DEFAULT_VID_START_TOKEN", "DEFAULT_VID_END_TOKEN"):
        assert getattr(TV, name) == getattr(JV, name)
    assert (TV.build_video_prompt("q ?", 3, True)
            == JV.build_video_prompt("q ?", 3, True))
    assert (TV.build_video_prompt("q ?", 3, False)
            == JV.build_video_prompt("q ?", 3, False))


def _inputs(port, B=3, L=64, seed=0):
    rng = np.random.RandomState(seed)
    V = port.config.video_token_len
    ids = rng.randint(0, 512, (B, L)).astype(np.int32)
    video = rng.randn(B, V, port.config.vision.d_model).astype(np.float32)
    start = np.array([2, 9, 0], np.int32)[:B]
    valid = np.array([64, 50, 41], np.int32)[:B]
    return ids, video, start, valid


@needs_jax
def test_encode_video_and_splice_embeds():
    jmodel, params, _, port, _ = _pair()
    frames = np.random.RandomState(0).randn(6, 56, 56, 3).astype(np.float32)
    ref = np.asarray(jmodel.encode_video(params, jnp.asarray(frames)))
    out = port.encode_video(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    ids, video, start, _ = _inputs(port)
    ref = np.asarray(jmodel.splice_embeds(
        params, jnp.asarray(ids), jnp.asarray(video), jnp.asarray(start)))
    with torch.no_grad():
        out = port.splice_embeds(torch.from_numpy(ids).long(),
                                 torch.from_numpy(video),
                                 torch.from_numpy(start)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@needs_jax
def test_forward_logits():
    jmodel, params, _, port, _ = _pair()
    ids, video, start, valid = _inputs(port)
    ref = np.asarray(jmodel.forward(
        params, jnp.asarray(ids), jnp.asarray(video), jnp.asarray(start),
        jnp.asarray(valid)))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long(), torch.from_numpy(video),
                   torch.from_numpy(start), torch.from_numpy(valid)).numpy()
    for b, nv in enumerate(valid):
        np.testing.assert_allclose(out[b, :nv], ref[b, :nv], rtol=1e-4,
                                   atol=1e-4)


@needs_jax
@pytest.mark.parametrize("conv_mode", ["video-chatgpt_v1", "simple"])
def test_infer_batch_end_to_end_greedy(conv_mode):
    jmodel, params, jtok, port, tok = _pair()
    frames = _frame_sets(3)
    ref = JI.video_chatgpt_infer_batch(
        jmodel, params, jtok, QUESTIONS, frames, conv_mode=conv_mode,
        max_new_tokens=12, temperature=0.0)
    out = TI.video_chatgpt_infer_batch(
        port, tok, QUESTIONS, frames, conv_mode=conv_mode,
        max_new_tokens=12, temperature=0.0)
    assert out == ref
    assert len(out) == 3 and all(isinstance(s, str) for s in out)


@needs_jax
def test_generate_token_ids_match_jax():
    jmodel, params, _, port, _ = _pair()
    ids, video, start, _ = _inputs(port, L=128)
    plen = np.array([60, 45, 38], np.int32)
    ref = np.asarray(jmodel.generate(
        params, jnp.asarray(ids), jnp.asarray(video), jnp.asarray(start),
        jnp.asarray(plen), max_new_tokens=10, temperature=0.0, eos_id=1))
    out = port.generate(torch.from_numpy(ids).long(), torch.from_numpy(video),
                        torch.from_numpy(start), torch.from_numpy(plen),
                        max_new_tokens=10, temperature=0.0, eos_id=1)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampled_inference_repeats_with_the_default_generator():
    model, tok = TI.initialize_model(argparse.Namespace(**ARGS))
    frames = _frame_sets(2)
    a = TI.video_chatgpt_infer_batch(model, tok, QUESTIONS[:2], frames,
                                     max_new_tokens=6)
    b = TI.video_chatgpt_infer_batch(model, tok, QUESTIONS[:2], frames,
                                     max_new_tokens=6)
    assert a == b


def test_keywords_stopping_truncates():
    stop = TV.KeywordsStoppingCriteria(["</s>", "###"], None, 0)
    assert stop.truncate(" a b </s> c ### d") == "a b"
    assert stop.truncate("a b") == "a b"


def test_model_ckpt_is_refused_with_a_clear_error():
    with pytest.raises(NotImplementedError, match="not ported"):
        TI.initialize_model(argparse.Namespace(**{**ARGS,
                                                  "model_ckpt": "/x"}))


def _cli_args(tmp_path, samples, extra=()):
    gt = tmp_path / "gt.json"
    gt.write_text(json.dumps(samples))
    return ["--video-dir", str(tmp_path), "--gt-file", str(gt),
            "--output-dir", str(tmp_path / "out"), "--device", "cpu",
            "--num-frames", "4", "--batch-size", "2", *extra]


def test_consistency_flow_encodes_each_video_once(tmp_path, monkeypatch):
    for name in ("a.mp4", "b.mp4", "c.mp4"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setattr(
        TI, "load_video_frames",
        lambda path, n: _frame_sets(1, T=n)[0])
    calls = []
    real = TV.VideoChatModel.encode_video
    monkeypatch.setattr(
        TV.VideoChatModel, "encode_video",
        lambda self, frames: calls.append(1) or real(self, frames))
    samples = [{"video_name": n, "Q1": "what did they do ?",
                "Q2": "what video ?"} for n in ("a", "b", "c", "missing")]
    TI.main(_cli_args(tmp_path, samples, ["--consistency"]))
    with open(tmp_path / "out" / "preds.json") as f:
        results = json.load(f)
    assert len(results) == 3 and len(calls) == 3
    assert all({"pred1", "pred2", "Q1"} <= set(r) for r in results)


def test_cli_main_writes_predictions_from_video_files(tmp_path):
    cv2 = pytest.importorskip("cv2")
    names = []
    for i in range(3):
        path = str(tmp_path / f"v{i}.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5,
                                 (64, 48))
        if not writer.isOpened():
            pytest.skip("no MJPG encoder in this OpenCV build")
        for frame in _frame_sets(1, T=8, size=64)[0]:
            writer.write(np.ascontiguousarray(frame[:48]))
        writer.release()
        names.append(os.path.basename(path))
    samples = [{"video_name": n, "question": "what did they do ?",
                "answer": "x", "id": i + 1} for i, n in enumerate(names)]
    TI.main(_cli_args(tmp_path, samples))
    with open(tmp_path / "out" / "preds.json") as f:
        results = json.load(f)
    assert [r["id"] for r in results] == [1, 2, 3]
    assert all(isinstance(r["pred"], str) for r in results)
