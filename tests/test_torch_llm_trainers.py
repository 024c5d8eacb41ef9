"""Port parity: the two LLM trainers (stair_tpu_torch/llm/videochat_train.py,
with_video_lm.py, optim.py).

On the seeded tiny data of ``testing/videochat.py``: ``build_example``,
``SFTData.batches`` and ``VideoLMData.batches`` array for array against the
JAX package; the schedules value for value against optax; three optimizer
steps of each trainer's step against the JAX trainer's (``optax.adamw``
with and without decay, the projector-only mask): losses at 1e-5 relative
and every parameter within 2e-2 of the learning rate (Adam normalises each
element's step, so an element moves by about the rate per step whatever
its gradient's size; a gradient that is 0 but for rounding, the key bias of
the GPT-2 family, is left out). Each CLI runs end to end on the CPU: train,
save, reload, evaluate; a projector-only checkpoint saved by the JAX
package loads into the port's ``videochat_infer``.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from stair_tpu_torch.llm import optim as TO
from stair_tpu_torch.llm import video_prefix as TP
from stair_tpu_torch.llm import videochat_infer as TI
from stair_tpu_torch.llm import videochat_train as TT
from stair_tpu_torch.llm import with_video_lm as TW
from stair_tpu_torch.testing import videochat as TD
from stair_tpu_torch.train.args import build_parser
from stair_tpu_torch.weights import flatten_tree, params_to_numpy
from torch_port_util import to_numpy_tree

try:
    import jax
    import jax.numpy as jnp
    import optax

    from stair_tpu.llm import video_prefix as JP
    from stair_tpu.llm import videochat_infer as JI
    from stair_tpu.llm import videochat_train as JT
    from stair_tpu.llm import with_video_lm as JW
    from stair_tpu.train.args import build_parser as jax_build_parser
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

LR = 1e-3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return TD.write_tiny_data(str(tmp_path_factory.mktemp("tiny")),
                              video_token_len=26, vision_dim=16)


def _texts(conv_path):
    with open(conv_path) as f:
        return [m["value"] for s in json.load(f) for m in s["conversations"]]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("steps", [2, 10, 100])
def test_warmup_cosine_schedule_matches_optax(steps):
    warm = max(1, int(0.03 * steps))
    want = optax.warmup_cosine_decay_schedule(0.0, 2e-5, warm, steps)
    got = TO.warmup_cosine_decay_schedule(0.0, 2e-5, warm, steps)
    for i in range(steps + 3):
        assert abs(got(i) - float(want(i))) <= 1e-11, i


@needs_jax
def test_linear_schedule_matches_optax_and_one_step_cosine_is_refused():
    want, got = optax.linear_schedule(2e-4, 0.0, 7), TO.linear_schedule(
        2e-4, 0.0, 7)
    for i in range(10):
        assert abs(got(i) - float(want(i))) <= 1e-11, i
    with pytest.raises(ValueError, match="positive decay_steps"):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 1)
    with pytest.raises(ValueError, match="positive decay_steps"):
        TO.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("max_len", [160, 64], ids=["fits", "cut"])
def test_build_example_matches_jax(tiny, max_len):
    texts = _texts(tiny["conv"])
    jtok, tok = JP.SimpleTokenizer.build(texts), TP.SimpleTokenizer.build(
        texts)
    with open(tiny["conv"]) as f:
        samples = json.load(f)
    samples.append({"conversations": [      # no video, starts with the reply
        {"from": "gpt", "value": "yes ."},
        {"from": "human", "value": "where is the laptop ?"},
        {"from": "gpt", "value": "the answer is door ."}]})
    for s in samples:
        want = JT.build_example(s, jtok, "video-chatgpt_v1", 26, max_len)
        got = TT.build_example(s, tok, "video-chatgpt_v1", 26, max_len)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert (got[1] >= 0).any() or max_len == 64


@needs_jax
@pytest.mark.parametrize("shuffle", [False, True])
def test_sft_batches_match_jax(tiny, shuffle):
    texts = _texts(tiny["conv"])
    args = (tiny["conv"], tiny["chat_features"])
    rest = ("video-chatgpt_v1", 26, 16, 64)
    jdata = JT.SFTData(*args, JP.SimpleTokenizer.build(texts), *rest)
    data = TT.SFTData(*args, TP.SimpleTokenizer.build(texts), *rest)
    assert len(data) == len(jdata) == 16
    want = list(jdata.batches(5, shuffle=shuffle, seed=3))
    got = list(data.batches(5, shuffle=shuffle, seed=3))
    assert len(want) == len(got) == 3
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)
            assert a[k].dtype == b[k].dtype, k
    assert np.abs(got[0]["video_tokens"]).sum() > 0


def _lm_args(tiny, parser, lm_model, extra=()):
    return parser.parse_args([
        "--rgb-path", tiny["rgb"], "--train-filename", tiny["train"],
        "--valid-filename", tiny["valid"], "--test-filename", tiny["test"],
        "--lm-model", lm_model, "--hidden-size", "32",
        "--max-video-length", "8", "--tokenizer-max-length", "20",
        "--batch-size", "5", "--gpt-filter-result-path", tiny["filter"],
        *extra])


@needs_jax
@pytest.mark.parametrize("lm_model", ["VideoGPT", "Llama"])
def test_video_lm_batches_match_jax(tiny, lm_model):
    jdata = JW.VideoLMData(_lm_args(tiny, jax_build_parser(), lm_model),
                           "train")
    data = TW.VideoLMData(_lm_args(tiny, build_parser(), lm_model), "train")
    assert data.questions == jdata.questions
    assert any(q.startswith("before opening the door.") for q in
               data.questions)
    assert data.tokenizer.word2id == jdata.tokenizer.word2id
    assert data.video_size == jdata.video_size == 32
    want = list(jdata.batches(5, 20, 8, shuffle=True, seed=2))
    got = list(data.batches(5, 20, 8, shuffle=True, seed=2))
    assert len(want) == len(got) == 4
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], k)
            else:
                assert a[k] == b[k], k
    only = TW.load_records(tiny["train"], novel_comp=1, more_steps=0)
    assert only == JW.load_records(tiny["train"], novel_comp=1, more_steps=0)
    assert 0 < len(only) < len(data)
    assert TW.load_filter_outputs(None, "train") is None
    assert (TW.load_filter_outputs(tiny["filter"], "valid")
            == JW.load_filter_outputs(tiny["filter"], "valid"))


# ---------------------------------------------------------------------------
# three optimizer steps
# ---------------------------------------------------------------------------

def _params_close(want, got, lr, skip=()):
    want, got = flatten_tree(want), flatten_tree(got)
    assert want.keys() == got.keys()
    for k in want:
        if any(k.endswith(s) for s in skip):
            continue
        err = float(np.abs(np.asarray(want[k]) - got[k]).max())
        assert err <= 2e-2 * lr, (k, err)


def _jax_steps(loss_fn, params, optimizer, batch, n=3):
    opt_state = optimizer.init(params)
    losses = []
    for _ in range(n):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return params, losses


@needs_jax
@pytest.mark.parametrize("projector_only", [False, True],
                         ids=["full", "projector-only"])
def test_sft_step_matches_optax(projector_only):
    from test_torch_llm_losses import _chat_pair, _sft_batch

    jmodel, params, port = _chat_pair()
    batch = _sft_batch(seed=4)
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 10)
    optimizer = optax.adamw(schedule, weight_decay=0.0)
    if projector_only:
        # The frozen leaves are held still here. (The JAX trainer wraps its
        # optimizer in ``optax.masked`` alone, which hands the frozen
        # leaves their raw gradients as updates; the port freezes them, as
        # the recipe says.)
        optimizer = optax.multi_transform(
            {"tune": optimizer, "freeze": optax.set_to_zero()},
            lambda p: {k: jax.tree_util.tree_map(
                lambda _: "tune" if k == "mm_projector" else "freeze", v)
                for k, v in p.items()})
    before = to_numpy_tree(params)
    want, want_losses = _jax_steps(
        lambda p, b: jmodel.sft_loss(p, b), params, optimizer,
        {k: jnp.asarray(v) for k, v in batch.items()})
    step = TT.make_sft_step(port, TO.make_adamw(
        TT.trainable_parameters(port, projector_only),
        TO.warmup_cosine_decay_schedule(0.0, LR, 1, 10), weight_decay=0.0))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = [float(step(tbatch)) for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)  # lr(0) = 0
    assert losses[2] < losses[1]
    got = params_to_numpy(port)
    _params_close(to_numpy_tree(want), got, LR)
    moved = {k for k, v in flatten_tree(got).items()
             if not np.array_equal(v, flatten_tree(before)[k])}
    if projector_only:
        assert moved == {"mm_projector/w", "mm_projector/b"}
    else:
        assert "decoder/layers/0/q/w" in moved and "mm_projector/w" in moved
        assert not any(k.startswith("vision/") for k in moved)


@needs_jax
@pytest.mark.parametrize("family,weight", [("gpt2", 0), ("gpt2", 1),
                                           ("llama-gqa", 1)])
def test_video_lm_step_matches_optax(family, weight):
    from test_torch_llm_losses import _prefix_batch, _prefix_pair

    jmodel, params, port = _prefix_pair(family)
    batch = _prefix_batch(seed=5)

    def loss_fn(p, b):
        loss, _ = jmodel.reply_loss(p, b)
        if weight:
            loss = loss + weight * jmodel.video_loss(p, b)
        return loss

    want, want_losses = _jax_steps(
        loss_fn, params, optax.adamw(optax.linear_schedule(LR, 0.0, 6)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    step = TW.make_lm_step(port, TO.make_adamw(
        port.parameters(), TO.linear_schedule(LR, 0.0, 6),
        weight_decay=1e-4), weight)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = [float(step(tbatch)) for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[2] < losses[0]
    _params_close(to_numpy_tree(want), params_to_numpy(port), LR,
                  skip=("/k/b",))
    if not weight:      # no video loss: its head got no gradient, only decay
        w0 = np.asarray(params["video_inverse_ff"]["w"])
        w3 = params_to_numpy(port)["video_inverse_ff"]["w"]
        assert 0 < np.abs(w3 - w0).max() < 1e-6


# ---------------------------------------------------------------------------
# the CLIs, end to end on the CPU
# ---------------------------------------------------------------------------

def _sft_cli(tiny, out, extra=()):
    return TT.main([
        "--data-path", tiny["conv"], "--features-dir", tiny["chat_features"],
        "--output", out, "--device", "cpu", "--hidden-size", "64",
        "--lm-layers", "2", "--vision-dim", "16", "--vision-image-size",
        "28", "--max-temporal", "22", "--max-len", "96", "--batch-size", "4",
        "--num-epochs", "2", "--lr", "1e-2", "--report-interval", "2",
        *extra])


@pytest.mark.parametrize("projector_only", [False, True],
                         ids=["full", "projector-only"])
def test_sft_cli_trains_saves_and_infer_reloads(tiny, tmp_path, capsys,
                                                projector_only):
    out = str(tmp_path / "sft")
    final = _sft_cli(tiny, out, ["--tune-mm-projector-only"]
                     if projector_only else [])
    printed = capsys.readouterr().out
    first = float(printed.split("loss ")[1].split()[0])
    assert np.isfinite(final) and final < first
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["projector_only"] is projector_only
    assert cfg["video_token_len"] == 26 and cfg["d_model"] == 64
    from stair_tpu_torch.train import checkpoint as C

    with open(os.path.join(out, "params.msgpack"), "rb") as f:
        raw = C.from_bytes(f.read())
    assert set(raw) == ({"mm_projector"} if projector_only
                        else {"decoder", "vision", "mm_projector"})
    model, tok = TI.initialize_model(argparse.Namespace(
        model_path=None, vision_path=None, model_ckpt=out, device="cpu"))
    assert model.config.decoder.d_model == 64
    assert model.config.video_token_len == 26
    np.testing.assert_array_equal(
        model.weights["mm_projector/w"].detach().numpy(),
        raw["mm_projector"]["w"])
    answers = TI.video_chatgpt_infer_batch(
        model, tok, TD.QUESTIONS[:2],
        TD.frame_sets(frames=3, height=40, width=40)[:2], max_new_tokens=3)
    assert len(answers) == 2 and all(isinstance(a, str) for a in answers)


def test_sft_cli_needs_a_card_unless_asked_for_the_cpu(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        TT.main(["--data-path", tiny["conv"], "--features-dir",
                 tiny["chat_features"], "--output", str(tmp_path / "o")])


@pytest.mark.parametrize("lm_model,extra", [
    ("VideoGPT", ["--gpt-video-loss-weight", "1"]),
    ("VideoGPT", ["--gpt-video-loss-weight", "0"]),
    ("Llama", ["--gpt-video-loss-weight", "1", "--llm-lora"]),
], ids=["gpt2-video-loss", "gpt2-reply-only", "llama-lora"])
def test_video_lm_cli_trains_saves_and_tests(tiny, tmp_path, capsys,
                                             lm_model, extra):
    out = str(tmp_path / "lm")
    common = [
        "--rgb-path", tiny["rgb"], "--train-filename", tiny["train"],
        "--valid-filename", tiny["valid"], "--test-filename", tiny["test"],
        "--device", "cpu", "--max-video-length", "10",
        "--tokenizer-max-length", "24", "--batch-size", "4",
        "--gpt-filter-result-path", tiny["filter"], "--report-interval", "2"]
    best = TW.main([*common, "--lm-model", lm_model, "--hidden-size", "64",
                    "--lm-layers", "2", "--num-epochs", "2", "--lr", "2e-3",
                    "--output", out, *extra])
    printed = capsys.readouterr().out
    valid_losses = [float(line.split("loss ")[1]) for line in
                    printed.splitlines() if line.startswith("epoch")]
    assert len(valid_losses) == 2 and valid_losses[1] < valid_losses[0]
    assert 0.0 <= best <= 1.0
    # the test split is the valid split here: the reloaded model must give
    # the loss of the epoch that was saved
    acc = TW.main([*common, "--func", "test", "--model-ckpt", out])
    printed = capsys.readouterr().out
    test_loss = float(printed.split("test acc")[1].split("loss ")[1])
    assert acc == pytest.approx(best)
    assert test_loss == pytest.approx(valid_losses[-1], abs=1e-4)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["llm_lora"] == int("--llm-lora" in extra)


@needs_jax
def test_port_infer_loads_a_jax_projector_only_checkpoint(tmp_path):
    ns = argparse.Namespace(model_path=None, vision_path=None,
                            model_ckpt=None, device="cpu")
    jmodel, params, jtok = JI.initialize_model(ns)
    rng = np.random.RandomState(0)
    params = dict(params, mm_projector={
        "w": jnp.asarray(rng.randn(32, 64).astype(np.float32)),
        "b": jnp.asarray(rng.randn(64).astype(np.float32))})
    JT.save(str(tmp_path), params, jmodel.config, jtok, projector_only=True)
    ns.model_ckpt = str(tmp_path)
    model, tok = TI.initialize_model(ns)
    np.testing.assert_array_equal(
        model.weights["mm_projector/w"].detach().numpy(),
        np.asarray(params["mm_projector"]["w"]))
    assert tok.word2id == jtok.word2id
    # and a whole JAX-saved tree gives the JAX model's answers' inputs
    JT.save(str(tmp_path), params, jmodel.config, jtok)
    model, _ = TI.initialize_model(ns)
    got = flatten_tree(params_to_numpy(model))
    for k, v in flatten_tree(to_numpy_tree(params)).items():
        np.testing.assert_array_equal(v, got[k], k)
