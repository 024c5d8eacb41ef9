"""Port parity: gradients of the decoder and the three LLM losses
(``Decoder.forward_tokens``, ``VideoChatModel.sft_loss``,
``VideoPrefixLM.reply_loss`` / ``video_loss``).

Two layers, narrow widths, float32, JAX weights carried over by
``params_from_numpy``; the same numpy batch through ``jax.value_and_grad``
and through the port's autograd (whose attention backward is
``ops.attention.FlashAttention``'s plain version on the CPU). Values at
1e-5 relative, every gradient leaf within 1e-4 of its scale. Losses are
taken on rows below ``valid_len``: the JAX package leaves padding rows to
its dense attention, the port zeroes them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stair_tpu_torch.llm import video_prefix as TP
from stair_tpu_torch.llm import videochat as TV
from stair_tpu_torch.llm.clip import ClipVisionConfig
from stair_tpu_torch.llm.decoder import Decoder, DecoderConfig
from stair_tpu_torch.weights import grads_to_numpy, params_from_numpy
from torch_port_util import assert_grad_trees_close, to_numpy_tree

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.llm import decoder as JD
    from stair_tpu.llm import video_prefix as JP
    from stair_tpu.llm import videochat as JV
    from stair_tpu.llm.clip import ClipVisionConfig as JClipConfig
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

FAMILIES = {
    "gpt2": ("gpt2", dict(vocab_size=40, d_model=32, num_heads=2,
                          num_layers=2, d_ff=64, max_len=32)),
    "llama-gqa": ("llama", dict(vocab_size=40, d_model=32, num_heads=4,
                                num_kv_heads=2, num_layers=2, d_ff=64,
                                max_len=32)),
}


def _decoder_pair(family, lora=False, seed=3):
    maker, kw = FAMILIES[family]
    jmodel = JD.Decoder(getattr(JD.DecoderConfig, maker)(**kw))
    params = jmodel.init(jax.random.PRNGKey(seed))
    if lora:
        params = jmodel.add_lora(params, jax.random.PRNGKey(seed + 1), rank=4)
        rng = np.random.RandomState(seed)
        for layer in params["layers"]:    # B starts at zero: make it count
            for name in ("q", "v"):
                layer[name]["lora_b"] = jnp.asarray(
                    rng.randn(*layer[name]["lora_b"].shape)
                    .astype(np.float32) * 0.1)
    port = Decoder(getattr(DecoderConfig, maker)(**kw),
                   params_from_numpy(to_numpy_tree(params)))
    return jmodel, params, port


def _tokens(seed=0, B=3, L=12, vocab=40):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, vocab, (B, L)).astype(np.int32)
    valid = np.array([L, 7, 3], np.int32)[:B]
    weight = rng.randn(B, L, vocab).astype(np.float32)
    weight *= (np.arange(L)[None, :] < valid[:, None])[..., None]
    return tok, valid, weight


def _port_token_loss(port, tok, valid, weight):
    port.zero_grad()
    logits = port.forward_tokens(torch.from_numpy(tok).long(),
                                 valid_len=torch.from_numpy(valid))
    loss = (logits * torch.from_numpy(weight)).sum()
    loss.backward()
    return float(loss.detach())


@needs_jax
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_forward_tokens_gradients_match_jax(family, lora):
    jmodel, params, port = _decoder_pair(family, lora)
    tok, valid, weight = _tokens()

    def loss(p):
        logits = jmodel.forward_tokens(p, jnp.asarray(tok),
                                       valid_len=jnp.asarray(valid))
        return jnp.sum(logits * weight)

    want_loss, want = jax.value_and_grad(loss)(params)
    got_loss = _port_token_loss(port, tok, valid, weight)
    assert abs(got_loss - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    assert_grad_trees_close(to_numpy_tree(want), grads_to_numpy(port))


@needs_jax
def test_lora_adapters_train_over_a_frozen_base():
    jmodel, params, port = _decoder_pair("llama-gqa", lora=True)
    tok, valid, weight = _tokens(seed=1)
    for key, p in port.weights.items():
        p.requires_grad_("lora_" in key)
    _port_token_loss(port, tok, valid, weight)

    def loss(p):
        logits = jmodel.forward_tokens(p, jnp.asarray(tok),
                                       valid_len=jnp.asarray(valid))
        return jnp.sum(logits * weight)

    want = to_numpy_tree(jax.grad(loss)(params))
    for key, p in port.weights.items():
        if "lora_" not in key:
            assert p.grad is None, key
            continue
        _, i, name, leaf = key.split("/")
        w = want["layers"][int(i)][name][leaf]
        assert float(np.abs(p.grad.numpy() - w).max()) <= (
            1e-4 * float(np.abs(w).max()) + 1e-7), key


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(family, policy):
    maker, kw = FAMILIES[family]
    cfg = getattr(DecoderConfig, maker)(**kw)
    port = Decoder(cfg, generator=torch.Generator().manual_seed(0))
    tok, valid, weight = _tokens(seed=2)
    _port_token_loss(port, tok, valid, weight)
    plain = grads_to_numpy(port)
    port.config = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    _port_token_loss(port, tok, valid, weight)
    assert_grad_trees_close(plain, grads_to_numpy(port), rel=1e-6)
    with torch.no_grad():       # no graph, no checkpointing: serving path
        port.forward_tokens(torch.from_numpy(tok).long())


# ---------------------------------------------------------------------------
# Video-ChatGPT: sft_loss
# ---------------------------------------------------------------------------

CHAT_DEC = dict(vocab_size=50, d_model=32, num_heads=4, num_kv_heads=2,
                num_layers=2, d_ff=64, max_len=48)
CHAT_VIS = dict(image_size=28, patch_size=14, d_model=16, num_heads=2,
                num_layers=1, d_ff=32)


def _chat_pair():
    jcfg = JV.VideoChatConfig(decoder=JD.DecoderConfig.llama(**CHAT_DEC),
                              vision=JClipConfig(**CHAT_VIS), max_temporal=6)
    jmodel = JV.VideoChatModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = TV.VideoChatConfig(decoder=DecoderConfig.llama(**CHAT_DEC),
                             vision=ClipVisionConfig(**CHAT_VIS),
                             max_temporal=6)
    port = TV.VideoChatModel(cfg, params_from_numpy(to_numpy_tree(params)))
    return jmodel, params, port


def _sft_batch(seed=0, B=3, L=40, V=10, vd=16, empty=False):
    rng = np.random.RandomState(seed)
    tok = rng.randint(1, 50, (B, L)).astype(np.int32)
    valid = np.array([40, 31, 25], np.int32)
    start = np.array([3, 5, 2], np.int32)
    lab = np.full((B, L), -1, np.int32)
    if not empty:
        for b in range(B):
            lab[b, start[b] + V + 2:valid[b]] = tok[b, start[b] + V + 2:
                                                    valid[b]]
    return {"token_ids": tok, "labels": lab,
            "video_tokens": rng.randn(B, V, vd).astype(np.float32),
            "splice_start": start, "valid_len": valid}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@needs_jax
@pytest.mark.parametrize("empty", [False, True], ids=["replies", "no-labels"])
def test_sft_loss_value_and_gradients_match_jax(empty):
    jmodel, params, port = _chat_pair()
    batch = _sft_batch(empty=empty)
    want_loss, want = jax.value_and_grad(
        lambda p: jmodel.sft_loss(p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}))(params)
    loss = port.sft_loss(_torch_batch(batch))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-7)
    assert_grad_trees_close(to_numpy_tree(want), grads_to_numpy(port))


def test_sft_loss_projector_in_float32_over_a_bf16_decoder():
    """The recipe ``chip_smoke.py`` trains: bf16 frozen decoder, float32
    projector; only the projector gets a gradient, in float32."""
    cfg = TV.VideoChatConfig(decoder=DecoderConfig.llama(**CHAT_DEC),
                             vision=ClipVisionConfig(**CHAT_VIS),
                             max_temporal=6)
    port = TV.VideoChatModel(cfg, generator=torch.Generator().manual_seed(0),
                             dtype=torch.bfloat16)
    for key, p in port.weights.items():
        p.data = p.data.float()
    for p in port.decoder.parameters():
        p.requires_grad_(False)
    loss = port.sft_loss(_torch_batch(_sft_batch()))
    loss.backward()
    assert torch.isfinite(loss)
    for key, p in port.weights.items():
        assert p.grad.dtype == torch.float32 and p.grad.abs().max() > 0, key
    assert all(p.grad is None for p in port.decoder.parameters())


# ---------------------------------------------------------------------------
# video-prefix LM: reply_loss, video_loss
# ---------------------------------------------------------------------------

def _prefix_pair(family):
    maker = "gpt2" if family == "gpt2" else "llama"
    kw = dict(FAMILIES[family][1], vocab_size=60, max_len=64)
    jcfg = JP.VideoPrefixConfig(
        video_size=12, decoder=getattr(JD.DecoderConfig, maker)(**kw),
        max_video_length=8, max_text_length=10)
    jmodel = JP.VideoPrefixLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = TP.VideoPrefixConfig(
        video_size=12, decoder=getattr(DecoderConfig, maker)(**kw),
        max_video_length=8, max_text_length=10)
    port = TP.VideoPrefixLM(cfg, params_from_numpy(to_numpy_tree(params)))
    return jmodel, params, port


def _prefix_batch(seed=0):
    rng = np.random.RandomState(seed)
    video_len = np.array([8, 5, 1], np.int32)
    text_len = np.array([10, 7, 3], np.int32)
    tok = rng.randint(3, 60, (3, 10)).astype(np.int32)
    labels = np.full((3, 18), -1, np.int32)
    for b in range(3):
        lo, hi = video_len[b] + text_len[b] - 2, video_len[b] + text_len[b]
        labels[b, lo:hi] = tok[b, text_len[b] - 2:text_len[b]]
    return {"video": rng.randn(3, 8, 12).astype(np.float32),
            "video_len": video_len, "token_ids": tok, "text_len": text_len,
            "labels": labels}


@needs_jax
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("which", ["reply", "video", "both"])
def test_prefix_losses_value_and_gradients_match_jax(family, which):
    jmodel, params, port = _prefix_pair(family)
    batch = _prefix_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)

    def jloss(p):
        out = 0.0
        if which in ("reply", "both"):
            out = out + jmodel.reply_loss(p, jb)[0]
        if which in ("video", "both"):
            out = out + 2.0 * jmodel.video_loss(p, jb)
        return out

    loss = 0.0
    if which in ("reply", "both"):
        loss = loss + port.reply_loss(tb)[0]
    if which in ("video", "both"):
        loss = loss + 2.0 * port.video_loss(tb)
    loss.backward()
    want_loss, want = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_grad_trees_close(to_numpy_tree(want), grads_to_numpy(port))


@needs_jax
def test_reply_loss_returns_the_logits():
    jmodel, params, port = _prefix_pair("gpt2")
    batch = _prefix_batch(seed=1)
    _, want = jmodel.reply_loss(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    with torch.no_grad():
        _, got = port.reply_loss(_torch_batch(batch))
    total = batch["video_len"] + batch["text_len"]
    for b, n in enumerate(total):
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n], atol=1e-4)
