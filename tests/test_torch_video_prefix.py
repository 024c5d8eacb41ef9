"""Port parity: the video-prefix LM's forward (stair_tpu_torch/llm/
video_prefix.py).

A tiny GPT-2 decoder with JAX weights carried over: ``build_embeds``
(packing [video | text] at per-example offsets) and ``forward`` with
``video_visible`` False and True (the prefix-LM mask, ``prefix_len`` =
``video_len``) against the JAX package, float32 at atol 1e-4 on rows below
the packed length; the tokenizer, ``pack_text_batch`` and
``answer_exact_match`` give what the JAX package's give.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.llm import video_prefix as TP
from stair_tpu_torch.llm.decoder import DecoderConfig
from stair_tpu_torch.weights import params_from_numpy, params_to_numpy
from torch_port_util import assert_trees_equal, to_numpy_tree, tree_shapes

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.llm import video_prefix as JP
    from stair_tpu.llm.decoder import DecoderConfig as JDecoderConfig
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

DEC = dict(vocab_size=60, d_model=32, num_heads=2, num_layers=2, d_ff=64,
           max_len=64)
TEXTS = ["what is the person holding ?", "a cup", "where did they go ?",
         "the kitchen door"]


def _pair():
    jcfg = JP.VideoPrefixConfig(video_size=12,
                                decoder=JDecoderConfig.gpt2(**DEC),
                                max_video_length=8, max_text_length=10)
    jmodel = JP.VideoPrefixLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = TP.VideoPrefixConfig(video_size=12, decoder=DecoderConfig.gpt2(**DEC),
                               max_video_length=8, max_text_length=10)
    port = TP.VideoPrefixLM(cfg, params_from_numpy(to_numpy_tree(params)))
    return jmodel, params, port


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "video": rng.randn(3, 8, 12).astype(np.float32),
        "video_len": np.array([8, 5, 1], np.int32),
        "token_ids": rng.randint(0, 60, (3, 10)).astype(np.int32),
        "text_len": np.array([10, 7, 3], np.int32),
    }


def _torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["token_ids"] = out["token_ids"].long()
    return out


@needs_jax
def test_init_tree_matches_jax_and_round_trips():
    jmodel, params, port = _pair()
    fresh = TP.VideoPrefixLM(port.config,
                             generator=torch.Generator().manual_seed(1))
    assert tree_shapes(params_to_numpy(fresh)) == tree_shapes(params)
    assert_trees_equal(to_numpy_tree(params), params_to_numpy(port))


@needs_jax
def test_build_embeds():
    jmodel, params, port = _pair()
    b = _batch()
    ref = np.asarray(jmodel.build_embeds(
        params, jnp.asarray(b["video"]), jnp.asarray(b["video_len"]),
        jnp.asarray(b["token_ids"])))
    tb = _torch(b)
    with torch.no_grad():
        out = port.build_embeds(tb["video"], tb["video_len"],
                                tb["token_ids"]).numpy()
    assert out.shape == ref.shape == (3, 18, 32)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@needs_jax
@pytest.mark.parametrize("visible", [False, True],
                         ids=["causal", "video-visible"])
def test_forward(visible):
    jmodel, params, port = _pair()
    b = _batch(1)
    ref_l, ref_h = jmodel.forward(
        params, {k: jnp.asarray(v) for k, v in b.items()},
        video_visible=visible)
    with torch.no_grad():
        logits, hidden = port.forward(_torch(b), video_visible=visible)
    total = b["video_len"] + b["text_len"]
    for i, n in enumerate(total):
        np.testing.assert_allclose(logits[i, :n].numpy(),
                                   np.asarray(ref_l)[i, :n], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(hidden[i, :n].numpy(),
                                   np.asarray(ref_h)[i, :n], rtol=1e-4,
                                   atol=1e-4)


@needs_jax
def test_video_visible_changes_video_rows_only_where_it_should():
    """With the prefix mask the first video row sees the later ones, so
    it must differ from its causal value; the last text row sees the same
    columns under both masks."""
    _, _, port = _pair()
    tb = _torch(_batch(2))
    with torch.no_grad():
        _, causal = port.forward(tb, video_visible=False)
        _, vis = port.forward(tb, video_visible=True)
    assert not torch.allclose(causal[0, 0], vis[0, 0], atol=1e-5)
    torch.testing.assert_close(causal[2, 0], vis[2, 0])  # video_len 1


@needs_jax
def test_tokenizer_pack_and_exact_match_agree_with_jax():
    jtok, tok = JP.SimpleTokenizer.build(TEXTS), TP.SimpleTokenizer.build(TEXTS)
    assert tok.word2id == jtok.word2id and len(tok) == len(jtok)
    text = "Where is the CUP, person?"
    assert tok.encode(text) == jtok.encode(text)
    assert tok.encode(text, max_length=3) == jtok.encode(text, max_length=3)
    assert tok.decode([3, 1, 0, 5, 999]) == jtok.decode([3, 1, 0, 5, 999])
    assert isinstance(TP.load_tokenizer(None, TEXTS), TP.SimpleTokenizer)
    qs, ans = [TEXTS[0], TEXTS[2]], [TEXTS[1], TEXTS[3]]
    got = TP.pack_text_batch(tok, qs, ans, 10, [8, 5], 18)
    want = JP.pack_text_batch(jtok, qs, ans, 10, [8, 5], 18)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 18, len(tok)).astype(np.float32)
    labels = got[2]
    for b in range(2):                       # make example 0 all correct
        for pos in np.nonzero(labels[b] != TP.IGNORE)[0]:
            if b == 0:
                logits[b, pos - 1, labels[b, pos]] = 50.0
    assert (TP.answer_exact_match(torch.from_numpy(logits), labels)
            == JP.answer_exact_match(logits, labels) == [True, False])
    assert TP.IGNORE == JP.IGNORE
