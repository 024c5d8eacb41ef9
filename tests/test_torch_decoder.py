"""Port parity: the decoder family (stair_tpu_torch/llm/decoder.py).

Tiny GPT-2 (learned positions, LayerNorm, GELU, biases, tied head) and
Llama (rope, RMSNorm, SwiGLU, grouped-query attention, untied head)
configurations, float32, JAX weights carried over by ``params_from_numpy``:
logits at atol 1e-4 on rows below ``valid_len`` (the JAX package leaves
padding rows to its dense attention, the port zeroes their attention
output), LoRA, ``prefill`` hidden states and caches, ``decode_one``, and
greedy ``generate`` token for token with and without ``eos_id``. Sampling
cannot reproduce ``jax.random``: a seeded ``torch.Generator`` must repeat
itself and draw tokens the logits make likely. The HF importers are held
against random-init ``transformers`` models.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.llm import import_weights as TI
from stair_tpu_torch.llm.decoder import Decoder, DecoderConfig
from stair_tpu_torch.weights import params_from_numpy, params_to_numpy
from torch_port_util import (  # noqa: F401
    assert_trees_equal, cuda_device, to_numpy_tree, tree_shapes,
)

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.llm import decoder as JD
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

FAMILIES = ["gpt2", "llama-gqa"]


def _cfg_kw(family):
    if family == "gpt2":
        return "gpt2", dict(vocab_size=40, d_model=32, num_heads=2,
                            num_layers=2, d_ff=64, max_len=32)
    return "llama", dict(vocab_size=40, d_model=32, num_heads=4,
                         num_kv_heads=2, num_layers=2, d_ff=64, max_len=32)


def _pair(family, seed=3, lora=False):
    """(JAX model, JAX params, port model) with the same weights."""
    maker, kw = _cfg_kw(family)
    jcfg = getattr(JD.DecoderConfig, maker)(**kw)
    jmodel = JD.Decoder(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    if lora:
        params = jmodel.add_lora(params, jax.random.PRNGKey(seed + 1), rank=4)
        rng = np.random.RandomState(seed)
        for layer in params["layers"]:    # B starts at zero: make it count
            for name in ("q", "v"):
                layer[name]["lora_b"] = jnp.asarray(
                    rng.randn(*layer[name]["lora_b"].shape)
                    .astype(np.float32) * 0.1)
    cfg = getattr(DecoderConfig, maker)(**kw)
    port = Decoder(cfg, params_from_numpy(to_numpy_tree(params)))
    return jmodel, params, port


@needs_jax
@pytest.mark.parametrize("family", FAMILIES)
def test_config_round_trips(family):
    maker, kw = _cfg_kw(family)
    jcfg = getattr(JD.DecoderConfig, maker)(**kw)
    cfg = getattr(DecoderConfig, maker)(**kw)
    assert cfg.to_dict() == jcfg.__dict__
    assert (cfg.kv_heads, cfg.head_dim) == (jcfg.kv_heads, jcfg.head_dim)
    assert JD.DecoderConfig(**cfg.to_dict()) == jcfg
    full = DecoderConfig.llama()
    assert full.to_dict() == JD.DecoderConfig.llama().__dict__


@needs_jax
@pytest.mark.parametrize("family", FAMILIES)
def test_init_has_the_jax_tree_and_round_trips(family):
    jmodel, params, port = _pair(family)
    fresh = Decoder(port.config, generator=torch.Generator().manual_seed(1))
    assert tree_shapes(params_to_numpy(fresh)) == tree_shapes(params)
    assert_trees_equal(to_numpy_tree(params), params_to_numpy(port))


@needs_jax
@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_tokens_logits(family, lora):
    jmodel, params, port = _pair(family, lora=lora)
    rng = np.random.RandomState(0)
    B, L = 3, 12
    ids = rng.randint(0, 40, (B, L)).astype(np.int32)
    prefix = np.array([0, 4, 0], np.int32)
    valid = np.array([12, 9, 5], np.int32)
    ref = np.asarray(jmodel.forward_tokens(
        params, jnp.asarray(ids), jnp.asarray(prefix), jnp.asarray(valid)))
    with torch.no_grad():
        out = port.forward_tokens(
            torch.from_numpy(ids).long(), torch.from_numpy(prefix),
            torch.from_numpy(valid)).numpy()
    assert out.shape == ref.shape
    for b, nv in enumerate(valid):
        np.testing.assert_allclose(out[b, :nv], ref[b, :nv], rtol=1e-4,
                                   atol=1e-4)
    # defaults: causal over the whole row
    ref = np.asarray(jmodel.forward_tokens(params, jnp.asarray(ids)))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_add_lora_starts_as_identity_and_adds_parameters():
    cfg = DecoderConfig.llama(**_cfg_kw("llama-gqa")[1])
    model = Decoder(cfg, generator=torch.Generator().manual_seed(0))
    ids = torch.arange(10)[None] % 40
    with torch.no_grad():
        before = model(ids)
        n = len(model.weights)
        model.add_lora(torch.Generator().manual_seed(1), rank=4)
        after = model(ids)
    assert len(model.weights) == n + 4 * cfg.num_layers
    assert model.weights["layers/0/q/lora_a"].shape == (32, 4)
    assert model.weights["layers/1/v/lora_b"].shape == (4, 16)
    assert torch.equal(before, after)


def _prompt(params, rng, B, L, Lmax, d_model, lens):
    ids = rng.randint(0, 40, (B, L + 1)).astype(np.int32)
    embeds = np.zeros((B, Lmax, d_model), np.float32)
    embeds[:, :L] = np.asarray(params["embed"])[ids[:, :L]]
    return ids, embeds, np.asarray(lens, np.int32)


@needs_jax
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_hidden_and_caches(family):
    jmodel, params, port = _pair(family)
    B, L, Lmax = 2, 10, 16
    ids, embeds, plen = _prompt(params, np.random.RandomState(0), B, L, Lmax,
                                32, [10, 7])
    ref_h, ref_c = jmodel.prefill(params, jnp.asarray(embeds),
                                  jnp.zeros((B,), jnp.int32),
                                  jnp.asarray(plen))
    hid, caches = port.prefill(torch.from_numpy(embeds),
                               torch.zeros(B, dtype=torch.int32),
                               torch.from_numpy(plen))
    assert len(caches) == len(ref_c)
    kv = port.config.kv_heads
    for b, n in enumerate(plen):
        np.testing.assert_allclose(hid[b, :n].numpy(),
                                   np.asarray(ref_h)[b, :n], rtol=1e-4,
                                   atol=1e-4)
        for (k, v), (rk, rv) in zip(caches, ref_c):
            assert k.shape == (B, kv, Lmax, port.config.head_dim)
            assert k.is_contiguous()
            np.testing.assert_allclose(k[b, :, :n].numpy(),
                                       np.asarray(rk)[b, :, :n], rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(v[b, :, :n].numpy(),
                                       np.asarray(rv)[b, :, :n], rtol=1e-4,
                                       atol=1e-4)


@needs_jax
@pytest.mark.parametrize("family", FAMILIES)
def test_kv_cache_decode_matches_full_forward(family):
    """decode_one over cached KV equals the full-sequence forward, and the
    JAX package's decode_one (as tests/test_llm_parity.py:177-219)."""
    jmodel, params, port = _pair(family)
    B, L = 2, 10
    ids, embeds, plen = _prompt(params, np.random.RandomState(0), B, L, 16,
                                32, [L, L])
    with torch.no_grad():
        full = port(torch.from_numpy(ids).long()).numpy()
    hidden, caches = port.prefill(torch.from_numpy(embeds),
                                  torch.zeros(B, dtype=torch.int32),
                                  torch.from_numpy(plen))
    last = port.logits_from_hidden(hidden[:, L - 1:L])[:, 0].detach().numpy()
    np.testing.assert_allclose(last, full[:, L - 1], rtol=2e-4, atol=2e-4)
    tok_embed = port.embed[torch.from_numpy(ids[:, L]).long()].detach()
    logits, new_caches = port.decode_one(caches, tok_embed,
                                         torch.full((B,), L))
    np.testing.assert_allclose(logits.numpy(), full[:, L], rtol=2e-4,
                               atol=2e-4)
    assert new_caches[0][0] is caches[0][0]          # updated in place
    _, jc = jmodel.prefill(params, jnp.asarray(embeds),
                           jnp.zeros((B,), jnp.int32), jnp.asarray(plen))
    ref, jc = jmodel.decode_one(
        params, jc, jnp.asarray(tok_embed.numpy()),
        jnp.full((B,), L, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(caches[1][0][:, :, :L + 1].numpy(),
                               np.asarray(jc[1][0])[:, :, :L + 1],
                               rtol=1e-4, atol=1e-4)


@needs_jax
@pytest.mark.parametrize("use_eos", [False, True], ids=["no-eos", "eos"])
@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_generate_token_for_token(family, use_eos):
    jmodel, params, port = _pair(family, seed=5)
    B, L, T = 3, 6, 9
    _, embeds, plen = _prompt(params, np.random.RandomState(1), B, L, 16, 32,
                              [6, 4, 2])
    args = (params, jnp.asarray(embeds), jnp.asarray(plen), T)
    free = np.asarray(jmodel.generate(*args))
    # an eos that really occurs: what example 0 emits third
    eos = int(free[0, 2]) if use_eos else None
    ref = np.asarray(jmodel.generate(*args, eos_id=eos))
    out = port.generate(torch.from_numpy(embeds), torch.from_numpy(plen), T,
                        eos_id=eos)
    assert out.dtype == torch.int32 and out.shape == (B, T)
    np.testing.assert_array_equal(out.numpy(), ref)
    if use_eos:
        assert np.all(ref[0, 2:] == eos)             # latched and repeated
        assert not np.array_equal(ref, free) or np.all(free[0, 2:] == eos)


@pytest.mark.parametrize("family", FAMILIES)
def test_sampling_is_seeded_and_follows_the_logits(family):
    maker, kw = _cfg_kw(family)
    cfg = getattr(DecoderConfig, maker)(**kw)
    model = Decoder(cfg, generator=torch.Generator().manual_seed(2))
    B, L, T, temp = 2, 5, 6, 0.2
    ids = torch.from_numpy(
        np.random.RandomState(0).randint(0, 40, (B, L))).long()
    embeds = torch.zeros(B, 16, 32)
    embeds[:, :L] = model.embed[ids].detach()
    plen = torch.full((B,), L, dtype=torch.int32)

    def run(seed):
        return model.generate(embeds, plen, T, temperature=temp,
                              generator=torch.Generator().manual_seed(seed))

    a, b = run(7), run(7)
    assert torch.equal(a, b)
    # every drawn token is likely under the logits of the sequence so far
    seq = torch.cat([ids, a.long()], dim=1)
    with torch.no_grad():
        probs = torch.softmax(model(seq).float() / temp, dim=-1)
    for t in range(T):
        p = probs[torch.arange(B), L - 1 + t, a[:, t].long()]
        assert torch.all(p > 1e-4), (t, p)


def test_bf16_rope_generation_is_finite_and_agrees_with_float32():
    cfg = DecoderConfig.llama(**_cfg_kw("llama-gqa")[1])
    f32 = Decoder(cfg, generator=torch.Generator().manual_seed(4))
    bf16 = Decoder(cfg, params_from_numpy(params_to_numpy(f32))).to(
        torch.bfloat16)
    embeds = torch.from_numpy(np.random.RandomState(0).randn(
        2, 16, 32).astype(np.float32)) * 0.02
    plen = torch.tensor([3, 3], dtype=torch.int32)
    toks = bf16.generate(embeds.to(torch.bfloat16), plen, 5)
    assert toks.shape == (2, 5)
    assert bool(((toks >= 0) & (toks < 40)).all())
    hid32, _ = f32.prefill(embeds, torch.zeros(2, dtype=torch.int32), plen)
    hid16, caches = bf16.prefill(embeds.to(torch.bfloat16),
                                 torch.zeros(2, dtype=torch.int32), plen)
    assert caches[0][0].dtype == torch.bfloat16      # cache keeps the dtype
    assert bool(torch.isfinite(hid16[:, :3].float()).all())
    l32 = f32.logits_from_hidden(hid32[:, 2])
    l16 = bf16.logits_from_hidden(hid16[:, 2]).float()
    # the float32 winner is within bf16 rounding of the bf16 maximum
    top = l32.argmax(-1)
    gap = l16.max(-1).values - l16[torch.arange(2), top]
    assert bool((gap <= 2e-2).all()), gap


def test_import_gpt2_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(
        vocab_size=50, n_embd=32, n_head=2, n_layer=2, n_positions=24,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg = TI.gpt2_config_from_hf(hf_cfg)
    assert (cfg.d_model, cfg.num_layers, cfg.max_len) == (32, 2, 24)
    model = Decoder(cfg, params_from_numpy(TI.import_gpt2(hf.state_dict())))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 50, (2, 12)))
    with torch.no_grad():
        np.testing.assert_allclose(model(ids).numpy(),
                                   hf(ids).logits.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_import_llama_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=50, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=32, rms_norm_eps=1e-5)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = TI.llama_config_from_hf(hf_cfg)
    assert (cfg.kv_heads, cfg.rms_eps, cfg.pos) == (2, 1e-5, "rope")
    model = Decoder(cfg, params_from_numpy(TI.import_llama(hf.state_dict())))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 50, (2, 12)))
    with torch.no_grad():
        np.testing.assert_allclose(model(ids).numpy(),
                                   hf(ids).logits.numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_on_card_goes_through_the_kernel(cuda_device, family):
    """On the card ``prefill`` launches one attention kernel per layer and
    agrees with the CPU (plain) route within 1e-4 in float32."""
    from stair_tpu_torch.ops import _build

    maker, kw = _cfg_kw(family)
    cfg = getattr(DecoderConfig, maker)(**kw)
    model = Decoder(cfg, generator=torch.Generator().manual_seed(2))
    embeds = torch.from_numpy(np.random.RandomState(0).randn(
        2, 16, 32).astype(np.float32)) * 0.02
    plen = torch.tensor([9, 16], dtype=torch.int32)
    ref, _ = model.prefill(embeds, torch.zeros(2, dtype=torch.int32), plen)
    model = model.to(cuda_device)
    _build.reset_launches()
    out, _ = model.prefill(embeds.to(cuda_device),
                           torch.zeros(2, dtype=torch.int32,
                                       device=cuda_device),
                           plen.to(cuda_device))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn"] == cfg.num_layers
    for b, n in enumerate(plen):
        torch.testing.assert_close(out[b, :n].cpu(), ref[b, :n], rtol=1e-4,
                                   atol=1e-4)
