"""HF checkpoint converters: GPT-2 / Llama / T5 state dicts -> params trees
(port of ``stair_tpu/llm/import_weights.py``).

Lets the LLM paths run from pretrained weights that are available locally.
Conversion is numpy on the host and gives the JAX package's tree (``w``
stored ``[in, out]``): ``Decoder(cfg, params_from_numpy(import_llama(sd)))``.
Parity with ``transformers``' implementations is covered by
tests/test_torch_decoder.py; ``import_t5`` (the program parser's Flan-T5
path, ``T5Seq2Seq(cfg, params_from_numpy(import_t5(sd)))``) by
tests/test_torch_seq2seq.py.
"""

from __future__ import annotations

import numpy as np

from stair_tpu_torch.llm.decoder import DecoderConfig


def _np(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def gpt2_config_from_hf(hf_config, **overrides) -> DecoderConfig:
    kw = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.n_embd,
        num_heads=hf_config.n_head,
        num_layers=hf_config.n_layer,
        d_ff=4 * hf_config.n_embd,
        max_len=hf_config.n_positions,
    )
    kw.update(overrides)
    return DecoderConfig.gpt2(**kw)


def import_gpt2(state_dict) -> dict:
    """HF GPT2LMHeadModel state dict -> Decoder params."""
    sd = {k: v for k, v in state_dict.items()}
    pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""

    def g(name):
        return _np(sd[pfx + name])

    n_layer = 1 + max(
        int(k.split(".")[1 if not pfx else 2])
        for k in sd if ".h." in ("." + k) or k.startswith(pfx + "h.")
    )
    D = g("wte.weight").shape[1]
    layers = []
    for i in range(n_layer):
        b = f"h.{i}."
        qkv_w = g(b + "attn.c_attn.weight")       # [D, 3D] (HF Conv1D layout)
        qkv_b = g(b + "attn.c_attn.bias")
        qw, kw, vw = np.split(qkv_w, 3, axis=1)
        qb, kb, vb = np.split(qkv_b, 3)
        layers.append({
            "ln1": {"scale": g(b + "ln_1.weight"), "bias": g(b + "ln_1.bias")},
            "q": {"w": qw, "b": qb},
            "k": {"w": kw, "b": kb},
            "v": {"w": vw, "b": vb},
            "o": {"w": g(b + "attn.c_proj.weight"),
                  "b": g(b + "attn.c_proj.bias")},
            "ln2": {"scale": g(b + "ln_2.weight"), "bias": g(b + "ln_2.bias")},
            "up": {"w": g(b + "mlp.c_fc.weight"), "b": g(b + "mlp.c_fc.bias")},
            "down": {"w": g(b + "mlp.c_proj.weight"),
                     "b": g(b + "mlp.c_proj.bias")},
        })
    return {
        "embed": g("wte.weight"),
        "pos_embed": g("wpe.weight"),
        "layers": layers,
        "ln_f": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
    }


def llama_config_from_hf(hf_config, **overrides) -> DecoderConfig:
    kw = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        num_heads=hf_config.num_attention_heads,
        num_layers=hf_config.num_hidden_layers,
        d_ff=hf_config.intermediate_size,
        max_len=hf_config.max_position_embeddings,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", None),
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rms_eps=hf_config.rms_norm_eps,
    )
    kw.update(overrides)
    return DecoderConfig.llama(**{
        k: v for k, v in kw.items()
        if k in ("vocab_size", "d_model", "num_heads", "num_layers", "d_ff",
                 "max_len")
    }, num_kv_heads=kw["num_kv_heads"], rope_theta=kw["rope_theta"],
        rms_eps=kw["rms_eps"])


def import_llama(state_dict) -> dict:
    """HF LlamaForCausalLM (or LlamaModel) state dict -> Decoder params."""
    sd = dict(state_dict)
    pfx = "model." if any(k.startswith("model.") for k in sd) else ""

    def g(name):
        return _np(sd[pfx + name])

    n_layer = 1 + max(
        int(k[len(pfx) + len("layers."):].split(".")[0])
        for k in sd if k.startswith(pfx + "layers.")
    )
    layers = []
    for i in range(n_layer):
        b = f"layers.{i}."
        layers.append({
            "ln1": {"scale": g(b + "input_layernorm.weight")},
            "q": {"w": g(b + "self_attn.q_proj.weight").T},
            "k": {"w": g(b + "self_attn.k_proj.weight").T},
            "v": {"w": g(b + "self_attn.v_proj.weight").T},
            "o": {"w": g(b + "self_attn.o_proj.weight").T},
            "ln2": {"scale": g(b + "post_attention_layernorm.weight")},
            "gate": {"w": g(b + "mlp.gate_proj.weight").T},
            "up": {"w": g(b + "mlp.up_proj.weight").T},
            "down": {"w": g(b + "mlp.down_proj.weight").T},
        })
    params = {
        "embed": g("embed_tokens.weight"),
        "layers": layers,
        "ln_f": {"scale": g("norm.weight")},
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = {"w": _np(sd["lm_head.weight"]).T}
    else:
        params["lm_head"] = {"w": g("embed_tokens.weight").T}
    return params


def t5_config_from_hf(hf_config, **overrides):
    """transformers T5Config -> ``seq2seq.t5.T5Config`` (v1.0 relu and
    v1.1/Flan gated-gelu, ref hf_program_parser.py:142-205 loads
    google/flan-t5-large)."""
    from stair_tpu_torch.seq2seq.t5 import T5Config

    ff = hf_config.feed_forward_proj
    kw = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.d_model,
        d_kv=hf_config.d_kv,
        num_heads=hf_config.num_heads,
        num_layers=hf_config.num_layers,
        num_decoder_layers=hf_config.num_decoder_layers,
        d_ff=hf_config.d_ff,
        feed_forward="gated-gelu" if "gated" in ff else "relu",
        num_buckets=hf_config.relative_attention_num_buckets,
        max_distance=getattr(
            hf_config, "relative_attention_max_distance", 128
        ),
        rms_eps=hf_config.layer_norm_epsilon,
        tie_word_embeddings=hf_config.tie_word_embeddings,
    )
    kw.update(overrides)
    return T5Config(**kw)


def import_t5(state_dict) -> dict:
    """HF T5ForConditionalGeneration (or T5Model) state dict -> T5Seq2Seq
    params. Torch Linear weights are [out, in]; transposed to x @ w."""
    sd = dict(state_dict)

    def g(name):
        return _np(sd[name]).T

    def raw(name):
        return _np(sd[name])

    def ffn(base):
        if base + "DenseReluDense.wi_0.weight" in sd:
            return {"wi_0": {"w": g(base + "DenseReluDense.wi_0.weight")},
                    "wi_1": {"w": g(base + "DenseReluDense.wi_1.weight")},
                    "wo": {"w": g(base + "DenseReluDense.wo.weight")}}
        return {"wi": {"w": g(base + "DenseReluDense.wi.weight")},
                "wo": {"w": g(base + "DenseReluDense.wo.weight")}}

    def attn(base):
        return {n: {"w": g(f"{base}.{n}.weight")} for n in "qkvo"}

    def n_blocks(stack):
        return 1 + max(
            int(k.split(".")[2]) for k in sd
            if k.startswith(stack + ".block.")
        )

    enc = []
    for i in range(n_blocks("encoder")):
        b = f"encoder.block.{i}."
        enc.append({
            "ln1": raw(b + "layer.0.layer_norm.weight"),
            "attn": attn(b + "layer.0.SelfAttention"),
            "ln2": raw(b + "layer.1.layer_norm.weight"),
            "ffn": ffn(b + "layer.1."),
        })
    dec = []
    for i in range(n_blocks("decoder")):
        b = f"decoder.block.{i}."
        dec.append({
            "ln1": raw(b + "layer.0.layer_norm.weight"),
            "self": attn(b + "layer.0.SelfAttention"),
            "ln2": raw(b + "layer.1.layer_norm.weight"),
            "cross": attn(b + "layer.1.EncDecAttention"),
            "ln3": raw(b + "layer.2.layer_norm.weight"),
            "ffn": ffn(b + "layer.2."),
        })
    params = {
        "shared": raw("shared.weight"),
        "enc_rel": raw(
            "encoder.block.0.layer.0.SelfAttention"
            ".relative_attention_bias.weight"
        ),
        "dec_rel": raw(
            "decoder.block.0.layer.0.SelfAttention"
            ".relative_attention_bias.weight"
        ),
        "enc": enc,
        "dec": dec,
        "enc_ln": raw("encoder.final_layer_norm.weight"),
        "dec_ln": raw("decoder.final_layer_norm.weight"),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = {"w": g("lm_head.weight")}
    return params
