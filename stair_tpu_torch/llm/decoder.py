"""Decoder-only transformer family: GPT-2-class and Llama-class in one
(port of ``stair_tpu/llm/decoder.py``).

One implementation over the axes that separate the two backbones:
positions learned (GPT-2) or rotary (Llama); LayerNorm or RMSNorm, pre-norm
in both; GELU (tanh approximation) or SwiGLU; biases or none; tied or
untied head; MHA or grouped-query attention; optional LoRA adapters on the
q/v projections. Full-sequence attention goes through
``ops.attention.flash_attention`` (the hand-written kernel on the card, its
plain version on the CPU) with k/v at ``kv_heads``: the kernel indexes the
kv head itself, so the grouped heads are never expanded. The projections,
the MLP and the head are plain matrix products, and so is ``decode_one``'s
grouped attention over the KV cache, as in the JAX package.

``Decoder`` is an ``nn.Module`` that holds the JAX params tree leaf by leaf
(``weights.flatten_tree`` key paths, ``w`` stored ``[in, out]``); its
methods take tensors, never a params argument. The generation entry points
(``prefill``, ``decode_one``, ``generate``) run under ``torch.no_grad()``;
``hidden_states`` and ``forward_tokens`` are differentiable (the attention
goes through ``ops.attention.FlashAttention``, whose backward is the pair
of backward kernels). Freezing is ``requires_grad_(False)`` on the frozen
parameters; ``add_lora`` adapters train over a frozen base that way.

``DecoderConfig.remat`` rematerialises each layer in the backward pass:
``remat_policy='full'`` keeps only the layer inputs
(``torch.utils.checkpoint``, non-reentrant) and recomputes the layer, the
attention forward kernel included; ``'dots'`` keeps the outputs of the
matrix products as well (selective checkpointing) and recomputes the rest.
Gradients are the same with and without.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from stair_tpu_torch.ops import attention as A
from stair_tpu_torch.weights import ParamModule


@dataclass(frozen=True)
class DecoderConfig:
    """Twin of the JAX ``DecoderConfig`` (same fields and defaults)."""
    vocab_size: int
    d_model: int = 768
    num_heads: int = 12
    num_kv_heads: int | None = None       # GQA; None = num_heads
    num_layers: int = 12
    d_ff: int = 3072
    max_len: int = 1024
    pos: str = "learned"                  # 'learned' | 'rope'
    norm: str = "ln"                      # 'ln' | 'rms'
    mlp: str = "gelu"                     # 'gelu' | 'swiglu'
    use_bias: bool = True
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    lora_rank: int = 0
    rms_eps: float = 1e-6
    #: rematerialise each layer in the backward pass (module docstring)
    remat: bool = False
    remat_policy: str = "dots"            # 'dots' | 'full'

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    def to_dict(self):
        return asdict(self)

    @classmethod
    def gpt2(cls, vocab_size=50257, **kw):
        return cls(vocab_size=vocab_size, pos="learned", norm="ln",
                   mlp="gelu", use_bias=True, tie_embeddings=True, **kw)

    @classmethod
    def llama(cls, vocab_size=32000, d_model=4096, num_heads=32,
              num_layers=32, d_ff=11008, max_len=2048, **kw):
        return cls(vocab_size=vocab_size, d_model=d_model,
                   num_heads=num_heads, num_layers=num_layers, d_ff=d_ff,
                   max_len=max_len, pos="rope", norm="rms", mlp="swiglu",
                   use_bias=False, tie_embeddings=False, **kw)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _norm(p, x, kind, eps):
    if kind == "rms":
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * p["scale"]
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


def _proj(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _lora(p, x, y):
    """y + x @ A @ B (applied when adapters exist)."""
    if "lora_a" in p:
        y = y + (x @ p["lora_a"]) @ p["lora_b"]
    return y


def _rope_tables(positions, head_dim, theta):
    """cos and sin ``[B, L, 1, head_dim / 2]`` (float32) of the rotary
    angles at ``positions`` [B, L]."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    angles = positions[:, :, None].float() * freq[None, None, :]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _rope(x, positions, theta):
    """Rotate pairs (HF Llama convention: split halves); ``x`` is ``[B, L,
    H, D]``. Computed in float32 and cast back."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


def _gelu_tanh(x):
    return 0.5 * x * (
        1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x))
    )


def randn(gen, shape, std, device=None, dtype=torch.float32):
    """Normal draws from ``gen`` (made in float32 on the generator's device,
    so a large weight never exists twice on the host), scaled and cast."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return x.to(device=device, dtype=dtype)


def init_linear(gen, fan_in, fan_out, device=None, dtype=torch.float32):
    """``{"w": [in, out], "b": [out]}``, U(-1/sqrt(in), 1/sqrt(in)) (the JAX
    package's ``_init_linear``), drawn on the generator's device."""
    bound = 1.0 / math.sqrt(fan_in)

    def u(shape):
        x = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
        return (x * (2 * bound) - bound).to(device=device, dtype=dtype)

    return {"w": u((fan_in, fan_out)), "b": u((fan_out,))}


def _save_dots():
    """Selective-checkpoint contexts of ``remat_policy='dots'``: matrix
    product outputs are saved, everything else is recomputed."""
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.addmm.default, aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in dots
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return _ckpt.create_selective_checkpoint_contexts(policy)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class Decoder(ParamModule):
    def __init__(self, config: DecoderConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = self.init(generator, device, dtype)
        self._hold(params, device)

    # -- parameters ----------------------------------------------------------

    def init(self, gen: torch.Generator, device=None,
             dtype=torch.float32) -> dict:
        """A fresh params tree with the JAX package's keys and shapes, drawn
        layer by layer from ``gen`` straight into ``dtype`` on ``device``."""
        cfg = self.config
        D, F = cfg.d_model, cfg.d_ff
        kvd = cfg.kv_heads * cfg.head_dim

        def zeros(n):
            return torch.zeros(n, dtype=dtype, device=device)

        def ones(n):
            return torch.ones(n, dtype=dtype, device=device)

        def lin(fi, fo):
            p = {"w": randn(gen, (fi, fo), 0.02, device, dtype)}
            if cfg.use_bias:
                p["b"] = zeros(fo)
            return p

        def norm_p():
            p = {"scale": ones(D)}
            if cfg.norm == "ln":
                p["bias"] = zeros(D)
            return p

        def layer():
            p = {
                "ln1": norm_p(),
                "q": lin(D, D), "k": lin(D, kvd), "v": lin(D, kvd),
                "o": lin(D, D),
                "ln2": norm_p(),
            }
            if cfg.mlp == "swiglu":
                p["gate"] = lin(D, F)
            p["up"] = lin(D, F)
            p["down"] = lin(F, D)
            return p

        params = {
            "embed": randn(gen, (cfg.vocab_size, D), 0.02, device, dtype),
            "layers": [layer() for _ in range(cfg.num_layers)],
            "ln_f": norm_p(),
        }
        if cfg.pos == "learned":
            params["pos_embed"] = randn(gen, (cfg.max_len, D), 0.01, device,
                                        dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = {
                "w": randn(gen, (D, cfg.vocab_size), 0.02, device, dtype)}
        return params

    def add_lora(self, gen: torch.Generator, rank=None):
        """Attach LoRA adapters to the q/v projections (A normal / sqrt(rank),
        B zero), as new parameters of this module."""
        cfg = self.config
        rank = rank or cfg.lora_rank or 8
        for i in range(cfg.num_layers):
            for name in ("q", "v"):
                w = self.weights[f"layers/{i}/{name}/w"]
                fi, fo = w.shape
                self.weights[f"layers/{i}/{name}/lora_a"] = nn.Parameter(
                    randn(gen, (fi, rank), 1.0 / math.sqrt(rank), w.device,
                          w.dtype))
                self.weights[f"layers/{i}/{name}/lora_b"] = nn.Parameter(
                    torch.zeros(rank, fo, dtype=w.dtype, device=w.device))
        return self

    @property
    def embed(self):
        return self.weights["embed"]

    # -- forward -------------------------------------------------------------

    def _rope_of(self, positions):
        """The rotary tables of ``positions``, made once per call and shared
        by every layer (None for learned positions)."""
        cfg = self.config
        if cfg.pos != "rope":
            return None
        return _rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def _project_qkv(self, layer, x, rope):
        """x [B, L, D] -> q [B, h, L, hd], k/v [B, kv, L, hd]: views of the
        ``[B, L, heads, hd]`` projections (no transpose copy; the attention
        kernel takes the strides). k/v stay at ``kv_heads``. ``rope`` is
        ``_rope_of(positions)``."""
        cfg = self.config
        B, L, _ = x.shape
        h_, kv_, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        q = _lora(layer["q"], x, _proj(layer["q"], x)).reshape(B, L, h_, hd)
        k = _proj(layer["k"], x).reshape(B, L, kv_, hd)
        v = _lora(layer["v"], x, _proj(layer["v"], x)).reshape(B, L, kv_, hd)
        if rope is not None:
            q = _apply_rope(q, *rope)
            k = _apply_rope(k, *rope)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _layer_tail(self, layer, x, attn_out):
        """Residual + o-projection of ``attn_out`` [B, L, h, hd], then the
        MLP block."""
        cfg = self.config
        B, L, D = x.shape
        x = x + _proj(layer["o"], attn_out.reshape(B, L, D))
        m_in = _norm(layer["ln2"], x, cfg.norm, cfg.rms_eps)
        if cfg.mlp == "swiglu":
            h = torch.nn.functional.silu(_proj(layer["gate"], m_in)) * _proj(
                layer["up"], m_in)
        else:
            h = _gelu_tanh(_proj(layer["up"], m_in))
        return x + _proj(layer["down"], h)

    def _embed_positions(self, p, x, positions):
        if self.config.pos == "learned":
            x = x + p["pos_embed"][positions]
        return x

    def _layers(self, p, x, prefix_len, valid_len, positions, caches=None):
        """Every layer over the full sequence; with ``caches`` (a list) also
        collects each layer's (k, v) ``[B, kv, L, hd]``."""
        cfg = self.config
        rope = self._rope_of(positions)

        def one_layer(layer, x):
            a_in = _norm(layer["ln1"], x, cfg.norm, cfg.rms_eps)
            q, k, v = self._project_qkv(layer, a_in, rope)
            if caches is not None:
                # contiguous [B, kv, L, hd]: decode reads the whole cache
                # every token as one batched product per kv head
                caches.append((k.contiguous(), v.contiguous()))
            attn = A.flash_attention(q, k, v, prefix_len, valid_len)
            return self._layer_tail(layer, x, attn.transpose(1, 2))

        remat = cfg.remat and torch.is_grad_enabled() and caches is None
        for layer in p["layers"]:
            if not remat:
                x = one_layer(layer, x)
            elif cfg.remat_policy == "full":
                x = _ckpt.checkpoint(one_layer, layer, x, use_reentrant=False)
            else:
                x = _ckpt.checkpoint(
                    one_layer, layer, x, use_reentrant=False,
                    context_fn=_save_dots)
        return _norm(p["ln_f"], x, cfg.norm, cfg.rms_eps)

    def hidden_states(self, input_embeds, prefix_len, valid_len,
                      positions=None):
        """input_embeds [B, L, D] -> final hidden states [B, L, D]. (The
        JAX package's ``use_flash`` knob has no counterpart: the attention
        wrapper picks its route from the tensors' device.)"""
        B, L, _ = input_embeds.shape
        p = self.param_tree()
        if positions is None:
            positions = torch.arange(L, device=input_embeds.device)[
                None, :].expand(B, L)
        x = self._embed_positions(p, input_embeds, positions)
        return self._layers(p, x, prefix_len, valid_len, positions)

    def logits_from_hidden(self, hidden):
        if self.config.tie_embeddings:
            return hidden @ self.weights["embed"].T
        return hidden @ self.weights["lm_head/w"]

    def forward_tokens(self, token_ids, prefix_len=None, valid_len=None,
                       input_embeds=None):
        """Token ids (or pre-built embeds) -> logits [B, L, V]."""
        B, L = token_ids.shape[:2]
        dev = token_ids.device
        if input_embeds is None:
            input_embeds = self.embed[token_ids]
        if prefix_len is None:
            prefix_len = torch.zeros(B, dtype=torch.int32, device=dev)
        if valid_len is None:
            valid_len = torch.full((B,), L, dtype=torch.int32, device=dev)
        hidden = self.hidden_states(input_embeds, prefix_len, valid_len)
        return self.logits_from_hidden(hidden)

    forward = forward_tokens

    # -- generation (prefill + KV-cache decode) ------------------------------

    @torch.no_grad()
    def prefill(self, input_embeds, prefix_len, valid_len):
        """Full-prompt forward that also returns per-layer KV caches.

        Returns (hidden [B, L, D], caches: list of (k, v) [B, kv, L, hd]).
        """
        B, L, _ = input_embeds.shape
        p = self.param_tree()
        positions = torch.arange(L, device=input_embeds.device)[
            None, :].expand(B, L)
        x = self._embed_positions(p, input_embeds, positions)
        caches: list = []
        hidden = self._layers(p, x, prefix_len, valid_len, positions,
                              caches=caches)
        return hidden, caches

    @torch.no_grad()
    def decode_one(self, caches, token_embed, cur_len, params=None):
        """One KV-cache decode step.

        token_embed [B, D] for position ``cur_len`` [B]; the caches are
        updated IN PLACE at that position (the JAX package returns new
        arrays; here the same tensors come back). Returns (logits, caches).
        ``params`` is ``param_tree()``, passed by ``generate`` so the tree
        is built once per call and not per token.
        """
        cfg = self.config
        p = params if params is not None else self.param_tree()
        B, _ = token_embed.shape
        dev = token_embed.device
        Lmax = caches[0][0].shape[2]
        cur_len = cur_len.long()
        positions = cur_len[:, None]                       # [B, 1]
        x = token_embed[:, None, :]
        if cfg.pos == "learned":
            x = x + p["pos_embed"][
                torch.clamp(cur_len, max=cfg.max_len - 1)][:, None]
        cols = torch.arange(Lmax, device=dev)[None, None, None, :]
        mask = cols <= cur_len[:, None, None, None]        # [B, 1, 1, Lmax]
        h_, kv_, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        g = h_ // kv_
        rows = torch.arange(B, device=dev)
        rope = self._rope_of(positions)
        for layer, (ck, cv) in zip(p["layers"], caches):
            a_in = _norm(layer["ln1"], x, cfg.norm, cfg.rms_eps)
            q, k, v = self._project_qkv(layer, a_in, rope)
            # Insert this step's k/v at cur_len; the cache keeps the
            # prefill dtype.
            ck[rows, :, cur_len] = k[:, :, 0].to(ck.dtype)
            cv[rows, :, cur_len] = v[:, :, 0].to(cv.dtype)
            # Grouped attention over the unexpanded [B, kv, Lmax, hd]
            # cache: query heads fold into a per-kv-head group axis.
            qg = q[:, :, 0].reshape(B, kv_, g, hd)
            s = torch.einsum("bkgd,bkld->bkgl", qg, ck) / math.sqrt(hd)
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            w = torch.softmax(s, dim=-1)
            attn = torch.einsum("bkgl,bkld->bkgd", w, cv)
            x = self._layer_tail(layer, x, attn.reshape(B, 1, h_, hd))
        x = _norm(p["ln_f"], x, cfg.norm, cfg.rms_eps)
        return self.logits_from_hidden(x)[:, 0], caches

    @torch.no_grad()
    def generate(self, input_embeds, prompt_len, max_new_tokens,
                 prefix_len=None, temperature=0.0, generator=None,
                 eos_id=None):
        """Prefill once (attention kernel), then KV-cache decode.

        ``input_embeds`` [B, Lmax, D] holds the prompt with room for
        ``max_new_tokens`` more; ``prompt_len`` [B] marks the prompt end.
        Returns generated token ids [B, max_new_tokens] (int32). As in the
        JAX package's scan, step ``i`` emits the token sampled before it:
        the output starts with the token after the prompt; once an emitted
        token is ``eos_id`` the example is done and repeats it. With
        ``temperature`` > 0 tokens are drawn from ``generator`` (a
        ``torch.Generator`` on the inputs' device).
        """
        B, Lmax, _ = input_embeds.shape
        dev = input_embeds.device
        prompt_len = prompt_len.to(torch.int32)
        if prefix_len is None:
            prefix_len = torch.zeros(B, dtype=torch.int32, device=dev)

        hidden, caches = self.prefill(input_embeds, prefix_len, prompt_len)
        last = hidden[torch.arange(B, device=dev),
                      torch.clamp(prompt_len.long() - 1, 0, Lmax - 1)]
        logits0 = self.logits_from_hidden(last[:, None, :])[:, 0]

        def sample(logits):
            if temperature and temperature > 0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                return torch.multinomial(probs, 1, generator=generator)[:, 0]
            return torch.argmax(logits, dim=-1)

        p = self.param_tree()
        tok = sample(logits0)
        cur_len = prompt_len.long()
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        tokens = []
        for _ in range(max_new_tokens):
            logits, caches = self.decode_one(
                caches, p["embed"][tok], torch.clamp(cur_len, max=Lmax - 1),
                params=p)
            new_tok = sample(logits)
            if eos_id is not None:
                done = done | (tok == eos_id)
                new_tok = torch.where(done, tok, new_tok)
            tokens.append(tok)
            tok, cur_len = new_tok, cur_len + 1
        return torch.stack(tokens, dim=1).to(torch.int32)
