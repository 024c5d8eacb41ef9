"""The neural modules as torch functions, their helpers and parameter
init (port of ``stair_tpu/models/modules.py``).

The small building blocks (``linear``, ``cosine``, ``masked_softmax``,
``layer_norm``, ``dropout``, ``l2_normalize``), the module forward
functions the scan executor calls (``models/nmn.py``, executors ``"step"``
and ``"rev"``), and ``init_module_params`` with the JAX package's key tree
and shapes. Linear weights keep the ``[in, out]`` convention, so parameters
carry over key path by key path.

Where the JAX functions take one example and are ``vmap``ped, these take
any leading batch axes: vec ``[..., H]``, frames ``[..., F, H]`` with a
validity mask ``[..., F]``, attn ``[..., F]``. Dropout masks come from a
``torch.Generator`` in the order the sites are listed in each function.
``|x|`` is ``abs_jax`` (slope +1 at 0, as ``jnp.abs``); ``torch.minimum``
already splits the gradient of a tie evenly, as ``jnp.minimum`` does.
"""

from __future__ import annotations

import math

import torch

COS_EPS = 1e-8  # torch.nn.CosineSimilarity eps


def linear(p, x):
    return x @ p["w"] + p["b"]


def dropout(x, rate, generator, deterministic):
    """Inverted dropout with a keep mask drawn from ``generator`` (a
    ``torch.Generator``; its numbers cannot equal ``jax.random``'s)."""
    if deterministic or rate == 0.0:
        return x
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = (u >= rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _Abs(torch.autograd.Function):
    """``|x|`` with JAX's slope at 0 (+1), where torch's ``abs`` has 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_jax(x):
    """``|x|`` whose gradient at 0 is +1, as ``jnp.abs``."""
    return _Abs.apply(x)


def l2_normalize(x, dim=-1, eps=1e-12):
    """torch F.normalize semantics (norm clamped below by eps), with the
    grad-safe sqrt: exactly-zero rows give zero, not NaN, cotangents."""
    norm = _safe_sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _safe_sqrt(s):
    """sqrt clamped away from 0 (the JAX package's grad-safe form)."""
    return torch.sqrt(torch.clamp(s, min=1e-30))


def cosine(x, y, dim=-1):
    """torch CosineSimilarity semantics with float32 norms, in x's dtype."""
    xf, yf = x.float(), y.float()
    nx = _safe_sqrt(torch.sum(xf * xf, dim=dim))
    ny = _safe_sqrt(torch.sum(yf * yf, dim=dim))
    dot = torch.sum(xf * yf, dim=dim)
    return (dot / torch.clamp(nx * ny, min=COS_EPS)).to(x.dtype)


def cosine_matrix(x, y):
    """All-pairs cosine: x [..., K, H], y [..., F, H] -> [..., K, F]."""
    xf, yf = x.float(), y.float()
    dot = xf @ yf.transpose(-1, -2)
    nx = _safe_sqrt(torch.sum(xf * xf, dim=-1))
    ny = _safe_sqrt(torch.sum(yf * yf, dim=-1))
    den = torch.clamp(nx[..., :, None] * ny[..., None, :], min=COS_EPS)
    return (dot / den).to(x.dtype)


def masked_softmax(x, mask, dim=-1):
    """Softmax over ``mask``ed entries; an all-masked row gives 0.

    The max is detached, as the JAX package's ``stop_gradient``.
    """
    mask = mask.bool()
    x = torch.where(mask, x, torch.full_like(x, -math.inf))
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    # An all-masked row has max -inf; shift by 0 there so exp stays finite.
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(x - m), torch.zeros_like(x))
    return e / torch.clamp(torch.sum(e, dim=dim, keepdim=True), min=1e-30)


def layer_norm(p, x, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def conv1d_same_matrix(w, length):
    """[length, length] banded matrix T with ``T @ x`` equal to torch's
    ``Conv1d(1, 1, k, padding='same')`` on ``x`` (bias excluded):
    ``out[i] = sum_u x[u] * w[u - i + left]`` for ``0 <= u - i + left < k``.
    """
    k = w.shape[0]
    left = (k - 1) // 2
    i = torch.arange(length, device=w.device)[:, None]
    u = torch.arange(length, device=w.device)[None, :]
    j = u - i + left
    basis = (j[None, :, :] == torch.arange(k, device=w.device)[:, None, None])
    return torch.einsum("s,sfu->fu", w, basis.to(w.dtype))


# ---------------------------------------------------------------------------
# Module forward functions (any leading batch axes)
# ---------------------------------------------------------------------------

def and_module(a, b):
    """ref modules.py:7-12 — elementwise min (any kind)."""
    return torch.minimum(a, b)


def compare_module(p, feat1, feat2):
    """ref modules.py:15-21."""
    return torch.relu(linear(p, torch.cat([feat1, feat2], dim=-1)))


def equals_module(p, feat1, feat2):
    """ref modules.py:24-37."""
    return torch.relu(linear(p, torch.cat([feat1, feat2], dim=-1)))


def choose_module(kw1, kw2, query):
    """ref modules.py:40-56 — hard select by cosine similarity."""
    take_first = cosine(kw1, query) > cosine(kw2, query)
    return torch.where(take_first[..., None], kw1, kw2)


def xor_module(p, feat1, feat2):
    """ref modules.py:59-72."""
    x = torch.cat([abs_jax(feat1 - feat2), feat1, feat2], dim=-1)
    return torch.relu(linear(p, x))


def xorframe_module(attn1, attn2):
    """ref modules.py:75-80."""
    return abs_jax(attn1 - attn2)


def query_module(p, kw, rate, generator, deterministic):
    """ref modules.py:83-99. One dropout site."""
    return dropout(torch.relu(linear(p["l1"], kw)), rate, generator,
                   deterministic)


def toaction_module(p, action, kw, rate, generator, deterministic):
    """ref modules.py:102-120. One dropout site."""
    h = torch.relu(linear(p["l1"], torch.cat([action, kw], dim=-1)))
    h = dropout(h, rate, generator, deterministic)
    return torch.relu(linear(p["l2"], h))


def hasitem_module(p, frames, mask, rate, generator, deterministic):
    """ref modules.py:123-138 — per-frame plausibility [..., F]. Two
    dropout sites."""
    h = dropout(torch.relu(linear(p["l1"], frames)), rate, generator,
                deterministic)
    out = torch.sigmoid(linear(p["l2"], h))[..., 0]
    out = dropout(out, rate, generator, deterministic)
    return out * mask


def exists_module(p, kw, feat, rate, generator, deterministic):
    """ref modules.py:141-159 — cat[feat, kw, feat*kw] -> 2-layer MLP. Two
    dropout sites."""
    x = torch.cat([feat, kw, feat * kw], dim=-1)
    h = dropout(torch.relu(linear(p["l1"], x)), rate, generator,
                deterministic)
    return dropout(torch.relu(linear(p["l2"], h)), rate, generator,
                   deterministic)


def existsframe_module(kw, frames, mask):
    """ref modules.py:162-178 — rescaled cosine attention [..., F]."""
    scores = cosine(frames, kw[..., None, :])
    return (scores + 1.0) * 0.49 * mask


def localize_scores(p, frames, keywords, mask, rate, generator,
                    deterministic):
    """ref modules.py:181-217 — projected cosine attention [..., K, F].

    ``keywords``: [..., K, H]. Scores on padded frames are zeroed. One
    dropout site.
    """
    h = dropout(torch.relu(linear(p["v1"], frames)), rate, generator,
                deterministic)
    feat = linear(p["v2"], h)                       # [..., F, H]
    kw = linear(p["k"], keywords)                   # [..., K, H]
    scores = cosine_matrix(kw, feat)                # [..., K, F]
    return (scores + 1.0) * 0.49 * mask[..., None, :]


def superlative_module(p, localize_p, mode_is_min, actions, frames, mask,
                       rate, generator, deterministic, action_mask=None):
    """ref modules.py:220-248 — soft-argmax over actions.

    ``actions``: [..., K, H]; ``action_mask``: [..., K] validity (None =
    all valid); ``mode_is_min``: bool or bool tensor [...]. The reference
    flips weights for 'min' as ``1 - softmax`` — kept as-is.
    """
    scores = localize_scores(localize_p, frames, actions, mask, rate,
                             generator, deterministic)
    row = torch.sum(scores, dim=-1)                 # [..., K]
    if action_mask is None:
        action_mask = torch.ones_like(row, dtype=torch.bool)
    action_mask = action_mask.bool()
    w = masked_softmax(row, action_mask)
    is_min = torch.as_tensor(mode_is_min, device=row.device)[..., None]
    w = torch.where(is_min, 1.0 - w, w) * action_mask
    pooled = torch.sum(w[..., None] * actions, dim=-2)
    return torch.relu(linear(p["dense"], pooled))


def temporal_bands(p, length):
    """The conv-mode Temporal stack's three layers as banded matrices:
    three ``[3, length, length]`` tensors (one matrix per mode) with ``T @
    x`` equal to the layer's ``Conv1d(padding='same')`` on ``x``. They
    depend on the weights alone, so a loop over steps builds them once."""
    return tuple(torch.stack([conv1d_same_matrix(w, length)
                              for w in p[name + "_w"]])
                 for name in ("c1", "c2", "c3"))


def temporal_related_attn_batched(p, mode, attn_mean, conv_mode: bool,
                                  bands=None):
    """The gated temporal attention (ref modules.py:251-325): mode [B] int
    (0 = while (identity), 1 = before, 2 = after, 3 = between), attn_mean
    [B, F]. Nonzero modes run a learned 3-layer stack whose per-mode
    parameters are indexed from the ``[3, ...]`` tables. ``bands``:
    ``temporal_bands(p, F)`` where the caller has built them already."""
    F = attn_mean.shape[-1]
    midx = torch.clamp(mode.long() - 1, min=0)
    acts = (torch.relu, torch.relu, torch.sigmoid)
    h = attn_mean
    if conv_mode:
        for t, name, act in zip(bands or temporal_bands(p, F),
                                ("c1", "c2", "c3"), acts):
            h = act(torch.einsum("bu,bfu->bf", h, t[midx])
                    + p[name + "_b"][midx][:, None])
    else:
        for name, act in zip(("l1", "l2", "l3"), acts):
            h = act(torch.einsum("bu,buf->bf", h, p[name + "_w"][midx])
                    + p[name + "_b"][midx])
    return torch.where((mode == 0)[:, None], attn_mean, h)


def temporal_related_attn(p, mode, attn_mean, conv_mode: bool):
    """``temporal_related_attn_batched`` on one example: ``mode`` an int or
    0-dim tensor, ``attn_mean`` [F]."""
    mode = torch.as_tensor(mode, device=attn_mean.device).reshape(1)
    return temporal_related_attn_batched(p, mode, attn_mean[None],
                                         conv_mode)[0]


def temporal_module(p, mode, frames, attn_mean, mask, conv_mode, rate,
                    generator, deterministic):
    """ref modules.py:310-327 — mode [B], frames [B, F, H], attn_mean and
    mask [B, F]; returns (new frames [B, F, H], related attn [B, F]). One
    dropout site."""
    related = temporal_related_attn_batched(p, mode, attn_mean,
                                            conv_mode) * mask
    h = torch.relu(linear(p["dense"], related[..., None] * frames))
    h = dropout(h, rate, generator, deterministic)
    return layer_norm(p["ln"], h), related


def attnvideo_module(frames, attn):
    """ref modules.py:330-340."""
    return attn[..., None] * frames


def _filter_mlp(w1, b1, w2, b2, frames, rate, generator, deterministic):
    """Two dropout sites."""
    h = dropout(torch.relu(frames @ w1 + b1), rate, generator, deterministic)
    return dropout(torch.relu(h @ w2 + b2), rate, generator, deterministic)


def filter_module_vec(p, frames, kw, mask, rate, generator, deterministic,
                      attention="parity"):
    """ref modules.py:343-378, tensor-keyword path -> [..., H].

    'parity' replicates the reference's degenerate uniform attention (its
    softmax normalizes a [F, 1] tensor along the singleton axis); 'softmax'
    is the corrected masked softmax over frames.
    """
    feat = _filter_mlp(p["repr_w1"], p["repr_b1"], p["repr_w2"],
                       p["repr_b2"], frames, rate, generator, deterministic)
    if attention == "parity":
        weights = mask[..., None]
    else:
        fk = torch.cat([feat, kw[..., None, :].expand_as(feat)], dim=-1)
        logits = (fk @ p["attn_w"] + p["attn_b"])[..., 0]    # [..., F]
        weights = masked_softmax(logits, mask)[..., None]
    pooled = torch.sum(weights * feat * mask[..., None], dim=-2)
    return torch.relu(linear(p["dense"], pooled))


def _kw_mlp(p, kw_index, frames, rate, generator, deterministic):
    return _filter_mlp(p["kw_w1"][kw_index], p["kw_b1"][kw_index],
                       p["kw_w2"][kw_index], p["kw_b2"][kw_index], frames,
                       rate, generator, deterministic)


def filter_module_kw(p, frames, kw_index: int, mask, rate, generator,
                     deterministic):
    """ref modules.py:369-377, type-keyword path: per-type MLP + sum-pool.
    ``kw_index`` is one type keyword for every row (group rows by keyword
    before calling; a weight matrix is never gathered per example)."""
    feat = _kw_mlp(p, kw_index, frames, rate, generator, deterministic)
    pooled = torch.sum(feat * mask[..., None], dim=-2)
    return torch.relu(linear(p["dense"], pooled))


def filterframe_module_vec(p, frames, kw, mask, rate, generator,
                           deterministic):
    """ref modules.py:381-414, tensor-keyword path -> [..., F, H]. Three
    dropout sites."""
    feat = _filter_mlp(p["repr_w1"], p["repr_b1"], p["repr_w2"],
                       p["repr_b2"], frames, rate, generator, deterministic)
    fk = torch.cat([feat, kw[..., None, :].expand_as(feat)], dim=-1)
    gate = torch.sigmoid(fk @ p["attn_w"] + p["attn_b"])     # [..., F, 1]
    out = torch.relu(linear(p["dense"], gate * feat))
    out = dropout(out, rate, generator, deterministic)
    return out * mask[..., None]


def filterframe_module_kw(p, frames, kw_index: int, mask, rate, generator,
                          deterministic):
    """ref modules.py:405-413, type-keyword path -> [..., F, H]
    (``kw_index`` as in ``filter_module_kw``). Three dropout sites."""
    feat = _kw_mlp(p, kw_index, frames, rate, generator, deterministic)
    out = torch.relu(linear(p["dense"], feat))
    out = dropout(out, rate, generator, deterministic)
    return out * mask[..., None]


def relate_module(p, mode_is_backward, attn, mask):
    """ref modules.py:417-435 — learned per-position shift, masked softmax.
    ``mode_is_backward``: bool or bool tensor [...]."""
    beta = p["beta"][:attn.shape[-1]]
    back = torch.as_tensor(mode_is_backward, device=attn.device)[..., None]
    return masked_softmax(torch.where(back, attn - beta, attn + beta), mask)


# ---------------------------------------------------------------------------
# Parameter initialization (torch-default-compatible distributions)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound, device=None):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u * (2 * bound) - bound).to(device)


def _init_linear(gen, fan_in, fan_out, device=None):
    bound = 1.0 / math.sqrt(fan_in)
    return {
        "w": _uniform(gen, (fan_in, fan_out), bound, device),
        "b": _uniform(gen, (fan_out,), bound, device),
    }


def init_module_params(gen, config, device=None) -> dict:
    """All module parameters for one model, drawn from ``gen`` (a CPU
    ``torch.Generator``). ``config`` keys: hidden_size, max_video_length,
    object_types, have_pretrain_head. Same key tree and shapes as the JAX
    package's ``init_module_params``; the numbers differ (another RNG)."""
    H = config["hidden_size"]
    F = config["max_video_length"]
    conv_mode = F > 32

    def lin(fi, fo):
        return _init_linear(gen, fi, fo, device)

    def stacked_lin(n, fi, fo):
        ps = [lin(fi, fo) for _ in range(n)]
        return (torch.stack([p["w"] for p in ps]),
                torch.stack([p["b"] for p in ps]))

    params = {
        "compare": lin(2 * H, H),
        "equals": lin(2 * H, H),
        "xor": lin(3 * H, H),
        "query": {"l1": lin(H, H)},
        "toaction": {"l1": lin(2 * H, H), "l2": lin(H, H)},
        "hasitem": {"l1": lin(H, H), "l2": lin(H, 1)},
        "exists": {"l1": lin(3 * H, H), "l2": lin(H, H)},
        "localize": {"v1": lin(H, H), "v2": lin(H, H), "k": lin(H, H)},
        "superlative": {"dense": lin(H, H)},
        "relate": {
            "beta": torch.rand((F,), generator=gen).to(device),
        },
    }

    t: dict = {
        "dense": lin(H, H),
        "ln": {"scale": torch.ones((H,), device=device),
               "bias": torch.zeros((H,), device=device)},
    }
    if conv_mode:
        k = round(F / 4)
        for name, ksize in (("c1", k), ("c2", k), ("c3", 2 * k + 1)):
            bound = 1.0 / math.sqrt(ksize)
            t[name + "_w"] = _uniform(gen, (3, ksize), bound, device)
            t[name + "_b"] = _uniform(gen, (3,), bound, device)
    else:
        for name in ("l1", "l2", "l3"):
            t[name + "_w"], t[name + "_b"] = stacked_lin(3, F, F)
    params["temporal"] = t

    for name in ("filter", "filterframe"):
        repr1, repr2 = lin(H, H), lin(H, H)
        kw_w1, kw_b1 = stacked_lin(3, H, H)
        kw_w2, kw_b2 = stacked_lin(3, H, H)
        attn = lin(2 * H, 1)
        params[name] = {
            "repr_w1": repr1["w"], "repr_b1": repr1["b"],
            "repr_w2": repr2["w"], "repr_b2": repr2["b"],
            "kw_w1": kw_w1, "kw_b1": kw_b1, "kw_w2": kw_w2, "kw_b2": kw_b2,
            "attn_w": attn["w"], "attn_b": attn["b"],
            "dense": lin(H, H),
        }

    if config.get("have_pretrain_head", False):
        params["heads"] = {
            "equals": lin(H, 1),
            "exists": lin(H, 2),
            "xor": lin(H, 2),
            "query": lin(H, config["object_types"]),
            "filterframe": lin(H, config["object_types"]),
        }
    return params
