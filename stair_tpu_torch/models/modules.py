"""Module helpers and parameter init (port of ``stair_tpu/models/modules.py``).

The small building blocks the executor's plain version, the decoder and
the losses use (with ``dropout`` and ``l2_normalize`` for training), and
``init_module_params``
with the JAX package's key tree and shapes. Linear weights keep the
``[in, out]`` convention, so parameters carry over key path by key path.
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
