"""CLIP vision tower (ViT) (port of ``stair_tpu/llm/clip.py``).

Frame features come from the penultimate layer's patch tokens of a CLIP
ViT-L/14: conv patch embedding as one matrix product over unfolded patches,
class token + learned positions, pre-LN transformer with quick-GELU. The
tower's attention is plain tensor code (dense softmax over 257 tokens), as
in the JAX package, where no kernel serves it either. Weights import from a
``transformers`` ``CLIPVisionModel`` state dict.

``preprocess_frames`` resizes with ``torch.nn.functional.interpolate``
(bicubic, antialiased) and not with PIL as the JAX package does; on 8-bit
frames the two agree to about one level of 255 before normalisation.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np
import torch

from stair_tpu_torch.llm.decoder import init_linear, randn
from stair_tpu_torch.models.modules import linear
from stair_tpu_torch.weights import ParamModule


@dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    d_model: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    d_ff: int = 4096
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    def to_dict(self):
        return asdict(self)


def _ln(p, x, eps):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class ClipVisionTower(ParamModule):
    def __init__(self, config: ClipVisionConfig, params: dict | None = None,
                 *, generator: torch.Generator | None = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = self.init(generator, device, dtype)
        self._hold(params, device)

    def init(self, gen, device=None, dtype=torch.float32) -> dict:
        cfg = self.config
        D, F, P = cfg.d_model, cfg.d_ff, cfg.patch_size

        def ln_p():
            return {"scale": torch.ones(D, dtype=dtype, device=device),
                    "bias": torch.zeros(D, dtype=dtype, device=device)}

        def lin(fi, fo):
            return init_linear(gen, fi, fo, device, dtype)

        def layer():
            return {
                "ln1": ln_p(),
                "q": lin(D, D), "k": lin(D, D), "v": lin(D, D),
                "o": lin(D, D),
                "ln2": ln_p(),
                "fc1": lin(D, F), "fc2": lin(F, D),
            }

        return {
            "patch_proj": randn(gen, (3 * P * P, D), 0.02, device, dtype),
            "class_embed": randn(gen, (D,), 0.02, device, dtype),
            "pos_embed": randn(gen, (cfg.num_patches + 1, D), 0.02, device,
                               dtype),
            "pre_ln": ln_p(),
            "layers": [layer() for _ in range(cfg.num_layers)],
        }

    def _attn(self, p, x, num_heads):
        B, L, D = x.shape
        h, hd = num_heads, D // num_heads
        q = linear(p["q"], x).reshape(B, L, h, hd)
        k = linear(p["k"], x).reshape(B, L, h, hd)
        v = linear(p["v"], x).reshape(B, L, h, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, D)
        return linear(p["o"], out)

    def forward_features(self, images, until_layer=-1):
        """Run the tower on ``[B, H, W, 3]`` normalized images; return the
        hidden states after ``until_layer`` blocks (negative = from the end,
        -1 = penultimate output)."""
        cfg = self.config
        eps = cfg.layer_norm_eps
        params = self.param_tree()
        B = images.shape[0]
        P = cfg.patch_size
        G = cfg.image_size // P
        x = images.reshape(B, G, P, G, P, 3)
        x = x.permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, G * G, 3 * P * P)
        x = x.to(params["patch_proj"].dtype) @ params["patch_proj"]
        cls = params["class_embed"].to(x.dtype).expand(B, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1)
        x = x + params["pos_embed"][None]
        x = _ln(params["pre_ln"], x, eps)
        layers = params["layers"]
        n = len(layers) + until_layer if until_layer < 0 else until_layer
        for layer in layers[:n]:
            h = _ln(layer["ln1"], x, eps)
            x = x + self._attn(layer, h, cfg.num_heads)
            h = _ln(layer["ln2"], x, eps)
            x = x + linear(layer["fc2"], _quick_gelu(linear(layer["fc1"], h)))
        return x

    def patch_features(self, images):
        """[B, H, W, 3] -> [B, S, D]: penultimate hidden states, CLS
        dropped."""
        return self.forward_features(images, until_layer=-1)[:, 1:]

    forward = patch_features


def import_clip_vision(state_dict) -> dict:
    """HF CLIPVisionModel state dict -> ClipVisionTower params (numpy)."""

    def _np(t):
        return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)

    sd = dict(state_dict)
    pfx = ("vision_model."
           if any(k.startswith("vision_model.") for k in sd) else "")

    def g(name):
        return _np(sd[pfx + name])

    def lin(name):
        return {"w": g(name + ".weight").T, "b": g(name + ".bias")}

    def ln(name):
        return {"scale": g(name + ".weight"), "bias": g(name + ".bias")}

    conv = g("embeddings.patch_embedding.weight")      # [D, 3, P, P]
    D = conv.shape[0]
    n_layer = 1 + max(
        int(k[len(pfx) + len("encoder.layers."):].split(".")[0])
        for k in sd if k.startswith(pfx + "encoder.layers.")
    )
    layers = []
    for i in range(n_layer):
        b = f"encoder.layers.{i}."
        layers.append({
            "ln1": ln(b + "layer_norm1"),
            "q": lin(b + "self_attn.q_proj"),
            "k": lin(b + "self_attn.k_proj"),
            "v": lin(b + "self_attn.v_proj"),
            "o": lin(b + "self_attn.out_proj"),
            "ln2": ln(b + "layer_norm2"),
            "fc1": lin(b + "mlp.fc1"),
            "fc2": lin(b + "mlp.fc2"),
        })
    return {
        "patch_proj": conv.reshape(D, -1).T,           # [(3*P*P), D]
        "class_embed": g("embeddings.class_embedding"),
        "pos_embed": g("embeddings.position_embedding.weight"),
        "pre_ln": ln("pre_layrnorm"),
        "layers": layers,
    }


#: CLIP image normalization (CLIPImageProcessor's values).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_frames(frames_uint8, size: int = 224, device=None):
    """[T, H, W, 3] uint8 (numpy or tensor) -> [T, size, size, 3] float32
    CLIP-normalized tensor on ``device``. The resize is bicubic with
    antialiasing, rounded back to 8-bit levels as an image library does."""
    x = torch.as_tensor(np.asarray(frames_uint8) if not torch.is_tensor(
        frames_uint8) else frames_uint8).to(device)
    x = x.permute(0, 3, 1, 2).float()
    if x.shape[-2:] != (size, size):
        x = torch.nn.functional.interpolate(
            x, size=(size, size), mode="bicubic", antialias=True,
            align_corners=False)
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    x = x.permute(0, 2, 3, 1) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
