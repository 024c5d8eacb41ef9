"""Port parity: the CLIP vision tower (stair_tpu_torch/llm/clip.py).

A tiny tower with JAX weights carried over: ``patch_features`` and
``forward_features`` at every depth against the JAX tower (float32, atol
1e-4); ``import_clip_vision`` against a random-init ``transformers``
``CLIPVisionModel``'s penultimate hidden states; ``preprocess_frames``
(a torch bicubic resize) against the JAX package's PIL resize: a
different bicubic kernel rounding, bounded at 2 of 255 levels before
normalisation at worst and half a level on average, and exact where no
resize is needed.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.llm import clip as TC
from stair_tpu_torch.weights import params_from_numpy, params_to_numpy
from torch_port_util import assert_trees_equal, to_numpy_tree, tree_shapes

try:
    import jax

    from stair_tpu.llm import clip as JC
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

KW = dict(image_size=56, patch_size=14, d_model=32, num_heads=2,
          num_layers=3, d_ff=64)


def _pair():
    jtower = JC.ClipVisionTower(JC.ClipVisionConfig(**KW))
    params = jtower.init(jax.random.PRNGKey(0))
    port = TC.ClipVisionTower(TC.ClipVisionConfig(**KW),
                              params_from_numpy(to_numpy_tree(params)))
    return jtower, params, port


@needs_jax
def test_config_and_init_tree_match_jax():
    jtower, params, port = _pair()
    assert port.config.to_dict() == jtower.config.__dict__
    assert port.config.num_patches == jtower.config.num_patches == 16
    assert TC.ClipVisionConfig().to_dict() == JC.ClipVisionConfig().__dict__
    fresh = TC.ClipVisionTower(port.config,
                               generator=torch.Generator().manual_seed(1))
    assert tree_shapes(params_to_numpy(fresh)) == tree_shapes(params)
    assert_trees_equal(to_numpy_tree(params), params_to_numpy(port))


@needs_jax
@pytest.mark.parametrize("until", [-1, 0, 2, 3], ids=lambda u: f"until{u}")
def test_forward_features(until):
    jtower, params, port = _pair()
    images = np.random.RandomState(0).randn(3, 56, 56, 3).astype(np.float32)
    ref = np.asarray(jtower.forward_features(params, images, until))
    with torch.no_grad():
        out = port.forward_features(torch.from_numpy(images), until).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@needs_jax
def test_patch_features():
    jtower, params, port = _pair()
    images = np.random.RandomState(1).randn(2, 56, 56, 3).astype(np.float32)
    ref = np.asarray(jtower.patch_features(params, images))
    with torch.no_grad():
        out = port.patch_features(torch.from_numpy(images)).numpy()
    assert out.shape == ref.shape == (2, 16, 32)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_import_clip_vision_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=2, image_size=56, patch_size=14,
        hidden_act="quick_gelu")
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(hf_cfg).eval()
    port = TC.ClipVisionTower(
        TC.ClipVisionConfig(**KW),
        params_from_numpy(TC.import_clip_vision(hf.state_dict())))
    images = torch.from_numpy(
        np.random.RandomState(0).randn(2, 56, 56, 3).astype(np.float32))
    with torch.no_grad():
        ref = hf(pixel_values=images.permute(0, 3, 1, 2),
                 output_hidden_states=True).hidden_states[-2][:, 1:]
        out = port.patch_features(images)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def _frames(T, H, W, seed):
    """Smooth random frames (a video is not white noise)."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.rand(T, 3, 9, 12).astype(np.float32))
    x = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear")
    return (x.permute(0, 2, 3, 1) * 255).round().numpy().astype(np.uint8)


@needs_jax
@pytest.mark.parametrize("shape", [(96, 128), (300, 224), (40, 60)],
                         ids=["down", "mixed", "up"])
def test_preprocess_frames_against_pil(shape):
    pytest.importorskip("PIL")
    frames = _frames(3, *shape, seed=shape[0])
    ref = JC.preprocess_frames(frames, size=56)
    out = TC.preprocess_frames(frames, size=56).numpy()
    assert out.shape == ref.shape == (3, 56, 56, 3) and out.dtype == ref.dtype
    levels = np.abs(out - ref) * np.asarray(TC.CLIP_STD, np.float32) * 255.0
    assert levels.max() <= 2.0 + 1e-3, levels.max()
    assert levels.mean() <= 0.5, levels.mean()


@needs_jax
def test_preprocess_frames_without_resize_is_exact():
    pytest.importorskip("PIL")
    frames = _frames(2, 56, 56, seed=5)
    np.testing.assert_allclose(TC.preprocess_frames(frames, size=56).numpy(),
                               JC.preprocess_frames(frames, size=56),
                               rtol=0, atol=1e-6)
