"""Port parity: stair_tpu_torch.models.modules vs stair_tpu.models.modules.

The helpers the executor's plain version and the decoder use, on the same
numpy inputs, in float32 (rtol 1e-5); and ``init_module_params`` giving
the JAX package's key tree and shapes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from stair_tpu.models import modules as JM
from stair_tpu_torch.models import modules as TM

RTOL, ATOL = 1e-5, 1e-6


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=rtol, atol=atol)


def test_linear_cosine_and_safe_sqrt():
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(5, 8).astype(np.float32),
               rng.randn(8, 3).astype(np.float32),
               rng.randn(3).astype(np.float32))
    (jx, jw, jb), (tx, tw, tb) = _pair(x, w, b)
    _close(JM.linear({"w": jw, "b": jb}, jx),
           TM.linear({"w": tw, "b": tb}, tx))
    y = rng.randn(5, 8).astype(np.float32)
    y[2] = 0.0                                    # zero row: eps clamp
    (jy,), (ty,) = _pair(y)
    _close(JM.cosine(jx, jy), TM.cosine(tx, ty))
    s = np.array([0.0, 1e-40, 4.0], np.float32)
    _close(JM._safe_sqrt(jnp.asarray(s)), TM._safe_sqrt(torch.from_numpy(s)))


def test_cosine_matrix():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16).astype(np.float32)
    y = rng.randn(7, 16).astype(np.float32)
    y[3] = 0.0
    (jx, jy), (tx, ty) = _pair(x, y)
    _close(JM.cosine_matrix(jx, jy), TM.cosine_matrix(tx, ty))


def test_masked_softmax_including_all_masked_row():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 9).astype(np.float32) * 3
    mask = rng.rand(4, 9) > 0.4
    mask[1] = False                               # all-masked row -> 0
    mask[2, :] = False
    mask[2, 4] = True                             # single valid entry
    (jx, jm), (tx, tm) = _pair(x, mask)
    j = JM.masked_softmax(jx, jm)
    t = TM.masked_softmax(tx, tm)
    _close(j, t)
    assert np.all(t[1].numpy() == 0.0)
    assert t[2, 4].item() == pytest.approx(1.0)


def test_layer_norm():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 32).astype(np.float32) * 2 + 1
    scale = rng.rand(32).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    (jx, js, jb), (tx, ts, tb) = _pair(x, scale, bias)
    _close(JM.layer_norm({"scale": js, "bias": jb}, jx),
           TM.layer_norm({"scale": ts, "bias": tb}, tx), atol=1e-5)


@pytest.mark.parametrize("k,length", [(3, 8), (4, 8), (5, 16), (12, 48)])
def test_conv1d_same_matrix_odd_and_even(k, length):
    rng = np.random.RandomState(k)
    w = rng.randn(k).astype(np.float32)
    x = rng.randn(length).astype(np.float32)
    jt = JM.conv1d_same_matrix(jnp.asarray(w), length)
    tt = TM.conv1d_same_matrix(torch.from_numpy(w), length)
    _close(jt, tt)
    # and it is torch's Conv1d(padding='same') on x
    conv = torch.nn.functional.conv1d(
        torch.from_numpy(x)[None, None], torch.from_numpy(w)[None, None],
        padding="same")[0, 0]
    np.testing.assert_allclose((tt @ torch.from_numpy(x)).numpy(),
                               conv.numpy(), rtol=1e-5, atol=1e-5)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("F", [16, 48])   # linear and conv temporal modes
def test_init_module_params_key_tree_and_shapes(F):
    cfg = {"hidden_size": 32, "max_video_length": F, "dropout": 0.1,
           "object_types": 5, "have_pretrain_head": True}
    j = JM.init_module_params(jax.random.PRNGKey(0), cfg)
    t = TM.init_module_params(torch.Generator().manual_seed(0), cfg)
    assert _shapes(jax.tree_util.tree_map(np.asarray, j)) == _shapes(t)
    # fan-in bounds hold (torch-default uniform init)
    w = t["compare"]["w"]
    assert float(w.abs().max()) <= 1.0 / np.sqrt(64) + 1e-6
