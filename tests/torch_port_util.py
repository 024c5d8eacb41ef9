"""Shared helpers for the PyTorch-port tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both frameworks;
JAX stays on the CPU (tests/conftest.py). ``cuda_device`` skips a test
when no NVIDIA GPU is present — decided inside the fixture, never while a
module is imported.
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from stair_tpu_torch.utils.device import exact_f32

    exact_f32()
    return torch.device("cuda")


def to_numpy_tree(tree):
    """JAX pytree of arrays (dicts, lists) -> the same tree of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def tree_shapes(tree):
    """The same tree with every leaf replaced by its shape."""
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_shapes(v) for v in tree]
    return tuple(tree.shape)


def assert_trees_equal(want, got, prefix=""):
    """Two params trees (dicts, lists, arrays) have the same keys and equal
    leaves, bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), prefix
        for k in want:
            assert_trees_equal(want[k], got[k], f"{prefix}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(want) == len(got), prefix
        for i, (a, b) in enumerate(zip(want, got)):
            assert_trees_equal(a, b, f"{prefix}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(want), got, prefix)
        assert np.asarray(want).dtype == got.dtype, prefix


def port_model(jax_cfg, jax_params, device=None):
    """The port's VideoNMN with the JAX model's config and weights."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
    from stair_tpu_torch.weights import params_from_numpy

    cfg = NMNConfig(**jax_cfg.to_dict())
    return VideoNMN(cfg, params_from_numpy(to_numpy_tree(jax_params)),
                    device=device)


def torch_batch(batch, device=None):
    from stair_tpu_torch.testing.workload import to_device

    return to_device(batch, device)


def assert_close(ref, out, keys, rtol, atol):
    for key in keys:
        np.testing.assert_allclose(
            np.asarray(ref[key], np.float32),
            out[key].detach().float().cpu().numpy(),
            rtol=rtol, atol=atol, err_msg=key,
        )


def assert_grad_trees_close(want, got, rel=1e-4, prefix=""):
    """Every gradient leaf within ``rel`` of the wanted leaf's scale
    (``max|a - b| <= rel * max|b|``, plus 1e-6 for leaves that are 0 but
    for rounding, such as the gradient of a key bias)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), prefix
        for k in want:
            assert_grad_trees_close(want[k], got[k], rel, f"{prefix}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), prefix
        for i, (a, b) in enumerate(zip(want, got)):
            assert_grad_trees_close(a, b, rel, f"{prefix}/{i}")
    else:
        want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
        assert want.shape == got.shape, prefix
        err = float(np.abs(want - got).max()) if want.size else 0.0
        assert err <= rel * float(np.abs(want).max()) + 1e-6, (prefix, err)
