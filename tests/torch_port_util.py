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
    """JAX pytree of arrays -> nested dict of float32/int numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


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
