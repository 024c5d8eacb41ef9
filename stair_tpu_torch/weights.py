"""Weight bridge between the JAX params pytree and the port.

A JAX params tree (nested dicts of arrays, ``[in, out]`` linear weights)
maps onto the port's parameters key path by key path, with no renaming or
transposing: ``VideoNMN(cfg, params_from_numpy(tree))``. ``params_to_numpy``
is the inverse and round-trips bit for bit. (Reading the JAX package's
``params.msgpack`` checkpoints is not ported yet.)
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device=None) -> dict:
    """Nested dict of array-likes -> nested dict of torch tensors (copies,
    dtype kept)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree) -> dict:
    """Nested dict of torch tensors (or a ``VideoNMN``) -> nested dict of
    numpy arrays."""
    if hasattr(tree, "param_tree"):
        tree = tree.param_tree()
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()
