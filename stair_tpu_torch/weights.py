"""Weight bridge between the JAX params pytree and the port.

A JAX params tree (nested dicts of arrays, ``[in, out]`` linear weights)
maps onto the port's parameters key path by key path, with no renaming or
transposing: ``VideoNMN(cfg, params_from_numpy(tree))``. ``params_to_numpy``
is the inverse and round-trips bit for bit; ``grads_to_numpy`` gives the
gradients in the same tree, so a test compares every gradient leaf by its
JAX key path. (Reading the JAX package's ``params.msgpack`` checkpoints is
not ported yet.)
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


def grads_to_numpy(model) -> dict:
    """The ``.grad`` of every parameter of a ``VideoNMN``, as a nested dict
    of numpy arrays under the JAX key paths (zeros where a parameter got no
    gradient, as JAX's grad gives)."""
    def leaf(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        return g.detach().cpu().numpy().copy()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in tree.items()}

    return walk(model.param_tree())
