"""Weight bridge between the JAX params pytree and the port.

A JAX params tree (nested dicts of arrays, with lists for a transformer's
``layers``; ``[in, out]`` linear weights) maps onto the port's parameters
key path by key path, with no renaming or transposing:
``VideoNMN(cfg, params_from_numpy(tree))``, and likewise ``Decoder``,
``ClipVisionTower``, ``VideoChatModel`` and ``VideoPrefixLM``. A module
holds its leaves in one ``nn.ParameterDict`` keyed by the key path joined
with ``/`` (a list index is its decimal digits: ``layers/0/q/w``);
``flatten_tree`` / ``unflatten_tree`` convert. ``params_to_numpy``
is the inverse and round-trips bit for bit; ``grads_to_numpy`` gives the
gradients in the same tree, so a test compares every gradient leaf by its
JAX key path. ``train/checkpoint.py`` reads and writes the JAX package's
``params.msgpack`` checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flatten_tree(tree, prefix="") -> dict:
    """Nested dicts/lists -> one dict keyed by the ``/``-joined key path."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten_tree(flat) -> dict:
    """The inverse of ``flatten_tree``; a node whose keys are all decimal
    digits comes back as a list."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


class ParamModule(nn.Module):
    """An ``nn.Module`` whose parameters are the leaves of a JAX-style params
    tree, held in one ``nn.ParameterDict`` keyed by ``flatten_tree``'s key
    paths; ``param_tree()`` gives the nested view back."""

    def _hold(self, params, device=None):
        self.weights = nn.ParameterDict({
            k: nn.Parameter(torch.as_tensor(v, device=device))
            for k, v in flatten_tree(params).items()
        })

    def param_tree(self) -> dict:
        return unflatten_tree(dict(self.weights.items()))


def tree_map(fn, tree):
    """``fn`` over every leaf of nested dicts/lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device=None) -> dict:
    """Nested dicts/lists of array-likes -> the same tree of torch tensors
    (copies, dtype kept)."""
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def params_to_numpy(tree) -> dict:
    """Nested dicts/lists of torch tensors (or a module with
    ``param_tree()``) -> the same tree of numpy arrays."""
    if hasattr(tree, "param_tree"):
        tree = tree.param_tree()
    return tree_map(lambda x: x.detach().cpu().numpy().copy(), tree)


def grads_to_numpy(model) -> dict:
    """The ``.grad`` of every parameter of a model with ``param_tree()``
    (``VideoNMN``, ``Decoder`` with or without LoRA leaves,
    ``VideoChatModel``, ``VideoPrefixLM``), as the same nested tree of numpy
    arrays under the JAX key paths (zeros where a parameter got no
    gradient, as JAX's grad gives)."""
    def leaf(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        return g.detach().cpu().numpy().copy()

    return tree_map(leaf, model.param_tree())
