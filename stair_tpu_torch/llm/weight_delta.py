"""Weight-delta distribution: publish fine-tunes as diffs against a base
(port of ``stair_tpu/llm/weight_delta.py``).

Equivalent of yellow-binary-tree/STAIR ``video_chatgpt/model/make_delta.py``
and ``consolidate.py``: a fine-tuned checkpoint is stored as per-leaf deltas
from the base model (newly-added leaves — projector, adapters, resized rows
— are stored whole), and applying the delta reconstructs the fine-tune.

Works on any ``params.msgpack`` tree of either package, through the port's
own codec (``train/checkpoint.py``): leaves are matched by their
``/``-joined key paths and the result is written in the layout flax's
``serialization`` writes, so a delta made by either package applies in the
other. A bf16 leaf's difference and sum are taken in bf16 (computed in
float32 and rounded once), as numpy's bfloat16 arithmetic does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from stair_tpu_torch.train.checkpoint import (
    Bfloat16Array, _leaf_from_tensor, _tensor_from_leaf, from_bytes, to_bytes,
)


def _flat(tree, prefix="") -> dict:
    """Nested dicts -> ``{"a/b/c": leaf}`` in insertion order (flax's
    ``flatten_dict(sep="/")``: an empty dict contributes nothing)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _combine(a, b, op):
    """``op(a, b)`` for two leaves of one shape; bf16 leaves stay bf16."""
    if isinstance(a, Bfloat16Array) or isinstance(b, Bfloat16Array):
        return _leaf_from_tensor(op(_tensor_from_leaf(a), _tensor_from_leaf(b)))
    return op(np.asarray(a), np.asarray(b))


def _same_shape(base: dict, key: str, val) -> bool:
    return key in base and np.shape(base[key]) == np.shape(val)


def make_delta(base: dict, finetuned: dict) -> dict:
    """finetuned - base per shared leaf; new/shape-changed leaves whole."""
    fb, ff = _flat(base), _flat(finetuned)
    delta = {}
    for key, val in ff.items():
        if _same_shape(fb, key, val):
            delta[key] = _combine(val, fb[key], lambda x, y: x - y)
        else:
            delta[key] = val  # new leaf: store whole
    return _unflat(delta)


def apply_delta(base: dict, delta: dict) -> dict:
    fb, fd = _flat(base), _flat(delta)
    out = {}
    for key, val in fd.items():
        if _same_shape(fb, key, val):
            out[key] = _combine(fb[key], val, lambda x, y: x + y)
        else:
            out[key] = val
    return _unflat(out)


def params_tree(model_or_tree) -> dict:
    """A module's parameters (anything with ``param_tree()``) or a tree of
    tensors as the nested dict of leaves the codec writes (a list becomes
    a dict keyed by its decimal indices, as flax writes it)."""
    tree = (model_or_tree.param_tree() if hasattr(model_or_tree, "param_tree")
            else model_or_tree)

    def conv(node):
        if isinstance(node, dict):
            return {str(k): conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return {str(i): conv(v) for i, v in enumerate(node)}
        if torch.is_tensor(node):
            return _leaf_from_tensor(node)
        return node

    return conv(tree)


def _load(path):
    with open(path, "rb") as f:
        return from_bytes(f.read())


def _save(tree, path):
    with open(path, "wb") as f:
        f.write(to_bytes(tree))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--func", choices=["make", "apply"], required=True)
    p.add_argument("--base", required=True)
    p.add_argument("--target", required=True,
                   help="fine-tuned params (make) or delta file (apply)")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    base = _load(args.base)
    target = _load(args.target)
    if args.func == "make":
        _save(make_delta(base, target), args.output)
    else:
        _save(apply_delta(base, target), args.output)
    print("wrote", args.output)


if __name__ == "__main__":
    main()
