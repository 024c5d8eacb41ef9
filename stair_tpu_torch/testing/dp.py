"""What one data-parallel rank runs for the tests and ``chip_smoke.py``:
the port's train step (``train/loop.py make_train_step(..., dp=)``) for a
few steps on the rank's shard of a batch made in the parent, and the eval
step on another.

``train_steps`` is handed to ``parallel.mesh.launch``; everything it needs
arrives as arguments (the model's config dict, its weights and the global
batch as numpy trees), so no rank draws its own inputs. It returns, per
step, the loss and the per-family sums the ranks agreed on, a digest of
the rank's parameters after the update, the kernel launches the step made
on this rank and its wall time; the averaged gradients of the first step
and the parameters after the last; and with an eval batch the gathered
predictions and sums of the eval step.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch


def param_digest(model) -> str:
    """sha256 of every parameter's bytes, in parameter order."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def train_steps(dp, cfg_dict, params, batch, args, steps=1, executor="mega",
                eval_batch=None, device="cpu"):
    """``steps`` train steps of a ``VideoNMN(NMNConfig(**cfg_dict),
    params)`` on rank ``dp``'s shard of ``batch`` (the step's dropout
    generator seeded with the step's index folded with the rank); then,
    with ``eval_batch``, one eval step on its shard. ``dp`` None runs the
    same on one ``device`` over the whole batch."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.parallel.mesh import shard_batch
    from stair_tpu_torch.testing.workload import to_device
    from stair_tpu_torch.train.loop import (
        make_eval_step, make_train_step, split_key,
    )
    from stair_tpu_torch.weights import (
        grads_to_numpy, params_from_numpy, params_to_numpy,
    )

    dev = dp.device if dp is not None else torch.device(device)
    rank = dp.rank if dp is not None else None

    def local(b):
        if dp is not None:
            b = shard_batch(b, dp.rank, dp.size)
        return to_device(b, dev)

    model = VideoNMN(NMNConfig(**cfg_dict), params_from_numpy(params),
                     device=dev, executor=executor)
    step = make_train_step(model, args, dp=dp)
    shard = local(batch)
    out = {"loss": [], "loss_sums": [], "loss_counts": [], "digest": [],
           "launches": [], "ms": []}
    for i in range(steps):
        _, gen = split_key([i, 0], rank)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        m = step(shard, gen, 1.0, 1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(dict(_build.LAUNCHES))
        out["loss"].append(float(m["loss"]))
        out["loss_sums"].append(m["loss_sums"].cpu().numpy())
        out["loss_counts"].append(m["loss_counts"].cpu().numpy())
        out["digest"].append(param_digest(model))
        if i == 0:
            out["grads"] = grads_to_numpy(model)
    out["params"] = params_to_numpy(model)
    if eval_batch is not None:
        res = make_eval_step(model, dp=dp)(local(eval_batch))
        out["eval"] = {k: v.cpu().numpy() for k, v in res.items()}
    return out


def train_cases(dp, cases):
    """``train_steps(dp, **case)`` for each case in turn, in one launch."""
    return [train_steps(dp, **case) for case in cases]
