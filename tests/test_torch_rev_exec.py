"""Port parity: the reversible training executor
(``VideoNMN(executor="rev")``, stair_tpu_torch/models/rev_exec.py).

``total_loss`` on ``add_fake_supervision`` batches over the program pool,
every gradient leaf by its key path:

- at dropout 0, the port's ``"rev"`` against its ``"step"`` route (1e-5 of
  each leaf's scale), and both against ``jax.grad`` of the JAX package with
  ``STAIR_REV=auto`` (its reversible executor) and ``STAIR_REV=0`` (the
  autodiff scan), from the same weights (1e-4 of each leaf's scale), with
  and without aux embeddings;
- at dropout 0.25, ``"rev"`` against ``"step"`` under one seed (1e-5): the
  backward's replay must draw the forward's masks (``jax.random``'s masks
  cannot be reproduced, so JAX is no reference there), and another seed
  gives another loss;
- the ``"rev"`` route really goes through ``rev_exec``'s backward and the
  slot updates (4 sets per step forward; 8 zeros and 7 adds per step
  backward), and leaves the caller's register files alone.

On the card, ``"rev"`` against ``"step"`` with the slot kernels' launch
counts.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.models import nmn as TN
from stair_tpu_torch.models import rev_exec as TR
from stair_tpu_torch.testing import workload as TW
from stair_tpu_torch.train.losses import total_loss
from stair_tpu_torch.weights import grads_to_numpy
from torch_port_util import (  # noqa: F401
    assert_grad_trees_close, cuda_device, port_model, torch_batch,
)

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.testing import workload as JW
    from stair_tpu.train.losses import total_loss as jax_total_loss
    from test_rev_exec import _with_aux
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

B, WINDOW = 12, 8


def _cfg(dropout=0.0, dtype="float32", hidden=64):
    cfg = TW.workload_config(hidden_size=hidden, video_size=32, text_size=20,
                             max_video_length=16)
    return TN.NMNConfig(**{**cfg.to_dict(), "dropout": dropout,
                           "compute_dtype": dtype})


def _batch(cfg, aux=False):
    batch = TW.add_fake_supervision(TW.make_batch(cfg, batch_size=B), cfg)
    if aux:
        # half the PUSH_TEXT steps take their program word's own encoding
        rng = np.random.RandomState(3)
        tr = batch["trace"]
        T = tr["opcode"].shape[1]
        batch["aux_emb"] = rng.randn(B, T, 3, cfg.text_size).astype(
            np.float32)
        batch["aux_mask"] = np.ones((B, T, 3), np.float32)
        pick = (np.asarray(tr["opcode"]) == 1) & (
            np.arange(B)[:, None] % 2 == 0)
        batch["trace"] = dict(
            tr, span_start=np.where(pick, -2, tr["span_start"]),
            span_end=np.where(pick, -2, tr["span_end"]))
    return batch


def _port_grads(model, batch, seed=7):
    model.zero_grad(set_to_none=True)
    loss, _ = total_loss(model, torch_batch(batch),
                         torch.Generator().manual_seed(seed), 1.0, 1.0, 1.0,
                         1.0, contrastive_window=WINDOW)
    loss.backward()
    return float(loss.detach()), grads_to_numpy(model)


def _models(cfg, seed=0):
    step = TN.VideoNMN(cfg, generator=torch.Generator().manual_seed(seed),
                       executor="step")
    rev = TN.VideoNMN(cfg, TN.tree_map(lambda x: x.detach().clone(),
                                       step.param_tree()), executor="rev")
    return step, rev


@needs_jax
@pytest.mark.parametrize("aux", [False, True])
def test_rev_and_step_gradients_match_jax(monkeypatch, aux):
    cfg = _cfg()
    jcfg = JW.workload_config(hidden_size=64, video_size=32, text_size=20,
                              max_video_length=16)
    jcfg = type(jcfg)(**cfg.to_dict())
    jmodel, params = JW.build_model(jcfg)
    batch = _batch(cfg, aux)
    if aux:
        # the port's aux batch is the JAX test's
        want = _with_aux(TW.add_fake_supervision(
            TW.make_batch(cfg, batch_size=B), cfg), jcfg, cfg.text_size)
        for k in ("aux_emb", "aux_mask"):
            np.testing.assert_array_equal(want[k], batch[k])
        np.testing.assert_array_equal(want["trace"]["span_start"],
                                      batch["trace"]["span_start"])

    def jloss(p):
        return jax_total_loss(
            jmodel, p, batch, jax.random.PRNGKey(7), 1.0, 1.0,
            jnp.float32(1.0), jnp.float32(1.0), deterministic=False,
            contrastive_window=WINDOW)[0]

    port = {}
    for executor in ("step", "rev"):
        pm = port_model(jcfg, params, executor=executor)
        port[executor] = _port_grads(pm, batch)
    assert port["rev"][0] == pytest.approx(port["step"][0], rel=1e-6)
    assert_grad_trees_close(port["step"][1], port["rev"][1], rel=1e-5)
    for rev in ("auto", "0"):
        monkeypatch.setenv("STAIR_REV", rev)
        jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
        jg = jax.device_get(jg)
        for executor, (loss, grads) in port.items():
            assert loss == pytest.approx(float(jl), rel=1e-5), (rev, executor)
            assert_grad_trees_close(jg, grads, rel=1e-4,
                                    prefix=f"STAIR_REV={rev} {executor}")


@pytest.mark.parametrize("dropout,dtype,aux", [
    (0.0, "float32", False), (0.25, "float32", False),
    (0.25, "float32", True), (0.25, "bfloat16", False)])
def test_rev_matches_step_under_one_seed(dropout, dtype, aux):
    cfg = _cfg(dropout, dtype)
    batch = _batch(cfg, aux)
    step, rev = _models(cfg)
    ls, gs = _port_grads(step, batch)
    lr, gr = _port_grads(rev, batch)
    assert lr == pytest.approx(ls, rel=1e-6)
    assert_grad_trees_close(gs, gr, rel=1e-5)
    assert any(float(np.abs(g).max()) > 0 for g in _leaves(gs))
    if dropout:
        other, _ = _port_grads(rev, batch, seed=8)
        assert other != lr            # the masks come from the seed


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_rev_path_engaged(monkeypatch):
    """Training with ``executor="rev"`` must go through ``rev_exec``'s
    forward and backward and the slot updates (a silent use of the
    autograd route would pass the parity tests vacuously)."""
    import stair_tpu_torch.ops.regslots as RS

    calls = {"fwd": 0, "bwd": 0, "slot_set": 0, "slot_zero": 0,
             "slot_add": 0, "slot_add_many": 0}
    fwd, bwd = TR._RevExec.forward, TR._RevExec.backward

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(TR._RevExec, "forward",
                        staticmethod(count("fwd", fwd)))
    monkeypatch.setattr(TR._RevExec, "backward",
                        staticmethod(count("bwd", bwd)))
    for key in ("slot_set", "slot_zero", "slot_add", "slot_add_many"):
        monkeypatch.setattr(RS, key, count(key, getattr(RS, key)))
    cfg = _cfg(0.25)
    batch = _batch(cfg)
    T = batch["trace"]["opcode"].shape[1]
    _, rev = _models(cfg)
    _port_grads(rev, batch)
    assert calls == {"fwd": 1, "bwd": 1, "slot_set": 4 * T,
                     "slot_zero": 8 * T, "slot_add": 0, "slot_add_many": T}
    # eval on the same model is the "step" route
    rev(torch_batch(batch))
    assert calls["fwd"] == 1


def test_rev_backward_leaves_the_forward_outputs_alone():
    """The backward rebuilds the files by zeroing slots in its own copies:
    the register files the forward returned keep their values."""
    cfg = _cfg(0.25)
    batch = torch_batch(_batch(cfg))
    _, rev = _models(cfg)
    out = rev(batch, generator=torch.Generator().manual_seed(1),
              deterministic=False)
    before = {k: out[k].detach().clone() for k in ("regs_vec", "regs_frames",
                                                   "regs_attn")}
    (out["logits"].sum() + out["regs_frames"].sum()).backward()
    for k, v in before.items():
        assert torch.equal(out[k].detach(), v), k
    assert float(before["regs_frames"].abs().sum()) > 0


@pytest.mark.cuda
def test_rev_matches_step_on_card_with_slot_kernel_counts(cuda_device):
    """On CUDA tensors the ``"rev"`` route launches the slot kernels (4 T
    sets, 8 T zeros, T launches of the seven adds per step) and no megakernel, and gives the
    ``"step"`` route's loss and gradients under one seed (float32, 1e-4 of
    each leaf's scale: the replay reorders no sums, the accumulation of the
    weight cotangents over steps does)."""
    from stair_tpu_torch.ops import _build

    cfg = _cfg(0.25, hidden=128)
    batch = TW.to_device(_batch(cfg), cuda_device)
    T = batch["trace"]["opcode"].shape[1]
    got = {}
    for executor in ("step", "rev"):
        model = TN.VideoNMN(cfg, generator=torch.Generator().manual_seed(0),
                            device=cuda_device, executor=executor)
        _build.reset_launches()
        loss, _ = total_loss(model, batch, torch.Generator().manual_seed(7),
                             1.0, 1.0, 1.0, 1.0, contrastive_window=WINDOW)
        loss.backward()
        torch.cuda.synchronize()
        got[executor] = (float(loss.detach()), grads_to_numpy(model),
                         dict(_build.LAUNCHES))
    launches = got["rev"][2]
    assert (launches["slot_set"], launches["slot_zero"],
            launches["slot_add_many"], launches["slot_add"]) == (
                4 * T, 8 * T, T, 0)
    assert launches["mega_exec_train"] == launches["executor_step"] == 0
    assert got["step"][2]["slot_set"] == 0
    assert got["rev"][0] == pytest.approx(got["step"][0], rel=1e-5)
    assert_grad_trees_close(got["step"][1], got["rev"][1], rel=1e-4)
