"""Port parity: the NMN train step (stair_tpu_torch/train/loop.py).

The JAX package's ``total_loss`` gradient and ``make_train_step`` run with
their training kernels under the Pallas interpreter (TPU kernels #2, #3,
#5 and #6: ``STAIR_PALLAS_LSTM_TRAIN`` and ``STAIR_MEGA_TRAIN`` set to
``interpret``), the port's on CPU tensors (the plain versions of the same
kernels), from the same weights and the same ``add_fake_supervision``
batch over every opcode, at dropout 0 (the two frameworks' dropout masks
cannot agree; the executor's in-kernel dropout is held bit-exact in
tests/test_torch_mega_grad.py).

- one gradient: the loss, and every gradient leaf by its JAX key path, at
  rtol 1e-4 with atol 1e-4 of the leaf's largest value plus 1e-6 (leaves
  whose gradient vanishes in exact arithmetic are float32 noise on both
  sides);
- three Adam steps with the trainer's linear schedule: the loss at each
  step at rtol 1e-4, and every parameter after the third at rtol / atol
  1e-4 (Adam's ``m / (sqrt(v) + eps)`` turns a gradient's relative error
  into the same relative error of the update).

On the card, one step's gradients on the kernel route (CUDA tensors) are
held against the plain route (the same model on the CPU).
"""

import types

import numpy as np
import pytest
import torch

from stair_tpu_torch.models.nmn import NMNConfig
from stair_tpu_torch.testing import workload as TW
from stair_tpu_torch.train import loop as TLP
from stair_tpu_torch.train import losses as TLS
from stair_tpu_torch.weights import grads_to_numpy, params_to_numpy
from torch_port_util import cuda_device, port_model, torch_batch  # noqa: F401

try:
    import jax
    import jax.numpy as jnp
    import optax

    from stair_tpu.testing import workload as JW
    from stair_tpu.train import loop as JLP
    from stair_tpu.train import losses as JLS
    from test_mega_exec import PROGRAMS, _batch, _build
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

ARGS = types.SimpleNamespace(
    lr=1e-2, scheduler_start_factor=1.0, scheduler_end_factor=0.1,
    scheduler_total_iters=4, module_loss_weight=1.0, decoder_loss_weight=1.0,
    modules_no_intermediate_train=["FilterFrame"], contrastive_window=8)


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("STAIR_PALLAS_LSTM_TRAIN", "interpret")
    monkeypatch.setenv("STAIR_MEGA_TRAIN", "interpret")
    monkeypatch.setenv("STAIR_FUSED_EXEC", "0")
    monkeypatch.setenv("STAIR_MEGA_EXEC", "0")


def _setup():
    cfg, model, params = _build()
    assert cfg.dropout == 0.0
    batch, _ = _batch(cfg, PROGRAMS, seed=1)
    batch["answer"] = np.random.RandomState(3).randint(
        0, cfg.answer_vocab_length, (len(PROGRAMS),)).astype(np.int32)
    batch = JW.add_fake_supervision(batch, cfg)
    return cfg, model, params, batch


def _walk(ref, mine, check, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(mine), path
        for k in ref:
            _walk(ref[k], mine[k], check, f"{path}/{k}")
    else:
        check(np.asarray(ref), mine, path)


@needs_jax
def test_train_step_gradients_match_jax(interpret_kernels):
    cfg, model, params, batch = _setup()

    def jloss(p):
        return JLS.total_loss(
            model, p, batch, jax.random.PRNGKey(0), 1.0, 1.0, 1.0, 1.0,
            deterministic=False, contrastive_window=ARGS.contrastive_window)

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(params)

    pm = port_model(cfg, params)
    loss, aux = TLS.total_loss(
        pm, torch_batch(batch), torch.Generator().manual_seed(0), 1.0, 1.0,
        1.0, 1.0, deterministic=False,
        contrastive_window=ARGS.contrastive_window)
    loss.backward()
    np.testing.assert_allclose(float(jl), float(loss.detach()), rtol=1e-4)
    for k in ("loss_sums", "loss_counts"):
        np.testing.assert_allclose(np.asarray(jaux["telemetry"][k]),
                                   aux["telemetry"][k].detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)

    def check(a, b, path):
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale + 1e-6,
                                   err_msg=path)

    _walk(jg, grads_to_numpy(pm), check)


@needs_jax
def test_three_adam_steps_match_jax(interpret_kernels):
    cfg, model, params, batch = _setup()
    tx = optax.adam(JLP.lr_schedule(ARGS))
    jstep = JLP.make_train_step(model, tx, ARGS)
    opt_state = tx.init(params)
    pm = port_model(cfg, params)
    tstep = TLP.make_train_step(pm, ARGS)
    tb = torch_batch(batch)
    p = params
    for i in range(3):
        p, opt_state, jm = jstep(p, opt_state, batch, jax.random.PRNGKey(i),
                                 jnp.float32(1), jnp.float32(1))
        tm = tstep(tb, torch.Generator().manual_seed(i), 1.0, 1.0)
        np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert [g["lr"] for g in tstep.optimizer.param_groups] == [
        pytest.approx(float(JLP.lr_schedule(ARGS)(jnp.int32(3))))]

    def check(a, b, path):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=path)

    _walk(p, params_to_numpy(pm.param_tree()), check)


def test_lr_schedule_is_linear_then_flat():
    sched = TLP.lr_schedule(types.SimpleNamespace(
        lr=2e-4, scheduler_start_factor=1.0, scheduler_end_factor=0.1,
        scheduler_total_iters=10))
    assert sched(0) == pytest.approx(2e-4)
    assert sched(5) == pytest.approx(2e-4 * 0.55)
    assert sched(10) == sched(50) == pytest.approx(2e-5)


@pytest.mark.cuda
def test_train_step_kernel_route_vs_plain_route_on_card(cuda_device):
    """One step's gradients with the four training kernels (CUDA tensors)
    against the plain versions (the same model and batch on the CPU), bf16
    executor and encoders, dropout 0: every leaf within 5e-2 of its
    largest value (bf16 roundings at different sites)."""
    cfg = NMNConfig(**{**TW.workload_config(
        hidden_size=64, video_size=24, text_size=20,
        max_video_length=12).to_dict(), "compute_dtype": "bfloat16",
        "dropout": 0.0})
    batch = TW.add_fake_supervision(
        TW.make_batch(cfg, batch_size=6, question_len=8), cfg)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        model = TW.build_model(cfg, seed=0, device=dev)
        loss, _ = TLS.total_loss(
            model, TW.to_device(batch, dev), torch.Generator().manual_seed(0),
            1.0, 1.0, 1.0, 1.0, deterministic=False, contrastive_window=32)
        loss.backward()
        assert torch.isfinite(loss)
        grads.append(grads_to_numpy(model))

    def check(a, b, path):
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(b, a, rtol=0, atol=5e-2 * scale,
                                   err_msg=path)

    _walk(grads[1], grads[0], check)
