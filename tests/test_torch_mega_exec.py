"""Port parity: the executor (stair_tpu_torch/ops/mega_exec.py).

``mega_exec_reference`` runs through the port's ``VideoNMN.forward`` and is
held against the JAX forward with its default routing on the CPU (the XLA
scan, which tests/test_mega_exec.py holds equal to the TPU megakernel),
with the JAX weights carried over by ``params_from_numpy``: logits and the
three audited register files at rtol/atol 1e-4 (float32), over every
opcode (parity Filter), the softmax Filter, conv temporal (F = 48) and aux
embeddings. One case calls the JAX ``mega_exec(..., interpret=True)``
directly on the same prepared inputs. The CUDA kernel is held against the
plain version on the card.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.models.nmn import NMNConfig, tree_map
from stair_tpu_torch.ops import mega_exec as TX
from stair_tpu_torch.testing import workload as TW
from torch_port_util import (  # noqa: F401
    assert_close, cuda_device, port_model, torch_batch,
)

try:
    import jax.numpy as jnp

    from stair_tpu.ops import mega_exec as JX
    from test_mega_exec import FILTER_PROGRAMS, PROGRAMS, _batch, _build
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jnp = None
needs_jax = pytest.mark.skipif(jnp is None, reason="JAX not installed")

KEYS = ("logits", "regs_vec", "regs_frames", "regs_attn")


def _parity(cfg, params, model, batch):
    ref = model.forward(params, batch, deterministic=True)
    out = port_model(cfg, params)(torch_batch(batch))
    assert_close(ref, out, KEYS, rtol=1e-4, atol=1e-4)


@needs_jax
def test_executor_all_opcodes_parity():
    cfg, model, params = _build()
    batch, _ = _batch(cfg, PROGRAMS)
    _parity(cfg, params, model, batch)


@needs_jax
def test_executor_softmax_filter_parity():
    cfg, model, params = _build(filter_attention="softmax")
    batch, _ = _batch(cfg, FILTER_PROGRAMS)
    _parity(cfg, params, model, batch)


@needs_jax
def test_executor_conv_temporal_parity():
    cfg, model, params = _build(max_video_length=48)
    progs = [p for p in PROGRAMS if "Temporal" in p[0]] + PROGRAMS[:6]
    batch, _ = _batch(cfg, progs, seed=3)
    _parity(cfg, params, model, batch)


@needs_jax
def test_executor_aux_embedding_parity():
    cfg, model, params = _build()
    progs = [(["Query", "cup"], {}), (["Filter", "video", "cup"], {}),
             (["ToAction", "cup", "dish"], {})]
    batch, _ = _batch(cfg, progs, seed=4, aux=True)
    _parity(cfg, params, model, batch)


def _prepared_inputs(cfg, params, batch, seed=0):
    """Random encoder halves + the model's modules/tables for one batch."""
    rng = np.random.RandomState(seed)
    B, F = batch["video"].shape[:2]
    L = batch["question"].shape[1]
    Hh = cfg.hidden_size // 2
    halves = [rng.randn(B, n, Hh).astype(np.float32) for n in (F, F, L, L)]
    return halves


@needs_jax
def test_mega_exec_reference_vs_jax_megakernel_interpret():
    """The plain version against the JAX TPU kernel itself (Pallas
    interpreter) on identical prepared inputs."""
    progs = PROGRAMS[::3]
    cfg, model, params = _build()
    batch, _ = _batch(cfg, progs, seed=6)
    vf_a, vf_b, tok_a, tok_b = _prepared_inputs(cfg, params, batch)
    mods = params["modules"]
    rv, rf, ra = JX.mega_exec(
        cfg, mods, model._fused_tables(mods),
        {k: jnp.asarray(v) for k, v in batch["trace"].items()},
        (jnp.asarray(vf_a), jnp.asarray(vf_b)),
        jnp.asarray(batch["video_mask"]),
        (jnp.asarray(tok_a), jnp.asarray(tok_b)),
        jnp.asarray(batch["question_mask"]), interpret=True)
    pm = port_model(cfg, params)
    tmods = pm.param_tree()["modules"]
    out = TX.mega_exec(
        pm.config, tmods, pm._fused_tables(tmods),
        {k: torch.from_numpy(v) for k, v in batch["trace"].items()},
        (torch.from_numpy(vf_a), torch.from_numpy(vf_b)),
        torch.from_numpy(batch["video_mask"]),
        (torch.from_numpy(tok_a), torch.from_numpy(tok_b)),
        torch.from_numpy(batch["question_mask"]))
    for j, t in zip((rv, rf, ra), out):
        np.testing.assert_allclose(np.asarray(j), t.detach().numpy(),
                                   rtol=1e-4, atol=1e-4)


@needs_jax
def test_prepare_args_matches_jax():
    """Scalar pack (with the e1 expert code) and temporal bands agree."""
    for F in (16, 48):
        cfg, model, params = _build(max_video_length=F)
        batch, _ = _batch(cfg, PROGRAMS, seed=2)
        halves = _prepared_inputs(cfg, params, batch)
        mods = params["modules"]
        _, jargs = JX.prepare_args(
            cfg, mods, model._fused_tables(mods), batch["trace"],
            (jnp.asarray(halves[0]), jnp.asarray(halves[1])),
            jnp.asarray(batch["video_mask"]),
            (jnp.asarray(halves[2]), jnp.asarray(halves[3])),
            jnp.asarray(batch["question_mask"]))
        pm = port_model(cfg, params)
        tmods = pm.param_tree()["modules"]
        _, targs = TX.prepare_args(
            pm.config, tmods, pm._fused_tables(tmods),
            {k: torch.from_numpy(v) for k, v in batch["trace"].items()},
            tuple(torch.from_numpy(h) for h in halves[:2]),
            torch.from_numpy(batch["video_mask"]),
            tuple(torch.from_numpy(h) for h in halves[2:]),
            torch.from_numpy(batch["question_mask"]))
        assert len(jargs) == len(targs) == len(TX.ARG_NAMES)
        for name, j, t in zip(TX.ARG_NAMES, jargs, targs):
            np.testing.assert_allclose(
                np.asarray(j).reshape(t.shape), t.detach().numpy(), rtol=1e-6,
                atol=1e-6, err_msg=name)


def test_wrapper_routes_cpu_to_plain_and_rejects_other_devices():
    cfg = NMNConfig(hidden_size=16, video_size=8, text_size=6,
                    max_video_length=8, max_steps=16, num_vec=10,
                    num_frames=6, num_attn=8)
    model = TW.build_model(cfg, seed=0)
    batch = TW.to_device(TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS[:5]))
    B, L = batch["question"].shape[:2]
    halves = [torch.randn(B, n, 8) for n in (8, 8, L, L)]
    mods = model.param_tree()["modules"]
    meta, args = TX.prepare_args(
        cfg, mods, model._fused_tables(mods), batch["trace"], halves[:2],
        batch["video_mask"], halves[2:], batch["question_mask"])
    for a, b in zip(TX.mega_exec_call(meta, args),
                    TX.mega_exec_reference(meta, args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TX.mega_exec_call(meta, tuple(a.to("meta") for a in args))


@needs_jax
def test_opcode_program_set_is_the_reference_set():
    """The port's coverage set is tests/test_mega_exec.py's."""
    assert TW.OPCODE_PROGRAMS == PROGRAMS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,fsoft", [(16, False), (48, True), (100, False)])
def test_mega_exec_kernel_vs_plain_on_card(cuda_device, dtype, F, fsoft):
    """Kernel vs plain executor on the card over every opcode: float32 at
    rtol/atol 1e-4 (summation order), bf16 at atol 3e-2 plus rtol 1e-2
    (one bf16 rounding step is 2^-8 of the value). F = 100 leaves a ragged
    GEMM row tile."""
    cfg = NMNConfig(
        hidden_size=64, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8,
        filter_attention="softmax" if fsoft else "parity",
        compute_dtype="float32" if dtype == torch.float32 else "bfloat16")
    model = TW.build_model(cfg, seed=1, device=cuda_device)
    batch = TW.to_device(TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS, seed=8),
                         cuda_device)
    rng = np.random.RandomState(0)
    B, L = batch["question"].shape[:2]
    Hh = cfg.hidden_size // 2
    halves = [torch.from_numpy(rng.randn(B, n, Hh).astype(np.float32))
              .to(cuda_device, dtype) for n in (F, F, L, L)]
    mods = tree_map(lambda x: x.detach().to(dtype),
                    model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, model._fused_tables(mods), batch["trace"],
        (halves[0], halves[1]), batch["video_mask"],
        (halves[2], halves[3]), batch["question_mask"])
    out = TX.mega_exec_call(meta, args)
    torch.cuda.synchronize()
    ref = TX.mega_exec_reference(meta, args)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 3e-2)
    for name, a, b in zip(("rv", "rf", "ra"), out, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol[0],
                                   atol=tol[1], msg=name)
