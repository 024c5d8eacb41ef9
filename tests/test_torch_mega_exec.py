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

import collections

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
    import jax
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
def test_mega_exec_reference_vs_jax_megakernel_interpret_at_150_frames():
    """As above at the NMN CLIs' default F 150 (three row tiles of 64 on the
    "fma32" route, the last one ragged), softmax Filter, every program."""
    cfg, model, params = _build(max_video_length=150,
                                filter_attention="softmax")
    batch, _ = _batch(cfg, PROGRAMS, seed=7)
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
    assert out[1].shape[2] == 150
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


# The forward's route, chosen before any launch: the tensor-core kernel
# takes bf16, eval and training (drop) alike, at H a multiple of 64 in [64,
# 512] and any F in [16, 256] (the main paths' H 512, F 64 on one CTA an
# example; the NMN CLIs' default F 150, and every F above 64 or not a
# multiple of 16, in the row-slice mode); the "fma32" kernel takes float32
# at H a multiple of 128 in [128, 512] and any F in [16, 256] (the NMN
# CLIs' default F 150 too); every other width takes the general kernel.
FWD_ROUTE_CASES = [
    (torch.bfloat16, 512, 64, False, "tc"),
    (torch.bfloat16, 512, 64, True, "tc"),
    (torch.bfloat16, 192, 48, True, "tc"),
    (torch.float32, 512, 64, False, "fma32"),
    (torch.float32, 512, 64, True, "fma32"),
    (torch.float32, 128, 16, False, "fma32"),
    (torch.float32, 384, 48, True, "fma32"),
    (torch.float32, 96, 16, False, "general"),
    (torch.float32, 192, 64, True, "general"),
    (torch.float32, 64, 16, True, "general"),
    (torch.float32, 1024, 64, False, "general"),
    (torch.float32, 512, 8, False, "general"),
    (torch.float32, 512, 100, False, "fma32"),
    (torch.float32, 512, 150, False, "fma32"),
    (torch.float32, 512, 150, True, "fma32"),
    (torch.float32, 512, 256, False, "fma32"),
    (torch.float32, 512, 256, True, "fma32"),
    (torch.float32, 128, 17, True, "fma32"),
    (torch.float32, 512, 257, False, "general"),
    (torch.float32, 512, 257, True, "general"),
    (torch.float32, 512, 8, True, "general"),
    (torch.bfloat16, 512, 150, False, "tc"),
    (torch.bfloat16, 512, 150, True, "tc"),
    (torch.bfloat16, 64, 16, False, "tc"),
    (torch.bfloat16, 192, 48, False, "tc"),
    (torch.bfloat16, 32, 16, False, "general"),
    (torch.bfloat16, 96, 16, False, "general"),
    (torch.bfloat16, 1024, 64, False, "general"),
    (torch.bfloat16, 512, 8, False, "general"),
    (torch.bfloat16, 512, 100, False, "tc"),
    (torch.bfloat16, 512, 128, False, "tc"),
    (torch.bfloat16, 512, 72, False, "tc"),
    (torch.bfloat16, 512, 256, True, "tc"),
    (torch.bfloat16, 512, 257, False, "general"),
    (torch.bfloat16, 576, 150, True, "general"),
]


@pytest.mark.parametrize(
    "dtype,H,F,drop,route", FWD_ROUTE_CASES,
    ids=[f"{str(d)[6:]}-H{h}-F{f}{'-drop' if x else ''}"
         for d, h, f, x, _ in FWD_ROUTE_CASES])
def test_mega_exec_fwd_route_choice(dtype, H, F, drop, route):
    assert TX.fwd_route(dtype, H, F, drop) == route


@pytest.mark.parametrize("L", [16, 1024])
def test_mega_exec_tc_shared_memory_fits(L):
    """Every width the tensor-core route takes fits one block's 227 KB of
    shared memory (two bf16 frame tiles, the weight ring, the vectors), and
    the main path's shape needs what the source's plan says (~206 KB)."""
    for H in range(64, TX.TC_MAX_H + 1, 64):
        for F in range(16, TX.TC_MAX_F + 1, 16):
            assert TX.tc_smem_bytes(F, H, L) <= TX.SMEM_MAX, (F, H, L)
    if L == 16:
        assert TX.tc_smem_bytes(64, 512, 16) == 210464


def test_mega_exec_tc_train_shares_the_shared_memory_plan():
    """Both instantiations of the tensor-core kernel (eval, training) are
    launched by the one ``launch_tc<TRAIN>``, which sizes their shared
    memory with ``tc_smem_bytes`` (the function ``TX.tc_smem_bytes``
    mirrors and the card tests compare), and each C entry point takes one
    of them."""
    import os
    import re

    from stair_tpu_torch.ops import _build

    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "mega_exec.cu")) as f:
        src = f.read()
    launch = src[src.index("template <bool TRAIN>\nint launch_tc("):]
    launch = launch[:launch.index("\n}\n")]
    assert "const size_t smem = tc_smem_bytes(F, H, L);" in launch
    assert "mega_exec_tc_kernel<TRAIN><<<B, THREADS, smem, stream>>>" in launch
    entries = dict(re.findall(
        r'extern "C" int (stair_mega_exec_fwd_tc\w*)\(.*?launch_tc<(\w+)>',
        src, re.S))
    assert entries == {"stair_mega_exec_fwd_tc": "false",
                       "stair_mega_exec_fwd_tc_train": "true"}


def test_mega_exec_fma32_shared_memory_fits():
    """The "fma32" forward's block (``mega_exec_kernel<float, true>``: the
    general kernel's static vectors without gemm's tiles, and gemm32's ring
    in dynamic shared memory) fits 227 KB, and twice in an SM's 228 KB (1 KB
    reserved a block), as the general route runs two blocks an SM; the
    source's plan, the same at every width (its frame vectors hold MAX_F,
    the route's largest F, 256), reads 108,136 bytes."""
    assert TX.FMA32_MAX_F == TX.MAX_F == 256
    assert TX.fwd_route(torch.float32, TX.FMA32_MAX_H, TX.FMA32_MAX_F,
                        True) == "fma32"
    assert TX.fma32_smem_bytes() <= TX.SMEM_MAX
    assert 2 * (TX.fma32_smem_bytes() + 1024) <= 233472
    assert TX.fma32_smem_bytes() == 108136


def test_mega_exec_fma32_launch_shares_the_shared_memory_plan():
    """The "fma32" entry point launches ``mega_exec_kernel<float, true>``
    through ``launch<float, true>``, which sizes the dynamic shared memory
    with ``FMA32_RING_BYTES``; the library reports ``FMA32_SMEM_BYTES`` (the
    sum ``TX.fma32_smem_bytes`` mirrors and the card tests compare); eval
    and training share the one entry (``drop`` 0 or 1), as on the general
    route."""
    import os

    from stair_tpu_torch.ops import _build

    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "mega_exec.cu")) as f:
        src = f.read()
    launch = src[src.index("template <typename T, bool G32 = false>\n"
                           "int launch("):]
    launch = launch[:launch.index("\n}\n")]
    assert "const size_t smem = FMA32_RING_BYTES;" in launch
    # one launch, of an example's cluster (one CTA too), at that size
    assert ("launch_clusters(mega_exec_kernel<T, true>, B, a.C, smem, "
            "stream, a)") in launch
    entry = src[src.index('extern "C" int stair_mega_exec_fwd_fma32('):]
    assert "launch<float, true>(" in entry[:entry.index("\n}\n")]
    assert ("constexpr size_t FMA32_SMEM_BYTES = sizeof(SmemT<true>) + "
            "FMA32_RING_BYTES;") in src


@pytest.mark.cuda
@pytest.mark.parametrize("F,fsoft", [(16, False), (16, True), (64, False),
                                     (64, True), (72, False), (150, False),
                                     (150, True), (256, True)])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_mega_exec_fma32_equals_general_on_card(cuda_device, monkeypatch,
                                                F, fsoft, rate):
    """The float32 "fma32" forward (``mega_exec_kernel<float, true>``, its
    products on ``gemm32``) over every opcode, eval (rate 0, launch key
    ``mega_exec_fma32``) and training (``mega_exec_train_fma32``): its
    three files equal the general route's bit for bit (every relu side,
    dropout site and rounding is the general route's), and both are within
    1e-4 of the plain version. The library's shared memory is what
    ``fma32_smem_bytes`` says."""
    from stair_tpu_torch.ops import _build

    cfg = NMNConfig(
        hidden_size=128, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8,
        filter_attention="softmax" if fsoft else "parity")
    assert TX.fwd_route(torch.float32, 128, F, rate > 0) == "fma32"
    model = TW.build_model(cfg, seed=1, device=cuda_device)
    batch = TW.to_device(TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS * 2,
                                         seed=8), cuda_device)
    rng = np.random.RandomState(F)
    B, L = batch["question"].shape[:2]
    halves = [torch.from_numpy(rng.randn(B, n, 64).astype(np.float32))
              .to(cuda_device) for n in (F, F, L, L)]
    mods = tree_map(lambda x: x.detach(), model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, model._fused_tables(mods), batch["trace"], halves[:2],
        batch["video_mask"], halves[2:], batch["question_mask"])
    seed = (123, 456)

    def run():
        if rate:
            return TX.mega_exec_train_call(meta, args, rate, seed)
        return TX.mega_exec_call(meta, args)

    _build.reset_launches()
    out = run()
    torch.cuda.synchronize()
    key = "mega_exec_train_fma32" if rate else "mega_exec_fma32"
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 1}
    monkeypatch.setattr(TX, "fwd_route", lambda *a: "general")
    gen = run()
    torch.cuda.synchronize()
    ref = TX.mega_exec_reference(meta, args, rate, seed if rate else None)
    for name, a, g, r in zip(("rv", "rf", "ra"), out, gen, ref):
        assert torch.equal(a, g), name
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4, msg=name)
    assert (_build.build().stair_mega_exec_fma32_smem()
            == TX.fma32_smem_bytes())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tc", "general"])
@pytest.mark.parametrize("F,fsoft", [(16, False), (16, True), (48, False),
                                     (48, True)])
def test_mega_exec_train_bf16_routes_vs_plain_on_card(cuda_device,
                                                      monkeypatch, route, F,
                                                      fsoft):
    """Both bf16 training forwards (#5) against the plain version at
    dropout 0.25 over every opcode at H = 192 (ragged 128-column chunks and
    k splits in the tensor-core kernel), atol 3e-2 plus rtol 1e-2 (as the
    eval routes below); one launch of the route's key and none of the
    other's; the training instantiation's shared memory is what
    ``tc_smem_bytes`` says."""
    from stair_tpu_torch.ops import _build

    if route == "general":
        monkeypatch.setattr(TX, "fwd_route", lambda *a: "general")
    cfg = NMNConfig(
        hidden_size=192, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8,
        filter_attention="softmax" if fsoft else "parity",
        compute_dtype="bfloat16")
    model = TW.build_model(cfg, seed=1, device=cuda_device)
    batch = TW.to_device(TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS * 2, seed=8),
                         cuda_device)
    rng = np.random.RandomState(F)
    B, L = batch["question"].shape[:2]
    halves = [torch.from_numpy(rng.randn(B, n, 96).astype(np.float32))
              .to(cuda_device, torch.bfloat16) for n in (F, F, L, L)]
    mods = tree_map(lambda x: x.detach().to(torch.bfloat16),
                    model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, model._fused_tables(mods), batch["trace"],
        (halves[0], halves[1]), batch["video_mask"],
        (halves[2], halves[3]), batch["question_mask"])
    seed = (123, 456)
    _build.reset_launches()
    out = TX.mega_exec_train_call(meta, args, 0.25, seed)
    torch.cuda.synchronize()
    key, other = (("mega_exec_train_tc", "mega_exec_train") if route == "tc"
                  else ("mega_exec_train", "mega_exec_train_tc"))
    assert _build.LAUNCHES[key] == 1 and _build.LAUNCHES[other] == 0
    ref = TX.mega_exec_reference(meta, args, rate=0.25, seed=seed)
    for name, a, b in zip(("rv", "rf", "ra"), out, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                   atol=3e-2, msg=name)
    assert (_build.build().stair_mega_exec_tc_smem(F, 192, L)
            == TX.tc_smem_bytes(F, 192, L))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tc", "general"])
@pytest.mark.parametrize("F,fsoft", [(16, False), (16, True), (64, False),
                                     (64, True)])
def test_mega_exec_bf16_routes_vs_plain_on_card(cuda_device, monkeypatch,
                                                route, F, fsoft):
    """Both bf16 eval routes against the plain version over every opcode at
    H = 192 (ragged 128-column chunks and k splits in the tensor-core
    kernel), atol 3e-2 plus rtol 1e-2; one launch of the route's key and
    none of the other's; the kernel's shared memory is what
    ``tc_smem_bytes`` says."""
    from stair_tpu_torch.ops import _build

    if route == "general":
        monkeypatch.setattr(TX, "fwd_route", lambda *a: "general")
    cfg = NMNConfig(
        hidden_size=192, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8,
        filter_attention="softmax" if fsoft else "parity",
        compute_dtype="bfloat16")
    model = TW.build_model(cfg, seed=1, device=cuda_device)
    batch = TW.to_device(TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS * 2, seed=8),
                         cuda_device)
    rng = np.random.RandomState(F)
    B, L = batch["question"].shape[:2]
    halves = [torch.from_numpy(rng.randn(B, n, 96).astype(np.float32))
              .to(cuda_device, torch.bfloat16) for n in (F, F, L, L)]
    mods = tree_map(lambda x: x.detach().to(torch.bfloat16),
                    model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, model._fused_tables(mods), batch["trace"],
        (halves[0], halves[1]), batch["video_mask"],
        (halves[2], halves[3]), batch["question_mask"])
    _build.reset_launches()
    out = TX.mega_exec_call(meta, args)
    torch.cuda.synchronize()
    key, other = (("mega_exec_tc", "mega_exec") if route == "tc"
                  else ("mega_exec", "mega_exec_tc"))
    assert _build.LAUNCHES[key] == 1 and _build.LAUNCHES[other] == 0
    ref = TX.mega_exec_reference(meta, args)
    for name, a, b in zip(("rv", "rf", "ra"), out, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                   atol=3e-2, msg=name)
    assert (_build.build().stair_mega_exec_tc_smem(F, 192, L)
            == TX.tc_smem_bytes(F, 192, L))


def _cluster_rule():
    """``mega32_cluster`` of ``csrc/mega_common.cuh`` as a Python function
    of (B, H, slots, fit_2, fit_h), its one return expression translated
    (C's ``a ? b : c`` and ``&&``), ``G32_BN`` read from the source."""
    import os
    import re

    from stair_tpu_torch.ops import _build

    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "mega_common.cuh")) as f:
        src = f.read()
    head = ("__host__ __device__ inline int mega32_cluster(int B, int H, "
            "int slots,\n")
    body = src[src.index(head):]
    body = body[body.index("{") + 1:body.index("}")]
    expr = " ".join(body.split())
    assert expr.startswith("return ") and expr.endswith(";"), expr
    expr = expr[len("return "):-1].replace("&&", "and")
    want = ("fit_h > 0 and B * (H / G32_BN) <= slots ? H / G32_BN : "
            "(fit_2 > 0 and 2 * B <= slots ? 2 : 1)")
    assert expr == want, expr
    py = ("(H // G32_BN) if (fit_h > 0 and B * (H // G32_BN) <= slots) "
          "else ((2) if (fit_2 > 0 and 2 * B <= slots) else (1))")
    g32 = TX._TILES["G32_BN"]
    return lambda B, H, slots, fit_2, fit_h: eval(
        py, {}, dict(B=B, H=H, slots=slots, fit_2=fit_2, fit_h=fit_h,
                     G32_BN=g32))


def test_mega_exec_fma32_cluster_rule_matches_the_source():
    """``fma32_cluster`` equals the CUDA source's ``mega32_cluster`` at
    every width the "fma32" route takes (H 128, 256, 384, 512) and every
    batch up to 300, on an H100's 132 CTA slots (one CTA an SM: the
    kernels hold 254-255 registers a thread) with the clusters that fit it
    (66 of 2, 30 of 4, 44 of 3 by cudaOccupancyMaxActiveClusters), on a
    card of half the slots, and where a size fits nowhere (0). The
    NMN CLIs' B 32 at H 512 takes clusters of 4, B 64 of 2, B 128 one CTA
    an example."""
    rule = _cluster_rule()
    g32 = TX._TILES["G32_BN"]
    n = 0
    for H in range(g32, TX.FMA32_MAX_H + 1, g32):
        assert TX.fma32_shape(H, 150)
        most = H // g32
        for slots, fits in ((132, {2: 66, 3: 44, 4: 30}),
                            (66, {2: 33, 3: 22, 4: 15}),
                            (132, {2: 0, 3: 0, 4: 0})):
            fit_h = fits[most] if most > 1 else 0
            fit_2 = fits[2] if most > 2 and most % 2 == 0 else 0
            for B in range(1, 301):
                got = TX.fma32_cluster(B, H, slots, fit_2, fit_h)
                assert got == rule(B, H, slots, fit_2, fit_h), (B, H, slots)
                assert most % got == 0 and (got == 1 or B * got <= slots)
                n += 1
    assert n == 4 * 3 * 300
    picks = {B: TX.fma32_cluster(B, 512, 132, 66, 30)
             for B in (1, 29, 32, 33, 34, 64, 66, 67, 128)}
    assert picks == {1: 4, 29: 4, 32: 4, 33: 4, 34: 2, 64: 2, 66: 2, 67: 1,
                     128: 1}


def test_mega_exec_cluster_argument_leaves_the_cpu_route_alone():
    """On CPU tensors ``cluster`` changes nothing: the plain version runs
    (no launch), eval and training alike, and the route choice of a float32
    batch at the NMN CLIs' widths is still "fma32" for the card."""
    from stair_tpu_torch.ops import _build
    from torch_port_util import fma32_case

    meta, args = fma32_case(torch.device("cpu"), 128, 24, "parity", 3)
    _build.reset_launches()
    for c in (None, 1):
        want = TX.mega_exec_reference(meta, args)
        got = TX.mega_exec_call(meta, args, cluster=c)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
        want = TX.mega_exec_reference(meta, args, rate=0.25, seed=(1, 2))
        got = TX.mega_exec_train_call(meta, args, 0.25, (1, 2), cluster=c)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert not any(_build.LAUNCHES.values())
    assert not any(_build.CLUSTERS.values())
    assert TX.fwd_route(torch.float32, 512, 150, True) == "fma32"


#: the cluster card tests' widths (H, F); each at every batch of
#: CLUSTER_BATCHES (below, at and above the CLIs' B 32)
CLUSTER_WIDTHS = [(256, 72), (512, 72), (256, 150), (512, 150), (256, 256),
                  (512, 256)]
CLUSTER_BATCHES = (1, 29, 32, 33, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("H,F", CLUSTER_WIDTHS,
                         ids=[f"H{h}-F{f}" for h, f in CLUSTER_WIDTHS])
def test_mega_exec_fma32_clusters_equal_one_cta_on_card(cuda_device,
                                                        monkeypatch, H, F):
    """#4 and #5 (rate 0.25) on the "fma32" route at every cluster size
    the width takes (1, 2, H / 128) and every batch of CLUSTER_BATCHES,
    over the all-opcode programs: every size's three files equal one CTA
    an example's and the general route's bit for bit. The launch's own
    pick is the one the library reports (``fma32_launch_cluster``), which
    is ``fma32_cluster`` over the card's slots and fits, and is counted
    under it in ``_build.CLUSTERS``."""
    from stair_tpu_torch.ops import _build
    from torch_port_util import fma32_case

    most = H // TX._TILES["G32_BN"]
    sizes = sorted({1, 2, most})
    fits = {c: TX.fma32_fit(c) for c in sizes}
    seed = (123, 456)
    for B in CLUSTER_BATCHES:
        meta, args = fma32_case(cuda_device, H, F, "softmax", B)
        pick = TX.fma32_launch_cluster(B, H)
        assert pick == TX.fma32_cluster(
            B, H, fits[1], fits[2] if most > 2 else 0,
            fits[most] if most > 1 else 0), B
        _build.reset_launches()
        out4 = TX.mega_exec_call(meta, args)
        out5 = TX.mega_exec_train_call(meta, args, 0.25, seed)
        assert _build.CLUSTERS["mega_exec_fma32"] == {pick: 1}
        assert _build.CLUSTERS["mega_exec_train_fma32"] == {pick: 1}
        for c in sizes:
            k4 = TX.mega_exec_call(meta, args, cluster=c)
            k5 = TX.mega_exec_train_call(meta, args, 0.25, seed, cluster=c)
            for name, a, b in zip(("rv", "rf", "ra") * 2, out4 + out5,
                                  k4 + k5):
                assert torch.equal(a, b), (B, c, name)
        with monkeypatch.context() as m:
            m.setattr(TX, "fwd_route", lambda *a: "general")
            g4 = TX.mega_exec_call(meta, args)
            g5 = TX.mega_exec_train_call(meta, args, 0.25, seed)
        torch.cuda.synchronize()
        for name, a, b in zip(("rv", "rf", "ra") * 2, out4 + out5, g4 + g5):
            assert torch.equal(a, b), (B, "general", name)


@needs_jax
@pytest.mark.parametrize("F,attention", [(150, "softmax"), (72, "parity")])
def test_mega_exec_bf16_reference_vs_jax_megakernel_interpret(F, attention):
    """bf16 at the NMN CLIs' default F 150 and at F 72 (the row-slice
    mode's widths on the card: 150 = 64 + 64 + 22 rows, 72 = 48 + 24): the
    plain version against the JAX TPU kernel itself (Pallas interpreter) on
    identical prepared inputs in bf16, H 64, every program. Both round at
    the JAX kernel's bf16 sites and sum in float32 in different orders, so
    the files agree within atol 3e-2 plus rtol 1e-2, the executor's bf16
    bound (one bf16 rounding step is 2^-8 of the value)."""
    cfg, model, params = _build(max_video_length=F, hidden=64,
                                filter_attention=attention)
    batch, _ = _batch(cfg, PROGRAMS, seed=7)
    halves = _prepared_inputs(cfg, params, batch)
    bf = jnp.bfloat16
    mods = jax.tree_util.tree_map(lambda x: x.astype(bf), params["modules"])
    rv, rf, ra = JX.mega_exec(
        cfg, mods, model._fused_tables(mods),
        {k: jnp.asarray(v) for k, v in batch["trace"].items()},
        (jnp.asarray(halves[0], bf), jnp.asarray(halves[1], bf)),
        jnp.asarray(batch["video_mask"]),
        (jnp.asarray(halves[2], bf), jnp.asarray(halves[3], bf)),
        jnp.asarray(batch["question_mask"]), interpret=True)
    pm = port_model(cfg, params)
    tmods = tree_map(lambda x: x.detach().to(torch.bfloat16),
                     pm.param_tree()["modules"])
    th = [torch.from_numpy(h).to(torch.bfloat16) for h in halves]
    out = TX.mega_exec(
        pm.config, tmods, pm._fused_tables(tmods),
        {k: torch.from_numpy(v) for k, v in batch["trace"].items()},
        (th[0], th[1]), torch.from_numpy(batch["video_mask"]),
        (th[2], th[3]), torch.from_numpy(batch["question_mask"]))
    assert out[1].dtype == torch.bfloat16 and out[1].shape[2] == F
    assert TX.fwd_route(torch.bfloat16, 512, F, False) == "tc"
    for name, j, t in zip(("rv", "rf", "ra"), (rv, rf, ra), out):
        np.testing.assert_allclose(np.asarray(j, np.float32),
                                   t.float().numpy(), rtol=1e-2, atol=3e-2,
                                   err_msg=name)


def _c_return_expr(src, head):
    """The one ``return`` expression of the C function that starts with
    ``head``, whitespace collapsed."""
    body = src[src.index(head):]
    body = body[body.index("{") + 1:body.index("}")]
    expr = " ".join(body.split())
    assert expr.startswith("return ") and expr.endswith(";"), expr
    return expr[len("return "):-1]


def test_mega_exec_tc_cluster_rule_matches_the_source():
    """The tensor-core route's row-slice rule in ``csrc/mega_common.cuh``
    (``tc_slice_count``, ``tc_cluster``, ``tc_cta_rows``, ``tc_slice_rows``:
    one return expression each, C's integer arithmetic on positive ints)
    equals the Python mirrors at every F the route takes, every batch up to
    300 on an H100's 132 CTA slots (one CTA an SM) and on half of them,
    and every cluster size from 1 to 8. At each pick every CTA owns at most
    its share of whole 16-row mma tiles, the CTAs' rows cover the F frames
    once and a CTA's slice fits the staging tile; the NMN CLIs' F 150 takes
    3 CTAs of 64, 64 and 22 rows at B 32, 2 at B 64 and one CTA at B 128;
    the widths the shared tiles hold take one CTA. The forward's and the
    walk's launches pick with ``tc_cluster`` over the card's slots, the
    walk at the forward's widths alike."""
    import os
    import re

    from stair_tpu_torch.ops import _build

    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    with open(os.path.join(csrc, "mega_common.cuh")) as f:
        src = f.read()
    count = _c_return_expr(src, "constexpr int tc_slice_count(int F) {")
    cluster = _c_return_expr(
        src, "constexpr int tc_cluster(int B, int F, int slots) {")
    rows = _c_return_expr(src, "constexpr int tc_cta_rows(int F, int C) {")
    stage = _c_return_expr(src, "constexpr int tc_slice_rows(int F) {")
    assert count == "(F + TC_MAX_F - 1) / TC_MAX_F", count
    assert cluster == ("B * tc_slice_count(F) <= slots ? tc_slice_count(F) "
                       ": (tc_slice_count(F) > 2 && 2 * B <= slots ? 2 : 1)"
                       ), cluster
    assert rows == "((F + C - 1) / C + 15) & ~15", rows
    assert stage == "F < TC_MAX_F ? (F + 15) & ~15 : TC_MAX_F", stage

    def ternary(expr):   # C's a ? b : c (the outer one) in Python
        cond, rest = expr.split(" ? ", 1)
        then, other = rest.split(" : ", 1)
        return f"({then}) if ({cond}) else ({other})"

    py_cluster = ternary(cluster).replace("&&", "and")
    py_cluster = re.sub(r"\((tc_slice_count\(F\) > 2 and 2 \* B <= "
                        r"slots) \? 2 : 1\)", r"(2 if \1 else 1)",
                        py_cluster)
    env = {"TC_MAX_F": TX.TC_MAX_F,
           "tc_slice_count": lambda F: eval(count.replace("/", "//"), {},
                                            {"F": F, "TC_MAX_F": TX.TC_MAX_F})}
    for F in range(TX.TC_MIN_F, TX.TC_ROUTE_MAX_F + 1):
        assert TX.tc_slice_count(F) == env["tc_slice_count"](F), F
        assert TX.tc_slice_rows(F) == eval(ternary(stage), {},
                                           dict(env, F=F)), F
        for C in range(1, 9):
            assert TX.tc_cta_rows(F, C) == eval(
                rows.replace("/", "//"), {}, dict(env, F=F, C=C)), (F, C)
        for slots in (132, 66):
            for B in range(1, 301):
                C = TX.tc_cluster(B, F, slots)
                assert C == eval(py_cluster, {}, dict(env, F=F, B=B,
                                                      slots=slots)), (F, B)
                assert C == 1 or B * C <= slots
                R = TX.tc_cta_rows(F, C)
                spans = [(r * R, min(F, (r + 1) * R)) for r in range(C)]
                assert spans[0][0] == 0 and spans[-1][1] == F, (F, B, C)
                assert all(a % 16 == 0 and b > a for a, b in spans), (F, C)
                assert all(spans[i][1] == spans[i + 1][0]
                           for i in range(C - 1))
                if C == TX.tc_slice_count(F):
                    assert max(b - a for a, b in spans) <= TX.TC_MAX_F
    picks = {B: TX.tc_cluster(B, 150, 132) for B in (1, 32, 44, 45, 64, 66,
                                                      67, 128)}
    assert picks == {1: 3, 32: 3, 44: 3, 45: 2, 64: 2, 66: 2, 67: 1, 128: 1}
    assert [min(150, r * 64 + 64) - r * 64 for r in range(3)] == [64, 64, 22]
    assert TX.tc_cta_rows(150, 3) == 64 and TX.tc_cta_rows(72, 2) == 48
    assert TX.tc_cta_rows(150, 2) == 80 and TX.tc_cta_rows(150, 1) == 160
    assert TX.tc_cluster(32, 256, 132) == 4 and TX.tc_cluster(32, 72, 132) == 2
    assert TX.tc_sliced(64, cluster=2) and not TX.tc_sliced(64, cluster=1)
    assert TX.tc_sliced(24) and not TX.tc_sliced(64) and not TX.tc_sliced(48)
    with open(os.path.join(csrc, "mega_exec.cu")) as f:
        fwd = f.read()
    with open(os.path.join(csrc, "mega_grad_tc.cu")) as f:
        walk = f.read()
    assert ("if (cluster > 1 || F % 16 || F > stair::TC_MAX_F) {\n"
            "    const cudaError_t e = tc_sliced_pick<TRAIN>(B, F, H, L, "
            "cluster, &a.C);") in fwd
    for src in (fwd, walk):
        assert src.count("*C = tc_cluster(B, F, slots);") == 1
    assert ("if (e != cudaSuccess || cluster > 0 || !(F % 16 || F > "
            "stair::TC_MAX_F))") in walk


@pytest.mark.parametrize("L", [16, 1024])
def test_mega_exec_tc_sliced_shared_memory_fits(L):
    """The row-slice mode's CTA (one staging tile of ``tc_slice_rows(F)``
    rows, the weight ring, the vectors; the two ``[F, H + 8]`` tiles live in
    the workspace) fits 227 KB at every width the route takes, every F from
    16 to 256; at F 150, H 512 it holds 145,968 bytes where two on-chip
    tiles would need 391,408. The source's formula is the mirror's, and the
    launch sizes the row-slice kernel with it."""
    import os

    from stair_tpu_torch.ops import _build

    for H in range(64, TX.TC_MAX_H + 1, 64):
        for F in range(TX.TC_MIN_F, TX.TC_ROUTE_MAX_F + 1):
            assert TX.tc_route_shape(H, F)
            assert TX.tc_sliced_smem_bytes(F, H, L) <= TX.SMEM_MAX, (F, H)
            if not TX.tc_sliced(F):
                assert TX.tc_shape(H, F)
                assert TX.tc_smem_bytes(F, H, L) <= TX.SMEM_MAX, (F, H)
    if L == 16:
        assert TX.tc_sliced_smem_bytes(150, 512, 16) == 145968
        assert TX.tc_smem_bytes(150, 512, 16) == 391408
    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "mega_exec.cu")) as f:
        src = f.read()
    body = src[src.index("inline size_t tc_sliced_smem_bytes(int F, int H, "
                         "int L) {"):]
    body = " ".join(body[:body.index("\n}\n")].split())
    assert ("return tc_smem_bytes(F, H, L) - (2 * (size_t)F - "
            "tc_slice_rows(F)) * (H + TC_PAD) * sizeof(bf16);") in body
    launch = src[src.index("int launch_tc_sliced("):]
    launch = launch[:launch.index("\n}\n")]
    assert "const size_t smem = tc_sliced_smem_bytes(a.F, a.H, a.L);" in launch
    assert "launch_clusters(kernel, a.B, a.C, smem, stream, a)" in launch


def test_mega_exec_tc_cluster_argument_leaves_the_cpu_route_alone():
    """On CPU tensors ``cluster`` changes nothing on bf16 inputs at the
    row-slice widths (F 72 and 150): the plain version runs, eval and
    training alike, and nothing is launched or counted."""
    from stair_tpu_torch.ops import _build
    from torch_port_util import tc_case

    _build.reset_launches()
    for F in (72, 150):
        meta, args = tc_case(torch.device("cpu"), 64, F, "softmax", 3)
        assert TX.fwd_route(torch.bfloat16, 64, F, True) == "tc"
        for c in (None, 1, 2, 3):
            want = TX.mega_exec_reference(meta, args)
            got = TX.mega_exec_call(meta, args, cluster=c)
            assert all(torch.equal(a, b) for a, b in zip(want, got))
            want = TX.mega_exec_reference(meta, args, rate=0.25, seed=(1, 2))
            got = TX.mega_exec_train_call(meta, args, 0.25, (1, 2),
                                          cluster=c)
            assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert not any(_build.LAUNCHES.values())
    assert not any(_build.CLUSTERS.values())


#: bf16 widths of the row-slice mode's card checks (H, F): ragged slices
#: (72 = 48 + 24, 100 = 64 + 36), the NMN CLIs' F 150 and the largest F
TC_SLICED_WIDTHS = [(192, 72), (192, 100), (192, 150), (128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("fsoft", [False, True])
@pytest.mark.parametrize("H,F", TC_SLICED_WIDTHS,
                         ids=[f"H{h}-F{f}" for h, f in TC_SLICED_WIDTHS])
def test_mega_exec_tc_sliced_vs_plain_on_card(cuda_device, H, F, fsoft):
    """#4 and #5 (rate 0.25) on the tensor-core route's row-slice mode
    against the plain version over every opcode (the all-opcode programs
    twice), atol 3e-2 plus rtol 1e-2 (as the bf16 checks above), argmax of
    the vec file's rows equal on at least 98%; one launch of each key,
    counted under the launch's cluster (``tc_launch_cluster``, which is
    ``tc_cluster`` over the card's slots), none on the
    general route; the CTA's shared memory is what
    ``tc_sliced_smem_bytes`` says."""
    from stair_tpu_torch.ops import _build
    from torch_port_util import tc_case

    att = "softmax" if fsoft else "parity"
    meta, args = tc_case(cuda_device, H, F, att, 2 * len(TW.OPCODE_PROGRAMS))
    B, L = meta[0], meta[8]
    C = TX.tc_launch_cluster(B, F, H, L)
    assert C == TX.tc_cluster(B, F, TX.tc_slots(F, H, L))
    _build.reset_launches()
    out4 = TX.mega_exec_call(meta, args)
    out5 = TX.mega_exec_train_call(meta, args, 0.25, (123, 456))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mega_exec_tc"] == 1
    assert _build.LAUNCHES["mega_exec_train_tc"] == 1
    assert not _build.LAUNCHES["mega_exec"]
    assert not _build.LAUNCHES["mega_exec_train"]
    assert _build.CLUSTERS["mega_exec_tc"] == {C: 1}
    assert _build.CLUSTERS["mega_exec_train_tc"] == {C: 1}
    ref4 = TX.mega_exec_reference(meta, args)
    ref5 = TX.mega_exec_reference(meta, args, rate=0.25, seed=(123, 456))
    for name, a, b in zip(("rv", "rf", "ra") * 2, out4 + out5, ref4 + ref5):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                   atol=3e-2, msg=name)
        if name == "rv":
            agree = (a.float().argmax(-1) == b.float().argmax(-1)).float()
            assert float(agree.mean()) >= 0.98
    L = meta[8]
    assert (_build.build().stair_mega_exec_tc_sliced_smem(F, H, L)
            == TX.tc_sliced_smem_bytes(F, H, L))


#: (H, F, cluster sizes) of the row-slice mode's bit checks: a cluster
#: forced at widths the shared tiles hold (F 64, 48) against one CTA with
#: both tiles on chip, and every size at F 72, 150 and 256
TC_CLUSTER_CASES = [(64, 64, (2, 3, 4)), (192, 48, (2, 3)),
                    (512, 64, (2,)), (192, 72, (1, 2, 3)),
                    (512, 150, (1, 2, 3, 4)), (128, 256, (1, 2, 4, 8))]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "H,F,sizes", TC_CLUSTER_CASES,
    ids=[f"H{h}-F{f}" for h, f, _ in TC_CLUSTER_CASES])
def test_mega_exec_tc_clusters_equal_one_cta_on_card(cuda_device, H, F,
                                                     sizes):
    """#4 and #5 (rate 0.25) on the tensor-core route at every cluster size
    of ``sizes`` (2 or more, or 1 above 64 frames: the row-slice mode, the
    frame rows split over the cluster's CTAs) over the all-opcode programs
    at B 1 and 33: every file equals the launch's own pick's bit for bit,
    and at F 64 / 48 the pick is one CTA with both tiles in shared memory,
    so the row-slice mode's products, staged from the workspace, give the
    on-chip tiles' bits."""
    from stair_tpu_torch.ops import _build
    from torch_port_util import tc_case

    seed = (123, 456)
    for B in (1, 33):
        meta, args = tc_case(cuda_device, H, F, "softmax", B)
        _build.reset_launches()
        out4 = TX.mega_exec_call(meta, args)
        out5 = TX.mega_exec_train_call(meta, args, 0.25, seed)
        pick = TX.tc_launch_cluster(B, F, H, meta[8])
        assert _build.CLUSTERS["mega_exec_tc"] == {pick: 1}
        for c in sizes:
            k4 = TX.mega_exec_call(meta, args, cluster=c)
            k5 = TX.mega_exec_train_call(meta, args, 0.25, seed, cluster=c)
            for name, a, b in zip(("rv", "rf", "ra") * 2, out4 + out5,
                                  k4 + k5):
                assert torch.equal(a, b), (B, c, name)
        want = collections.Counter((pick,) + tuple(sizes))
        assert _build.CLUSTERS["mega_exec_tc"] == want, B
        assert _build.CLUSTERS["mega_exec_train_tc"] == want, B
        torch.cuda.synchronize()
