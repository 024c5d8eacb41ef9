"""Port parity: the scan executor (``VideoNMN(executor="step")``).

The port's ``"step"`` forward on CPU tensors (the plain version of the
fused step kernel for the parity Filter, the expert-grouped torch stages
for the softmax Filter) against the JAX forward with ``STAIR_MEGA_EXEC=0``
and ``STAIR_FUSED_EXEC=0`` (the XLA scan, which is what JAX runs on the CPU
anyway), from the same weights and numpy batches: logits and the three
register files at rtol/atol 1e-4 in float32, over every opcode, both
Filter modes, linear and conv temporal, with and without aux embeddings.
Two cases run the JAX side through its fused step kernel under the Pallas
interpreter (``STAIR_FUSED_EXEC=interpret``), at F 16 and at a ragged F
72. The port's ``"step"`` and ``"mega"`` routes are held against each
other, in eval and (the grouped stages through autograd) in one training
step's gradients at dropout 0.
The schedule of all ``T`` steps reaches the host in one transfer. On the
card, the kernel route against the plain route.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.models import nmn as TN
from stair_tpu_torch.ops import executor_step as TE
from stair_tpu_torch.testing import workload as TW
from torch_port_util import (  # noqa: F401
    assert_close, cuda_device, port_model, torch_batch,
)

try:
    import jax

    from test_mega_exec import FILTER_PROGRAMS, PROGRAMS, _batch, _build
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

KEYS = ("logits", "regs_vec", "regs_frames", "regs_attn")


@pytest.fixture
def xla_scan(monkeypatch):
    monkeypatch.setenv("STAIR_MEGA_EXEC", "0")
    monkeypatch.setenv("STAIR_FUSED_EXEC", "0")


def _parity(cfg, params, model, batch):
    ref = model.forward(params, batch, deterministic=True)
    out = port_model(cfg, params, executor="step")(torch_batch(batch))
    assert_close(ref, out, KEYS, rtol=1e-4, atol=1e-4)
    # the scratch frames slot is all zero after the run
    assert float(out["regs_frames"][:, cfg.num_frames].abs().max()) == 0.0
    return out


@needs_jax
@pytest.mark.parametrize("attention", ["parity", "softmax"])
def test_step_forward_all_opcodes_matches_jax_scan(xla_scan, attention):
    cfg, model, params = _build(filter_attention=attention)
    batch, _ = _batch(cfg, PROGRAMS)
    _parity(cfg, params, model, batch)


@needs_jax
@pytest.mark.parametrize("attention", ["parity", "softmax"])
def test_step_forward_conv_temporal_matches_jax_scan(xla_scan, attention):
    cfg, model, params = _build(max_video_length=48,
                                filter_attention=attention)
    progs = [p for p in PROGRAMS if "Temporal" in p[0]] + PROGRAMS[:6] + (
        FILTER_PROGRAMS[:4])
    batch, _ = _batch(cfg, progs, seed=3)
    _parity(cfg, params, model, batch)


@needs_jax
@pytest.mark.parametrize("attention", ["parity", "softmax"])
def test_step_forward_aux_embeddings_matches_jax_scan(xla_scan, attention):
    cfg, model, params = _build(filter_attention=attention)
    progs = [(["Query", "cup"], {}), (["Filter", "video", "cup"], {}),
             (["ToAction", "cup", "dish"], {})]
    batch, _ = _batch(cfg, progs, seed=4, aux=True)
    _parity(cfg, params, model, batch)


@needs_jax
def test_step_forward_matches_jax_fused_kernel_interpret(monkeypatch):
    """The JAX side through ``_step_kernel`` itself (Pallas interpreter)."""
    monkeypatch.setenv("STAIR_MEGA_EXEC", "0")
    monkeypatch.setenv("STAIR_FUSED_EXEC", "interpret")
    cfg, model, params = _build()
    batch, _ = _batch(cfg, PROGRAMS[7::4], seed=5)
    _parity(cfg, params, model, batch)


@needs_jax
def test_step_forward_above_64_frames_matches_jax_fused_kernel_interpret(
        monkeypatch):
    """The same at a ragged F above 64 (72): the widths at which the port's
    step kernel now runs its redesigned routes (the tensor-core route's
    row-slice mode in bf16, ``"fma32"`` over ``gemm32``'s row tiles in
    float32) and JAX's kernel holds a whole ``[F, H]`` example."""
    monkeypatch.setenv("STAIR_MEGA_EXEC", "0")
    monkeypatch.setenv("STAIR_FUSED_EXEC", "interpret")
    cfg, model, params = _build(max_video_length=72)
    batch, _ = _batch(cfg, PROGRAMS[7::4], seed=6)
    _parity(cfg, params, model, batch)


def _port(attention="parity", F=16, dropout=0.0, dtype="float32", **kw):
    cfg = TN.NMNConfig(
        hidden_size=32, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8, dropout=dropout,
        filter_attention=attention, compute_dtype=dtype)
    batch = TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS, **kw)
    return cfg, batch


@pytest.mark.parametrize("attention,F,aux", [
    ("parity", 16, False), ("softmax", 16, True), ("parity", 40, True),
    ("softmax", 40, False)])
def test_step_route_matches_mega_route(attention, F, aux):
    cfg, batch = _port(attention, F, seed=2, aux=aux)
    batch = TW.to_device(batch)
    model = TW.build_model(cfg, seed=1)
    ref = model(batch)
    model.executor = "step"
    out = model(batch)
    for k in KEYS:
        torch.testing.assert_close(out[k], ref[k], rtol=1e-4, atol=1e-5,
                                   msg=k)


def test_step_route_runs_the_fused_step_once_per_step(monkeypatch):
    """Eval with the parity Filter goes through ``fused_step`` ``T`` times;
    the softmax Filter and training never do."""
    calls = []
    real = TE.fused_step
    monkeypatch.setattr(TE, "fused_step",
                        lambda *a: calls.append(1) or real(*a))
    cfg, batch = _port(seed=3)
    T = batch["trace"]["opcode"].shape[1]
    batch = TW.to_device(batch)
    model = TN.VideoNMN(cfg, executor="step")
    model(batch)
    assert len(calls) == T
    model(batch, generator=torch.Generator().manual_seed(0),
          deterministic=False)
    assert len(calls) == T
    cfg, _ = _port("softmax")
    TN.VideoNMN(cfg, executor="step")(batch)
    assert len(calls) == T


def test_schedule_reaches_the_host_in_one_transfer(monkeypatch):
    cfg, batch = _port(seed=3)
    trace = TW.to_device(batch)["trace"]
    transfers = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: transfers.append(1)
                        or real(self, *a, **k))
    for seed in (None, (1, 2)):
        transfers.clear()
        scan = TN._Scan(cfg, trace, seed, torch.float32)
        assert len(transfers) == 1
        T = trace["opcode"].shape[1]
        assert len(scan.sizes1) == T and all(
            sum(s) == len(TW.OPCODE_PROGRAMS) for s in scan.sizes1)


def test_unknown_executor_is_refused():
    cfg, _ = _port()
    with pytest.raises(ValueError, match="executor"):
        TN.VideoNMN(cfg, executor="scan")


@pytest.mark.parametrize("attention", ["parity", "softmax"])
def test_step_training_gradients_match_mega_route(attention):
    """The grouped torch stages under autograd against the training
    megakernel's plain version, at dropout 0: the loss and every gradient
    leaf within 1e-4 of the leaf's scale."""
    from stair_tpu_torch.train.losses import total_loss

    cfg, batch = _port(attention, seed=4)
    batch["answer"] = np.random.RandomState(3).randint(
        0, cfg.answer_vocab_length, (len(TW.OPCODE_PROGRAMS),)
    ).astype(np.int32)
    batch = TW.to_device(TW.add_fake_supervision(batch, cfg))
    got = {}
    for executor in ("mega", "step"):
        model = TN.VideoNMN(cfg, generator=torch.Generator().manual_seed(2),
                            executor=executor)
        loss, _ = total_loss(model, batch, torch.Generator().manual_seed(0),
                             1.0, 1.0, 1.0, 1.0, contrastive_window=8)
        loss.backward()
        got[executor] = (float(loss.detach()), {
            k: p.grad for k, p in model.weights.items()})
    assert got["step"][0] == pytest.approx(got["mega"][0], rel=1e-5)
    for k, g in got["mega"][1].items():
        s = got["step"][1][k]
        if g is None or s is None:
            # a leaf neither route reaches (a head without supervision)
            assert g is None and s is None or float(
                (g if s is None else s).abs().max()) == 0.0, k
            continue
        scale = max(float(g.abs().max()), 1e-6)
        assert float((s - g).abs().max()) <= 1e-4 * scale + 1e-6, k


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["parity", "softmax"])
def test_step_forward_kernel_route_vs_plain_route_on_card(
        cuda_device, attention, compute_dtype):
    """The ``"step"`` forward on CUDA tensors (the BiLSTM and fused step
    kernels) and on CPU tensors (their plain versions): float32 at 1e-4,
    bf16 answers agree on >= 0.9 of the programs."""
    from stair_tpu_torch.ops import _build

    cfg, batch = _port(attention, F=48, dtype=compute_dtype, seed=6)
    model = TN.VideoNMN(cfg, generator=torch.Generator().manual_seed(2),
                        executor="step")
    ref = model(TW.to_device(batch))
    _build.reset_launches()
    out = model.to(cuda_device)(TW.to_device(batch, cuda_device))
    torch.cuda.synchronize()
    T = batch["trace"]["opcode"].shape[1]
    assert _build.LAUNCHES["executor_step"] == (
        T if attention == "parity" else 0)
    assert _build.LAUNCHES["mega_exec"] == 0
    if compute_dtype == "float32":
        assert_close({k: v.numpy() for k, v in ref.items()}, out, KEYS,
                     rtol=1e-4, atol=1e-4)
    else:
        agree = (ref["logits"].argmax(-1)
                 == out["logits"].cpu().argmax(-1)).float().mean().item()
        assert agree >= 0.9


def test_choose_flips_finds_the_example_that_kept_the_other_keyword():
    # the two routes' files differ wholesale where a Choose step broke a tie
    # the other way; ``choose_flips`` names those examples and the gap
    # between the two cosines that decided
    from stair_tpu_torch.ir.lowering import Opcode

    serving = TW.ServingBatches(
        "cpu", batch_size=64, question_len=8, pool_size=64, hidden_size=32,
        video_size=8, text_size=6, max_video_length=8,
        compute_dtype="float32")
    mega = TW.build_model(serving.cfg, seed=0)
    step = TN.VideoNMN(serving.cfg, mega.param_tree(), executor="step")
    batch = serving.device_batch(serving.host_batch(0))
    rv, ref = step(batch)["regs_vec"], mega(batch)["regs_vec"]
    trace = batch["trace"]
    flipped, gap = TW.choose_flips(trace, rv, ref)
    is_choose = (trace["opcode"] == int(Opcode.CHOOSE)).any(1)
    assert is_choose.any() and not flipped.any()
    assert torch.equal(torch.isfinite(gap), is_choose)

    # hand one example the operand its Choose step did not keep
    gaps = torch.where(is_choose, gap, torch.zeros_like(gap))
    b = int(gaps.argmax())
    assert gaps[b] > 0
    t = int((trace["opcode"][b] == int(Opcode.CHOOSE)).nonzero()[0])
    va, vb, dst = (int(trace[k][b, t]) for k in ("va", "vb", "out_vec"))
    other = vb if torch.equal(rv[b, dst], rv[b, va]) else va
    swapped = rv.clone()
    swapped[b, dst] = rv[b, other]
    flipped, gap2 = TW.choose_flips(trace, swapped, ref)
    assert flipped.nonzero().flatten().tolist() == [b]
    assert torch.equal(gap2, gap)
