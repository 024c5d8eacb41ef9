"""Port parity: the fused executor step
(stair_tpu_torch/ops/executor_step.py, TPU kernel #10).

One step's inputs are built from the all-opcode programs, taken twice:
the port's ``"step"`` executor runs them, and on the final register files
every example replays one step of its program, the last with a live module
family (first copy) or the last with a frames result (second copy), so that
one call covers every family. The arguments ``heavy_fused`` hands to ``fused_step`` are
recorded and given, as the same numpy arrays, to
``stair_tpu.ops.executor_step.fused_step(..., interpret=True)``.

Compared on the rows the executor reads (the JAX kernel leaves the others
undefined, the port writes 0 there): ``pooled`` / ``hasitem`` of tiles with
a live stage 1, ``existsframe`` everywhere, ``loc_a`` / ``loc_b`` of
Localize / Superlative tiles, and the frames file: the written slot of
FilterFrame / Temporal / AttnVideo tiles, and every slot but the written
one untouched. float32 at 1e-5; bf16 within atol 3e-2 + rtol 1e-2 (XLA on
the CPU may skip a rounding between fused ops; one bf16 step of an O(1)
value is 8e-3). On the card, the kernel against the plain version.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.models import nmn as TN
from stair_tpu_torch.ops import executor_step as TE
from stair_tpu_torch.testing import workload as TW
from torch_port_util import cuda_device  # noqa: F401

try:
    import jax.numpy as jnp

    from stair_tpu.ops import executor_step as JE
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jnp = None
needs_jax = pytest.mark.skipif(jnp is None, reason="JAX not installed")


def step_inputs(compute_dtype, F=16, H=64, device=None, seed=1):
    """``fused_step``'s argument tuple for one synthetic step over the
    all-opcode batch (see the module docstring), as torch tensors."""
    cfg = TN.NMNConfig(
        hidden_size=H, video_size=24, text_size=20, max_video_length=F,
        object_types=3, max_steps=16, num_vec=10, num_frames=6, num_attn=8,
        compute_dtype=compute_dtype)
    model = TN.VideoNMN(cfg, generator=torch.Generator().manual_seed(3),
                        device=device, executor="step")
    n = len(TW.OPCODE_PROGRAMS)
    batch = TW.to_device(
        TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS * 2, seed=seed), device)
    dt = model.compute_dtype
    out = model(batch)
    regs = tuple(out[k].to(dt) for k in ("regs_vec", "regs_frames",
                                         "regs_attn"))
    # per example: the last step with a live stage 1 or stage 2 (first
    # copy of the programs) or with a frames result (second copy)
    scan = TN._Scan(cfg, batch["trace"], None, dt)
    e1, e2 = scan.scal[:, TE.S_E1], scan.scal[:, TE.S_E2]  # [T, B] sorted
    live = (e1 != TE.E1_NULL) | (e2 != TE.E2_NULL)
    frames = (e2 == TE.E2_FF) | (e2 == TE.E2_TEMPORAL) | (
        e2 == TE.E2_ATTNVIDEO)
    T, B = live.shape
    steps = torch.arange(1, T + 1, device=live.device)[:, None]

    def last(mask):                                       # example order
        return (torch.gather(mask, 1, scan.inv1) * steps).amax(0)

    ar = torch.arange(B, device=live.device)
    t_b = torch.where((ar >= n) & (last(frames) > 0), last(frames),
                      last(live)).clamp(min=1) - 1
    one = {k: v[ar, t_b][:, None] for k, v in batch["trace"].items()}
    scan = TN._Scan(cfg, one, None, dt)

    params = TN.tree_map(lambda x: x.detach(), model.param_tree())
    mods = TN.tree_map(lambda x: x.to(dt), params["modules"])
    tables = model._fused_tables(mods)
    f = scan.fields
    ops = (regs[0][ar, f["va"][0]], regs[0][ar, f["vb"][0]],
           regs[0][ar, f["vc"][0]], None, None,
           regs[2][ar, f["aa"][0]], regs[2][ar, f["ab"][0]])
    recorded = {}
    real = TE.fused_step

    def record(*args):
        recorded["args"] = tuple(a.clone() for a in args)
        return real(*args)

    TE.fused_step = record
    try:
        with torch.no_grad():
            scan.heavy_fused(tuple(r.clone() for r in regs), ops, 0, mods,
                             tables, batch["video_mask"].to(dt), ())
    finally:
        TE.fused_step = real
    return recorded["args"]


def _families(scal):
    e1, e2 = scal[TE.S_E1], scal[TE.S_E2]
    return {int(e) for e in e1.tolist()}, {int(e) for e in e2.tolist()}


@needs_jax
@pytest.mark.parametrize("compute_dtype,rtol,atol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 1e-2, 3e-2)])
def test_fused_step_reference_matches_jax_kernel(compute_dtype, rtol, atol):
    args = step_inputs(compute_dtype)
    scal = args[0]
    e1s, e2s = _families(scal)
    # every stage-1 expert family and every stage-2 family is present
    assert {0, 4, 8, 9, 10} <= e1s and e1s & {1, 2, 3} and e1s & {5, 6, 7}, \
        e1s
    assert {TE.E2_FF, TE.E2_TEMPORAL, TE.E2_SUPF, TE.E2_NULL,
            TE.E2_ATTNVIDEO} <= e2s, e2s

    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32

    # gkb (argument 6) is float32 in both dtypes; the schedule is int32.
    # Copies: the port updates rf in place, and on the CPU a JAX array may
    # share a numpy array's memory.
    jargs = [jnp.asarray(a.numpy().copy()) if a.dtype == torch.int32
             or i == 6 else jnp.asarray(a.float().numpy().copy(), jdt)
             for i, a in enumerate(args)]
    want = JE.fused_step(*jargs, interpret=True)
    rf_before = args[2].clone()
    got = TE.fused_step_reference(*args)
    assert got[0] is args[2]                                  # in place

    def close(j, t, rows, what):
        np.testing.assert_allclose(
            np.asarray(j, np.float32)[rows], t.float().numpy()[rows],
            rtol=rtol, atol=atol, err_msg=what)

    perm = scal[TE.S_PERM].long().numpy()
    e1, e2 = scal[TE.S_E1].numpy(), scal[TE.S_E2].numpy()
    outf = scal[TE.S_OUTF].long().numpy()
    stage1 = e1 != TE.E1_NULL
    close(want[1], got[1], stage1, "pooled (sorted order)")
    close(want[2], got[2], perm[stage1], "hasitem")
    close(want[3], got[3], slice(None), "existsframe")
    loc = e1 == TE.E1_LOCALIZE
    close(want[4], got[4], perm[loc], "loc_a")
    close(want[5], got[5], perm[loc], "loc_b")
    assert got[4].dtype == got[5].dtype == torch.float32
    writes = np.isin(e2, (TE.E2_FF, TE.E2_TEMPORAL, TE.E2_ATTNVIDEO))
    assert writes.sum() >= 3
    jrf = np.asarray(want[0], np.float32)
    trf = got[0].float().numpy()
    np.testing.assert_allclose(jrf[perm[writes], outf[writes]],
                               trf[perm[writes], outf[writes]],
                               rtol=rtol, atol=atol, err_msg="frames write")
    # every slot but (example, out_frames) is untouched on both sides, and
    # the port leaves the slot alone too where the tile has no frames result
    untouched = np.ones(trf.shape[:2], bool)
    untouched[perm, outf] = False
    before = rf_before.float().numpy()
    np.testing.assert_array_equal(trf[untouched], before[untouched])
    np.testing.assert_array_equal(jrf[untouched], before[untouched])
    np.testing.assert_array_equal(trf[perm[~writes], outf[~writes]],
                                  before[perm[~writes], outf[~writes]])
    # rows nobody reads are 0 in the port
    assert float(got[1][torch.from_numpy(~stage1)].abs().max()) == 0.0
    assert float(got[4][torch.from_numpy(perm[~loc])].abs().max()) == 0.0


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = step_inputs("float32", F=12, H=32)
    want = TE.fused_step_reference(*(a.clone() for a in args))
    got = TE.fused_step(*args)
    assert got[0] is args[2]
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype,rtol,atol", [
    ("float32", 1e-4, 1e-4), ("bfloat16", 1e-2, 3e-2)])
@pytest.mark.parametrize("F", [16, 48])
def test_fused_step_kernel_vs_plain_version_on_card(cuda_device, F,
                                                    compute_dtype, rtol,
                                                    atol):
    """The kernel against ``fused_step_reference`` on CUDA tensors: every
    output whole, and the whole frames file."""
    from stair_tpu_torch.ops import _build

    args = step_inputs(compute_dtype, F=F, H=128, device=cuda_device)
    want = TE.fused_step_reference(*(a.clone() for a in args))
    _build.reset_launches()
    got = TE.fused_step(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["executor_step"] == 1
    assert got[0] is args[2]
    for w, g, what in zip(want, got, ("rf", "pooled", "hasitem",
                                      "existsframe", "loc_a", "loc_b")):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=what)
