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
value is 8e-3). On the card, each kernel route against the plain version.
The route choice (``step_route``) and the tensor-core kernel's shared
memory plan are checked here against the CUDA source.
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


STEP_ROUTE_CASES = [
    (torch.bfloat16, 64, 512, "tc"), (torch.bfloat16, 16, 64, "tc"),
    (torch.bfloat16, 48, 128, "tc"), (torch.bfloat16, 16, 192, "tc"),
    (torch.float32, 64, 512, "general"), (torch.float32, 16, 128, "general"),
    (torch.bfloat16, 20, 96, "general"), (torch.bfloat16, 20, 512, "general"),
    (torch.bfloat16, 64, 96, "general"), (torch.bfloat16, 80, 512, "general"),
    (torch.bfloat16, 64, 576, "general"), (torch.bfloat16, 8, 64, "general"),
    (torch.bfloat16, 16, 32, "general"), (torch.float16, 64, 512, "general"),
]


@pytest.mark.parametrize(
    "dtype,F,H,route", STEP_ROUTE_CASES,
    ids=[f"{str(d)[6:]}-F{f}-H{h}" for d, f, h, _ in STEP_ROUTE_CASES])
def test_step_route_choice(dtype, F, H, route):
    """bf16 at the widths the megakernel's tensor-core route takes goes to
    the tensor-core step kernel, everything else to the general one."""
    assert TE.step_route(dtype, F, H) == route


def _source_smem_bytes():
    """``step_tc_smem_bytes`` of ``csrc/executor_step.cu`` as a Python
    function: its return expression with the casts dropped, the sizes and
    constants filled in and the ternary as ``max``."""
    import os
    import re

    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX

    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "executor_step.cu")) as f:
        src = f.read()
    body = src[src.index("inline size_t step_tc_smem_bytes(int F, int H) {"):]
    expr = body[body.index("return") + 6:body.index(";")]
    expr = " ".join(expr.split()).replace("(size_t)", "")
    expr = expr.replace("sizeof(bf16)", "2").replace("sizeof(float)", "4")
    expr = expr.replace("tc_ring<FWD_BN>()",
                        "(TC_STAGES * FWD_BN * (TC_BK + TC_PAD))")
    expr = re.sub(r"\(([^()?]+) > ([^()?]+) \? \1 : \2\)", r"max(\1, \2)",
                  expr)
    assert "?" not in expr and "<" not in expr, expr
    consts = {**TX._TILES, **_build.header_ints("executor_step.cu")}
    consts["TC_PARTS"] = consts["THREADS"] * 8
    consts["NWARPS"] = consts["THREADS"] // 32
    return lambda F, H: eval(expr, {"max": max}, {**consts, "F": F, "H": H})


def test_step_tc_shared_memory_matches_the_source_and_fits():
    """``step_tc_smem_bytes`` equals the CUDA source's formula at every
    width the tensor-core route takes, and every such block (the dynamic
    plan and the schedule column) fits the 227 KB a block may use, the
    main path's F 64, H 512 at 228,128 bytes."""
    from stair_tpu_torch.ops import mega_exec as TX

    source = _source_smem_bytes()
    for H in range(64, TX.TC_MAX_H + 1, 64):
        for F in range(16, TX.TC_MAX_F + 1, 16):
            assert TE.step_route(torch.bfloat16, F, H) == "tc"
            assert TE.step_tc_smem_bytes(F, H) == source(F, H), (F, H)
            assert TE.step_tc_smem_bytes(F, H) + 4 * TE.NS <= TX.SMEM_MAX
    assert TE.step_tc_smem_bytes(64, 512) == 228128


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype,rtol,atol", [
    ("float32", 1e-4, 1e-4), ("bfloat16", 1e-2, 3e-2)])
@pytest.mark.parametrize("F", [16, 48])
def test_fused_step_kernel_vs_plain_version_on_card(cuda_device, F,
                                                    compute_dtype, rtol,
                                                    atol):
    """The kernel of the route ``step_route`` picks (float32: the general
    one; bf16 at H 128: the tensor-core one) against
    ``fused_step_reference`` on CUDA tensors: every output whole, and the
    whole frames file."""
    from stair_tpu_torch.ops import _build

    args = step_inputs(compute_dtype, F=F, H=128, device=cuda_device)
    want = TE.fused_step_reference(*(a.clone() for a in args))
    _build.reset_launches()
    got = TE.fused_step(*args)
    torch.cuda.synchronize()
    route = TE.step_route(args[2].dtype, F, 128)
    assert route == ("tc" if compute_dtype == "bfloat16" else "general")
    key = "executor_step_tc" if route == "tc" else "executor_step"
    assert _build.LAUNCHES[key] == 1 and sum(_build.LAUNCHES.values()) == 1
    assert got[0] is args[2]
    for w, g, what in zip(want, got, ("rf", "pooled", "hasitem",
                                      "existsframe", "loc_a", "loc_b")):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tc", "general"])
@pytest.mark.parametrize("F", [16, 48])
def test_fused_step_bf16_routes_vs_plain_and_repeat_on_card(cuda_device, F,
                                                            route):
    """Both bf16 routes against ``fused_step_reference`` (atol 3e-2 + rtol
    1e-2) at H 128, and a second launch on the same inputs gives the same
    bits (the tensor-core kernel sums its pooled partials in a fixed
    order, without atomics)."""
    from stair_tpu_torch.ops import _build

    args = step_inputs("bfloat16", F=F, H=128, device=cuda_device)
    want = TE.fused_step_reference(*(a.clone() for a in args))
    pick = TE.step_route
    TE.step_route = lambda *a: route
    try:
        _build.reset_launches()
        got = TE.fused_step(*(a.clone() for a in args))
        again = TE.fused_step(*(a.clone() for a in args))
        torch.cuda.synchronize()
    finally:
        TE.step_route = pick
    key = "executor_step_tc" if route == "tc" else "executor_step"
    assert _build.LAUNCHES[key] == 2 and sum(_build.LAUNCHES.values()) == 2
    for w, g, g2, what in zip(want, got, again, (
            "rf", "pooled", "hasitem", "existsframe", "loc_a", "loc_b")):
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-2,
                                   atol=3e-2, msg=what)
        assert torch.equal(g, g2), what
    if route == "tc":
        assert (_build.build().stair_executor_step_tc_smem(F, 128)
                == TE.step_tc_smem_bytes(F, 128))


@pytest.mark.cuda
def test_fused_step_tc_refuses_unaligned_rows_on_card(cuda_device):
    """The tensor-core route reads rf and the weight tables as 16-byte
    vectors: a frames file that is not 16-byte aligned raises, with no
    launch and no fallback to another route."""
    from stair_tpu_torch.ops import _build

    args = list(step_inputs("bfloat16", F=16, H=128, device=cuda_device))
    rf = args[2]
    shifted = torch.empty(rf.numel() + 1, dtype=rf.dtype,
                          device=cuda_device)[1:].view(rf.shape)
    shifted.copy_(rf)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    args[2] = shifted
    _build.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        TE.fused_step(*args)
    assert sum(_build.LAUNCHES.values()) == 0
