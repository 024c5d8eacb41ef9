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
    _hold_against_jax_kernel(compute_dtype, rtol, atol)


@needs_jax
@pytest.mark.parametrize("compute_dtype,rtol,atol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 1e-2, 3e-2)])
@pytest.mark.parametrize("F", [72, 150])
def test_fused_step_reference_matches_jax_kernel_above_64_frames(
        F, compute_dtype, rtol, atol):
    """As above at the widths the redesigned routes now take above 64
    frames (F 150, the NMN CLIs' default, and a ragged 72), at H 64:
    JAX's ``_step_kernel`` holds a whole ``[F, H]`` example at any F."""
    _hold_against_jax_kernel(compute_dtype, rtol, atol, F=F)


def _hold_against_jax_kernel(compute_dtype, rtol, atol, F=16, H=64):
    """``fused_step_reference`` against ``JE.fused_step(interpret=True)``
    on ``step_inputs(compute_dtype, F, H)`` (see the module docstring)."""
    args = step_inputs(compute_dtype, F=F, H=H)
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
    (torch.float32, 64, 512, "fma32"), (torch.float32, 16, 128, "fma32"),
    (torch.float32, 48, 384, "fma32"), (torch.float32, 64, 96, "general"),
    (torch.float32, 64, 640, "general"), (torch.float32, 8, 512, "general"),
    (torch.bfloat16, 20, 96, "general"), (torch.bfloat16, 20, 512, "tc"),
    (torch.bfloat16, 64, 96, "general"), (torch.bfloat16, 80, 512, "tc"),
    (torch.bfloat16, 64, 576, "general"), (torch.bfloat16, 8, 64, "general"),
    (torch.bfloat16, 16, 32, "general"), (torch.float16, 64, 512, "general"),
    (torch.float32, 150, 512, "fma32"), (torch.float32, 72, 512, "fma32"),
    (torch.float32, 256, 128, "fma32"), (torch.bfloat16, 150, 512, "tc"),
    (torch.float32, 15, 512, "general"), (torch.bfloat16, 15, 512, "general"),
    (torch.float32, 257, 128, "general"),
    (torch.bfloat16, 257, 512, "general"),
    (torch.float32, 150, 96, "general"), (torch.bfloat16, 150, 96, "general"),
]


@pytest.mark.parametrize(
    "dtype,F,H,route", STEP_ROUTE_CASES,
    ids=[f"{str(d)[6:]}-F{f}-H{h}" for d, f, h, _ in STEP_ROUTE_CASES])
def test_step_route_choice(dtype, F, H, route):
    """bf16 at the widths the megakernel's tensor-core route takes
    (``tc_route_shape``: H a multiple of 64 up to 512, any F from 16 to 256,
    above 64 frames or at a ragged F in the row-slice mode) goes to the
    tensor-core step kernel, float32 at the widths of the megakernel's
    "fma32" routes (``step_fma32_shape``: H a multiple of 128 up to 512, any
    F from 16 to 256) to the float32 one, everything else (F 15 or 257, H
    96, other dtypes) to the general one."""
    from stair_tpu_torch.ops import mega_exec as TX

    assert TE.step_route(dtype, F, H) == route
    assert (route == "fma32") == (dtype == torch.float32
                                  and TE.step_fma32_shape(H, F))
    assert (route == "tc") == (dtype == torch.bfloat16
                               and TX.tc_route_shape(H, F))
    assert TE.step_fma32_shape(H, F) == TX.fma32_shape(H, F)


def _source_expr(signature):
    """The return expression of the ``csrc/executor_step.cu`` function
    that begins with ``signature``, on one line, its casts dropped."""
    import os

    from stair_tpu_torch.ops import _build

    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "executor_step.cu")) as f:
        src = f.read()
    body = src[src.index(signature):]
    expr = body[body.index("return") + 6:body.index(";")]
    return " ".join(expr.split()).replace("(size_t)", "")


def _ternaries(expr):
    """``expr`` with every parenthesized C ternary ``(c ? a : b)`` written
    as Python's ``((a) if (c) else (b))``, the last one first (so the
    innermost before the one around it)."""
    while "?" in expr:
        q = expr.rindex("?")
        depth, lo = 0, q
        while depth >= 0:
            lo -= 1
            depth += {")": 1, "(": -1}.get(expr[lo], 0)
        depth, hi, colon = 0, q, None
        while depth >= 0:
            hi += 1
            depth += {"(": 1, ")": -1}.get(expr[hi], 0)
            if depth == 0 and expr[hi] == ":":
                colon = hi
        c, a, b = expr[lo + 1:q], expr[q + 1:colon], expr[colon + 1:hi]
        expr = f"{expr[:lo]}(({a.strip()}) if ({c.strip()}) else " \
            f"({b.strip()})){expr[hi + 1:]}"
    return expr


def _source_smem_bytes():
    """``step_tc_smem_bytes`` of ``csrc/executor_step.cu`` as a Python
    function of ``(F, H, sliced)``: its return expression with the casts
    dropped, the sizes and constants filled in, the ternaries as Python's
    and ``tc_slice_rows`` as ``mega_exec``'s mirror of it."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX

    expr = _source_expr("inline size_t step_tc_smem_bytes(int F, int H,")
    expr = expr.replace("sizeof(bf16)", "2").replace("sizeof(float)", "4")
    expr = expr.replace("tc_ring<FWD_BN>()",
                        "(TC_STAGES * FWD_BN * (TC_BK + TC_PAD))")
    expr = _ternaries(expr)
    assert "<" not in expr, expr
    consts = {**TX._TILES, **_build.header_ints("executor_step.cu")}
    consts["TC_PARTS"] = consts["THREADS"] * 8
    consts["NWARPS"] = consts["THREADS"] // 32
    return lambda F, H, sliced: eval(
        expr, {"tc_slice_rows": TX.tc_slice_rows},
        {**consts, "F": F, "H": H, "sliced": sliced})


def test_step_tc_shared_memory_matches_the_source_and_fits():
    """``step_tc_smem_bytes`` equals the CUDA source's formula at every
    width the tensor-core route takes, in both modes: one CTA a tile with
    the whole ``[F, H + 8]`` tiles at F a multiple of 16 up to 64, the
    row-slice mode (tiles of at most 64 rows) at every F from 16 to 256;
    every such CTA (the dynamic plan and the schedule column) fits the 227
    KB a block may use. The serving path's F 64, H 512 at 229,920 bytes, the
    NMN CLIs' F 150 at 206,032."""
    from stair_tpu_torch.ops import mega_exec as TX

    source = _source_smem_bytes()
    for H in range(64, TX.TC_MAX_H + 1, 64):
        for F in range(TX.TC_MIN_F, TX.TC_ROUTE_MAX_F + 1):
            assert TE.step_route(torch.bfloat16, F, H) == "tc"
            sliced = F % 16 != 0 or F > TX.TC_MAX_F
            assert TX.tc_sliced(F) == sliced
            modes = (True,) if sliced else (False, True)
            for mode in modes:
                got = TE.step_tc_smem_bytes(F, H, mode)
                assert got == source(F, H, mode), (F, H, mode)
                assert got + 4 * TE.NS <= TX.SMEM_MAX, (F, H, mode)
    assert TE.step_tc_smem_bytes(64, 512, False) == 229920
    assert TE.step_tc_smem_bytes(150, 512, True) == source(150, 512, True) \
        == 206032
    assert TE.step_route(torch.bfloat16, 150, 512) == "tc"


def test_step_fma32_shared_memory_and_cluster_match_the_source():
    """``step_fma32_smem_bytes`` and ``step_fma32_cluster`` equal the CUDA
    source's formulas (``step32_smem_bytes``, ``step32_cluster``) at every
    width the "fma32" route takes (every F from 16 to 256); the cluster is
    one CTA a ``gemm32`` column tile (``H / G32_BN``, read through
    ``_build.header_ints``), at most the portable 8, while a launch's tiles
    number fewer than twice the card's CTA slots, and one CTA a tile from
    there on; two CTAs fit an SM (227 KB a block, 228 KB an SM with 1 KB
    reserved a block), the serving path's F 64, H 512 at 83,744 bytes and
    the NMN CLIs' F 150 at 84,776."""
    import re

    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX

    t = _build.header_ints("mega_common.cuh")
    smem = _source_expr("inline size_t step32_smem_bytes(int F, int H) {")
    smem = smem.replace("sizeof(float)", "4").replace(
        "g32_ring<false>()",
        "(G32_STAGES * (G32_BM * (G32_BK + G32_PAD) + G32_BK * G32_BN))")
    cluster = _source_expr(
        "inline int step32_cluster(int B, int H, int slots) {")
    assert cluster == "B < 2 * slots ? H / G32_BN : 1", cluster
    cluster = re.sub(r"^(.+) \? (.+) : (.+)$", r"(\2) if (\1) else (\3)",
                     cluster)
    consts = {**t, "NWARPS": t["THREADS"] // 32}
    slots = 2 * 132                       # two CTAs on each of 132 SMs
    n = 0
    for H in range(16, TX.MAX_H + 1, 16):
        for F in range(8, TX.MAX_F + 2):
            if TE.step_route(torch.float32, F, H) != "fma32":
                continue
            n += 1
            env = {**consts, "F": F, "H": H}
            assert TE.step_fma32_smem_bytes(F, H) == eval(smem, {}, env)
            for B in (1, 32, 216, 512, 2 * slots - 1, 2 * slots, 1024):
                env.update(B=B, slots=slots)
                want = H // t["G32_BN"] if B < 2 * slots else 1
                assert TE.step_fma32_cluster(B, H, slots) == \
                    eval(cluster, {}, env) == want, (B, F, H)
            assert 1 <= TE.step_fma32_cluster(1, H, slots) <= 8
            per_cta = TE.step_fma32_smem_bytes(F, H) + 4 * TE.NS
            assert per_cta <= TX.SMEM_MAX
            assert 2 * (per_cta + 1024) <= 228 * 1024, (F, H)
    assert n == 4 * 241   # H 128, 256, 384, 512 x F 16 to 256
    assert TE.step_fma32_smem_bytes(64, 512) == 83744
    assert TE.step_fma32_smem_bytes(150, 512) == eval(
        smem, {}, {**consts, "F": 150, "H": 512}) == 84776


def test_step_fma32_variant_patches_match_the_source():
    """``scripts/step_fma32_variants.py`` finds each of its anchors in
    ``csrc/executor_step.cu`` exactly once: every fixed variant replaces the
    launch's choice of the cluster size by its own, and the one-CTA-an-SM
    variants ask more shared memory than half an SM holds; the route's own
    build is the source unchanged."""
    import os

    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.scripts import step_fma32_variants as V

    with open(os.path.join(_build._CSRC, "executor_step.cu")) as f:
        src = f.read()
    assert V.patched_source("base") == src
    assert set(V.VARIANTS) == {"general", "fma32", *V.PATCHES}
    for name in V.PATCHES:
        out = V.patched_source(name)
        assert V._PICK not in out and V._PICK in src
        want = "1" if "_c1_" in name else "H / G32_BN"
        assert f"  const int C = {want};\n" in out
        assert ("232448 / 2 + 16" in out) == name.endswith("_1sm"), name


def test_step_clock_patches_match_the_source(tmp_path):
    """``scripts/executor_clocks.py --step`` finds each of its anchors in
    ``csrc/executor_step.cu`` exactly once and puts a lap clock at the end
    of every section of both float32 kernels (seven in each, the epilogue
    one at the kernel's end) and a nested clock in each product helper, the
    cluster barrier and both kernels."""
    from stair_tpu_torch.scripts import executor_clocks as C

    C.patched_step_source(str(tmp_path))
    src = (tmp_path / "executor_step.cu").read_text()
    assert src.count("  lap(") == 2 * 7
    for slot in (0, 6, 8):
        assert f"SClk clk({slot});" in src or f"SClk kclk({slot});" in src
    assert src.count("SClk kclk(8);\n  lap_start();") == 2
    assert 'extern "C" void stair_sclk(' in src


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype,rtol,atol", [
    ("float32", 1e-4, 1e-4), ("bfloat16", 1e-2, 3e-2)])
@pytest.mark.parametrize("F", [16, 48])
def test_fused_step_kernel_vs_plain_version_on_card(cuda_device, F,
                                                    compute_dtype, rtol,
                                                    atol):
    """The kernel of the route ``step_route`` picks (float32 at H 128: the
    "fma32" one; bf16 at H 128: the tensor-core one) against
    ``fused_step_reference`` on CUDA tensors: every output whole, and the
    whole frames file."""
    from stair_tpu_torch.ops import _build

    args = step_inputs(compute_dtype, F=F, H=128, device=cuda_device)
    want = TE.fused_step_reference(*(a.clone() for a in args))
    _build.reset_launches()
    got = TE.fused_step(*args)
    torch.cuda.synchronize()
    route = TE.step_route(args[2].dtype, F, 128)
    assert route == ("tc" if compute_dtype == "bfloat16" else "fma32")
    key = TE.STEP_KEYS[route]
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
        lib = _build.build()
        for sliced in (0, 1):
            assert (lib.stair_executor_step_tc_smem(F, 128, sliced)
                    == TE.step_tc_smem_bytes(F, 128, bool(sliced)))


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


@pytest.mark.cuda
@pytest.mark.parametrize("F,H", [(16, 128), (48, 256), (32, 384), (64, 512)])
def test_fused_step_fma32_vs_general_and_plain_on_card(cuda_device, F, H):
    """The float32 "fma32" route (at this small batch a tile on a cluster
    of H / 128 CTAs, its products on ``gemm32``) equals the forced general
    route bit for bit in every output and the whole frames file, launch for
    launch (one ``executor_step_fma32``, then one ``executor_step``),
    repeats its own bits, and is within 1e-4 of ``fused_step_reference``;
    the library's shared memory equals the Python mirror's, and the
    cluster size its launch picks equals the mirror's at two CTAs an SM,
    on both sides of the card's CTA slots."""
    from stair_tpu_torch.ops import _build

    args = step_inputs("float32", F=F, H=H, device=cuda_device)
    assert TE.step_route(torch.float32, F, H) == "fma32"
    want = TE.fused_step_reference(*(a.clone() for a in args))
    _build.reset_launches()
    got = TE.fused_step(*(a.clone() for a in args))
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "executor_step_fma32": 1}
    again = TE.fused_step(*(a.clone() for a in args))
    pick = TE.step_route
    TE.step_route = lambda *a: "general"
    try:
        _build.reset_launches()
        general = TE.fused_step(*(a.clone() for a in args))
        torch.cuda.synchronize()
    finally:
        TE.step_route = pick
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "executor_step": 1}
    for w, g, g2, gen, what in zip(want, got, again, general, (
            "rf", "pooled", "hasitem", "existsframe", "loc_a", "loc_b")):
        assert torch.equal(g, gen), what
        assert torch.equal(g, g2), what
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=what)
    lib = _build.build()
    assert lib.stair_executor_step_fma32_smem(F, H) == \
        TE.step_fma32_smem_bytes(F, H)
    slots = 2 * torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    for B in (args[2].shape[0], 2 * slots - 1, 2 * slots, 4 * slots):
        assert lib.stair_executor_step_fma32_cluster(B, F, H) == \
            TE.step_fma32_cluster(B, H, slots) == \
            (H // 128 if B < 2 * slots else 1), B


@pytest.mark.cuda
def test_fused_step_fma32_refuses_what_it_does_not_take_on_card(
        cuda_device):
    """A forced "fma32" on bf16 inputs or at a width ``step_fma32_shape``
    refuses (H 64; F 8, below the "fma32" routes' 16), and float32 rows
    that are not 16-byte aligned on the route ``step_route`` picks, raise
    before any launch: no fallback to another route."""
    from stair_tpu_torch.ops import _build

    for dtype, F, H in (("bfloat16", 16, 128), ("float32", 16, 64),
                        ("float32", 8, 128)):
        args = step_inputs(dtype, F=F, H=H, device=cuda_device)
        pick = TE.step_route
        TE.step_route = lambda *a: "fma32"
        try:
            _build.reset_launches()
            with pytest.raises(ValueError, match="'fma32' route takes"):
                TE.fused_step(*args)
            assert sum(_build.LAUNCHES.values()) == 0
        finally:
            TE.step_route = pick
    args = list(step_inputs("float32", F=16, H=128, device=cuda_device))
    for i in (2, 7):    # rf, w1u
        t = args[i]
        shifted = torch.empty(t.numel() + 1, dtype=t.dtype,
                              device=cuda_device)[1:].view(t.shape)
        shifted.copy_(t)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        moved = list(args)
        moved[i] = shifted
        _build.reset_launches()
        with pytest.raises(ValueError, match="16-byte"):
            TE.fused_step(*moved)
        assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("F", [20, 72, 150])
def test_fused_step_fma32_above_64_frames_every_cluster_on_card(cuda_device,
                                                                F):
    """float32 "fma32" at F 20, 72 and 150 (H 512: each product over
    ``gemm32``'s row tiles, the last one ragged) on the cluster its launch
    picks and on every forced size (the divisors 1, 2 and 4 of H / 128):
    every output and the whole frames file equal to the forced general
    route bit for bit, each launch counted under its size in
    ``_build.CLUSTERS``, and within 1e-4 of ``fused_step_reference``."""
    from stair_tpu_torch.ops import _build

    H = 512
    args = step_inputs("float32", F=F, H=H, device=cuda_device)
    B = args[2].shape[0]
    assert TE.step_route(torch.float32, F, H) == "fma32"
    want = TE.fused_step_reference(*(a.clone() for a in args))
    pick = TE.step_route
    TE.step_route = lambda *a: "general"
    try:
        general = TE.fused_step(*(a.clone() for a in args))
    finally:
        TE.step_route = pick
    picked = TE.step_launch_cluster("fma32", B, F, H)
    for cluster in (None, 1, 2, 4):
        _build.reset_launches()
        got = TE.fused_step(*(a.clone() for a in args), cluster=cluster)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
            "executor_step_fma32": 1}
        assert _build.CLUSTERS["executor_step_fma32"] == {
            cluster or picked: 1}
        for g, k, w, what in zip(got, general, want, (
                "rf", "pooled", "hasitem", "existsframe", "loc_a", "loc_b")):
            assert torch.equal(g, k), (what, cluster)
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=what)
    assert _build.build().stair_executor_step_fma32_smem(F, H) == \
        TE.step_fma32_smem_bytes(F, H)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [20, 72, 150])
def test_fused_step_tc_row_slices_every_cluster_on_card(cuda_device, F):
    """bf16 "tc" in its row-slice mode at F 20, 72 and 150 (H 512: a
    tile's frame rows in slices of at most 64, over a thread-block
    cluster): on the cluster its launch picks and on every forced size
    from 1 to 4 and 8, every output and the whole frames file equal to one
    CTA a tile's bit for bit (pooled in a fixed order whatever the size)
    and to a second run's, each launch counted under its size in
    ``_build.CLUSTERS``; within atol 3e-2 + rtol 1e-2 of
    ``fused_step_reference``; the library's shared memory and cluster
    pick equal the Python mirrors'."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX

    H = 512
    args = step_inputs("bfloat16", F=F, H=H, device=cuda_device)
    B = args[2].shape[0]
    assert TE.step_route(torch.bfloat16, F, H) == "tc" and TX.tc_sliced(F)
    want = TE.fused_step_reference(*(a.clone() for a in args))
    one = TE.fused_step(*(a.clone() for a in args), cluster=1)
    for g, w, what in zip(one, want, ("rf", "pooled", "hasitem",
                                      "existsframe", "loc_a", "loc_b")):
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-2,
                                   atol=3e-2, msg=what)
    picked = TE.step_launch_cluster("tc", B, F, H)
    slots = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert picked == TX.tc_cluster(B, F, slots)
    for cluster in (None, 1, 2, 3, 4, 8):
        for _ in range(2):
            _build.reset_launches()
            got = TE.fused_step(*(a.clone() for a in args), cluster=cluster)
            torch.cuda.synchronize()
            assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
                "executor_step_tc": 1}
            assert _build.CLUSTERS["executor_step_tc"] == {
                cluster or picked: 1}
            for g, o, what in zip(got, one, ("rf", "pooled", "hasitem",
                                             "existsframe", "loc_a",
                                             "loc_b")):
                assert torch.equal(g, o), (what, cluster)
    lib = _build.build()
    for sliced in (0, 1):
        assert lib.stair_executor_step_tc_smem(F, H, sliced) == \
            TE.step_tc_smem_bytes(F, H, bool(sliced))
    for b in (1, 32, 64, 128, 1024):
        assert lib.stair_executor_step_tc_cluster(b, F, H) == \
            TX.tc_cluster(b, F, slots), b
