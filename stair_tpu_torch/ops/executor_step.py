"""One fused step of the scan executor, eval and parity Filter only (port
of ``stair_tpu/ops/executor_step.py``).

``fused_step`` computes every ``[F, H]``-level module family of one
instruction per example in one kernel (``csrc/executor_step.cu``, TPU
kernel ``_step_kernel``): the stage-1 expert MLP, the Filter sum-pool, the
HasItem head, the ExistsFrame cosine, the Localize cosines, the FilterFrame
gate, the stage-2 projection with its FilterFrame or Temporal epilogue, and
the AttnVideo product. The frames result is written **in place** into slot
``(example, out_frames)`` of ``rf``: the caller must own ``rf``
(``models/nmn.py`` allocates it and runs this route under ``no_grad``).

``fused_step_reference`` is the plain version in torch ops, with the same
in-place contract and the same rounding sites: float32 values that hold
compute-dtype numbers, rounded (``rd``) where the TPU kernel casts — the
stage-1 hidden after the ReLU, ``feat`` (pooled and hasitem come from the
unrounded float32), the keyword through ``localize.k`` before and after its
bias, the Localize cosine before ``(+ 1) * 0.49``, the stage-2 operand; the
LayerNorm in float32 with eps 1e-5. The wrapper runs it for CPU tensors and
the kernel for CUDA tensors, on the route ``step_route`` picks: the
tensor-core kernel (``executor_step_tc_kernel``, bf16 at the widths
``mega_exec.tc_shape`` takes) or the general one (``step_kernel``).

Rows nobody reads: the TPU kernel leaves ``pooled`` / ``hasitem`` of a tile
without a stage 1 and ``loc_a`` / ``loc_b`` of a tile that is neither
Localize nor Superlative undefined, and flushes stale memory into the
scratch frames slot of a tile without a frames result. Here kernel and
plain version write 0 to the former and leave ``rf`` alone for the latter,
so every element of every output is defined and comparable.
"""

from __future__ import annotations

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import mega_exec as TX
from stair_tpu_torch.ops.mega_exec import MAX_F, MAX_H
from stair_tpu_torch.utils.device import exact_f32

# Rows of the packed [NS, B] int32 schedule. S_W2T and S_FB keep the JAX
# package's layout; the port's kernel reads neither (the stage-2 weight row
# is the e2 code itself, and SUPERLATIVE_F's projection runs outside).
(S_PERM, S_E1, S_W2T, S_E2, S_FA, S_FB, S_VA, S_AA, S_FILT, S_FFV,
 S_VB, S_OUTF) = range(12)
NS = 12

# e2 codes (stage-2 family): ff, temporal, supf(loc.k), null, attnvideo.
E2_FF, E2_TEMPORAL, E2_SUPF, E2_NULL, E2_ATTNVIDEO = range(5)

E1_LOCALIZE, E1_NULL, NUM_E1 = 8, 9, 11
COS_EPS = 1e-8


def fused_step_reference(scal, rv, rf, ra, related, vmask, gkb,
                         w1u, b1u, w2u, b2u, w2t, b2t, ffwf, ln_scale,
                         ln_bias, loc_kw, loc_kb):
    """Plain version of ``fused_step`` (same arguments, same returns, ``rf``
    updated in place)."""
    B, Nf, F, H = rf.shape
    dt, dev = rf.dtype, rf.device
    if dev.type == "cuda":
        exact_f32()
    s = scal.long()
    perm, e1, e2 = s[S_PERM], s[S_E1], s[S_E2]
    filt, ffv = s[S_FILT] > 0, s[S_FFV] > 0

    def rd(x):
        return x.to(dt).float()

    def rows_of(mask):
        return torch.nonzero(mask).flatten()

    def norm(x):
        return torch.sqrt(torch.clamp((x * x).sum(-1), min=1e-30))

    # everything below is in sorted (tile) order
    x = rf[perm, s[S_FA]].float()                            # [B, F, H]
    vm = vmask[perm].float()
    va = rv[perm, s[S_VA]].float()
    vb = rv[perm, s[S_VB]].float()
    f32 = dict(dtype=torch.float32, device=dev)
    feat32 = torch.zeros(B, F, H, **f32)
    h2c0 = torch.zeros(B, F, **f32)
    stage1 = (e1 >= 0) & (e1 != E1_NULL) & (e1 < NUM_E1)

    # ---- stage 1: expert two-layer MLP ----------------------------------
    for e in torch.unique(e1[stage1]).tolist():
        r = rows_of(e1 == e)
        h = rd(torch.relu(x[r] @ w1u[e].float() + b1u[e].float()))
        h2 = h @ w2u[e].float() + b2u[e].float()
        feat32[r] = torch.where(filt[r, None, None], torch.relu(h2), h2)
        h2c0[r] = h2[:, :, 0]
    feat = rd(feat32)
    live = stage1[:, None].float()
    pooled = rd((feat32 * (vm * vm)[:, :, None]).sum(1)) * live
    has = rd(torch.sigmoid(h2c0) * vm) * live

    # ---- existsframe cosine ----------------------------------------------
    cos = (x * va[:, None, :]).sum(-1) / torch.clamp(
        norm(x) * norm(va)[:, None], min=COS_EPS)
    exf = rd((cos + 1.0) * 0.49 * vm)

    # ---- localize scores --------------------------------------------------
    loc = [torch.zeros(B, F, **f32) for _ in range(2)]
    r = rows_of(e1 == E1_LOCALIZE)
    if r.numel():
        fr = feat[r]
        nf = norm(fr)
        for v, out in zip((va, vb), loc):
            kw = rd(rd(v[r] @ loc_kw.float()) + loc_kb.float().reshape(-1))
            dots = (fr * kw[:, None, :]).sum(-1)
            cos_k = rd(dots / torch.clamp(nf * norm(kw)[:, None],
                                          min=COS_EPS))
            out[r] = (cos_k + 1.0) * 0.49 * vm[r]

    # ---- stage 2 and attnvideo, written into rf in place ------------------
    out_f = s[S_OUTF]
    r = rows_of((e2 == E2_FF) & stage1)
    if r.numel():
        glog = (feat[r] @ ffwf.float())[:, :, 0] + gkb[perm[r]].reshape(-1, 1)
        gate = torch.where(ffv[r, None], torch.sigmoid(glog),
                           torch.ones_like(glog))
        x2 = rd(gate[:, :, None] * feat[r])
        y2 = x2 @ w2t[E2_FF].float() + b2t[E2_FF].float()
        rf[perm[r], out_f[r]] = (torch.relu(y2) * vm[r][:, :, None]).to(dt)
    r = rows_of(e2 == E2_TEMPORAL)
    if r.numel():
        rel = related[perm[r]].float()
        x2 = rd(rel[:, :, None] * x[r])
        y = torch.relu(x2 @ w2t[E2_TEMPORAL].float()
                       + b2t[E2_TEMPORAL].float())
        mu = y.mean(-1, keepdim=True)
        var = torch.square(y - mu).mean(-1, keepdim=True)
        ln = ((y - mu) * torch.rsqrt(var + 1e-5) * ln_scale.float().reshape(-1)
              + ln_bias.float().reshape(-1))
        rf[perm[r], out_f[r]] = ln.to(dt)
    r = rows_of(e2 == E2_ATTNVIDEO)
    if r.numel():
        aa = ra[perm[r], s[S_AA][r]].float()
        rf[perm[r], out_f[r]] = (aa[:, :, None] * x[r]).to(dt)

    def unsort(v, dtype):
        out = torch.empty(v.shape, dtype=dtype, device=dev)
        out[perm] = v.to(dtype)
        return out

    return (rf, pooled.to(dt), unsort(has, dt), unsort(exf, dt),
            unsort(loc[0], torch.float32), unsort(loc[1], torch.float32))


def step_route(dtype, F, H) -> str:
    """The fused step's kernel route, chosen before the launch: ``"tc"``
    (``executor_step_tc_kernel``, launch key ``executor_step_tc``: bf16 at
    the widths ``mega_exec.tc_shape`` takes, H a multiple of 64 up to
    ``TC_MAX_H`` and F a multiple of 16 up to ``TC_MAX_F``) or
    ``"general"`` (``step_kernel``, ``executor_step``: float32 and every
    other width)."""
    if dtype == torch.bfloat16 and TX.tc_shape(H, F):
        return "tc"
    return "general"


#: the pooled partials' row groups of the tensor-core kernel
POOL_ROWS = _build.header_ints("executor_step.cu")["POOL_ROWS"]


def step_tc_smem_bytes(F, H) -> int:
    """Dynamic shared memory of ``executor_step_tc_kernel`` per block, as
    ``csrc/executor_step.cu step_tc_smem_bytes`` computes it: two ``[F, H
    + 8]`` bf16 tiles, the weight ring, three float vectors of ``H``, the
    pooled partials (``POOL_ROWS`` rows of ``H``; the vec products'
    partials share them), three ``[F]`` vectors and the warp sums."""
    t = TX._TILES
    ring = t["TC_STAGES"] * t["FWD_BN"] * (t["TC_BK"] + t["TC_PAD"])
    parts = max(POOL_ROWS * H, t["THREADS"] * 8)
    return (2 * F * (H + t["TC_PAD"]) * 2 + ring * 2
            + (3 * H + parts + 3 * F + t["THREADS"] // 32) * 4)


def fused_step(scal, rv, rf, ra, related, vmask, gkb,
               w1u, b1u, w2u, b2u, w2t, b2t, ffwf, ln_scale, ln_bias,
               loc_kw, loc_kb):
    """Run one fused executor step over an expert-sorted batch.

    ``scal`` [NS, B] int32 (the ``S_*`` rows; ``S_PERM`` expert-sorted so
    that tiles of one expert are neighbours). ``rv`` [B, Nv, H], ``rf``
    [B, Nf, F, H], ``ra`` [B, Na, F]; ``related`` / ``vmask`` [B, F] in the
    compute dtype and ``gkb`` [B, 1] float32 (the FilterFrame gate's keyword
    half), all in example order. Weights: ``w1u`` / ``w2u`` [11, H, H],
    ``b1u`` / ``b2u`` [11, H], ``w2t`` [4, H, H], ``b2t`` [4, H], ``ffwf``
    [H, 1], ``ln_*`` [1, H], ``loc_kw`` [H, H], ``loc_kb`` [1, H].

    Returns ``(rf, pooled_sorted, hasitem, existsframe, loc_a, loc_b)``:
    ``rf`` is the tensor passed in with this step's frames write applied
    (the FilterFrame / Temporal / AttnVideo result at ``(example,
    out_frames)``; SSA makes that slot none of the example's operands;
    other examples' files are untouched); ``pooled`` [B, H] in sorted
    order; ``hasitem`` / ``existsframe`` [B, F] in the compute dtype and
    ``loc_a`` / ``loc_b`` [B, F] float32 in example order. SUPERLATIVE_F's
    inputs are not produced here. Plain version for CPU tensors, the CUDA
    kernel of ``step_route`` for CUDA tensors.
    """
    if _build.on_cpu("executor_step", rf):
        return fused_step_reference(
            scal, rv, rf, ra, related, vmask, gkb, w1u, b1u, w2u, b2u, w2t,
            b2t, ffwf, ln_scale, ln_bias, loc_kw, loc_kb)
    B, Nf, F, H = rf.shape
    Nv, Na = rv.shape[1], ra.shape[1]
    dt, dev = rf.dtype, rf.device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"executor_step kernel: unsupported dtype {dt}")
    if not (1 <= H <= MAX_H and 1 <= F <= MAX_F):
        raise ValueError(f"executor_step kernel: H={H} (<= {MAX_H}), "
                         f"F={F} (<= {MAX_F})")
    ins = (
        ("scal", scal, torch.int32, (NS, B)), ("rv", rv, dt, (B, Nv, H)),
        ("rf", rf, dt, (B, Nf, F, H)), ("ra", ra, dt, (B, Na, F)),
        ("related", related, dt, (B, F)), ("vmask", vmask, dt, (B, F)),
        ("gkb", gkb, torch.float32, (B, 1)),
        ("w1u", w1u, dt, (NUM_E1, H, H)), ("b1u", b1u, dt, (NUM_E1, H)),
        ("w2u", w2u, dt, (NUM_E1, H, H)), ("b2u", b2u, dt, (NUM_E1, H)),
        ("w2t", w2t, dt, (4, H, H)), ("b2t", b2t, dt, (4, H)),
        ("ffwf", ffwf, dt, (H, 1)), ("ln_scale", ln_scale, dt, (1, H)),
        ("ln_bias", ln_bias, dt, (1, H)), ("loc_kw", loc_kw, dt, (H, H)),
        ("loc_kb", loc_kb, dt, (1, H)),
    )
    for name, t, dtype, shape in ins:
        _build.check_tensor(f"executor_step {name}", t, dtype, shape, dev)
    pooled = torch.empty(B, H, dtype=dt, device=dev)
    has = torch.empty(B, F, dtype=dt, device=dev)
    exf = torch.empty(B, F, dtype=dt, device=dev)
    loc_a = torch.empty(B, F, dtype=torch.float32, device=dev)
    loc_b = torch.empty(B, F, dtype=torch.float32, device=dev)
    if B == 0:
        return rf, pooled, has, exf, loc_a, loc_b
    ptrs = (*(t for _, t, _, _ in ins), pooled, has, exf, loc_a, loc_b)
    lib = _build.build()
    if step_route(dt, F, H) == "tc":
        # read as 16-byte vectors (cp.async, the weight ring, vecmat_tc)
        for name, t in (("rf", rf), ("w1u", w1u), ("w2u", w2u),
                        ("w2t", w2t), ("loc_kw", loc_kw)):
            if t.data_ptr() % 16:
                raise ValueError(f"executor_step_tc {name}: the tensor-core "
                                 "kernel needs 16-byte aligned data")
        key = "executor_step_tc"
        # float32 workspace: the Temporal pre-LayerNorm rows (the hidden
        # and feat tiles stay in shared memory)
        ws = torch.empty(B, F, H, dtype=torch.float32, device=dev)
        err = lib.stair_executor_step_tc(
            _build.pointers(ptrs), len(ptrs), ws.data_ptr(), B, Nv, Nf, Na,
            F, H, _build.stream_ptr(dev))
    else:
        key = "executor_step"
        # Per-tile float32 workspace: the stage-1 hidden / stage-2
        # operand, and the feat tile (later the Temporal pre-LN rows).
        ws = torch.empty(B, 2, F, H, dtype=torch.float32, device=dev)
        err = lib.stair_executor_step(
            _build.pointers(ptrs), len(ptrs), ws.data_ptr(), B, Nv, Nf, Na,
            F, H, int(dt == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(err, key)
    _build.LAUNCHES[key] += 1
    return rf, pooled, has, exf, loc_a, loc_b
