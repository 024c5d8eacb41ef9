"""The executor megakernel (port of ``stair_tpu/ops/mega_exec.py``).

One example's whole instruction trace runs per CUDA thread block
(``csrc/mega_exec.cu``): the block walks its ``[T, 17]`` instruction row
over three typed register files (vec ``[Nv+1, H]``, frames ``[Nf+1, F,
H]``, attn ``[Na+1, F]``) and returns the final files, which are the
auditable intermediates.

``prepare_args`` packs the inputs exactly as the JAX package does (the
scalar pack with its ``e1`` expert code, temporal band matrices in conv
mode or the linear stack otherwise, casts to the compute dtype).
``mega_exec_reference`` is the plain version: an eager executor batched
over B and looping over T that mirrors ``_make_kernel`` opcode by opcode,
rounding to the compute dtype at the same sites (``lin_dt`` and friends).
``mega_exec_call`` is the kernel wrapper: plain version for CPU tensors,
the CUDA kernel for CUDA tensors, or an error; ``mega_exec`` packs and
calls it, as the JAX function does. ``fwd_route`` picks the kernel before
the launch: the tensor-core route (``mega_exec_tc_kernel``, launch keys
``mega_exec_tc`` for eval and ``mega_exec_train_tc`` for training) for
bf16 at the shapes it takes, the "fma32" route (``mega_exec_kernel<float,
true>``: the general kernel with its products on ``gemm32``'s
register-blocked tiles, bit for bit the general route's files;
``mega_exec_fma32``, ``mega_exec_train_fma32``) for float32 at the shapes
it takes, the general route (``mega_exec_kernel``: ``mega_exec``,
``mega_exec_train``) for every other dtype and width.

Training: ``mega_exec_train_call`` is the forward with the counter-hash
dropout ``hash_keep`` at the JAX kernel's eight sites (TPU kernel #5); the
backward and the autograd Function are in ``ops/mega_grad.py``, whose
``bwd_route`` follows this forward's route, so that each backward walk
recomputes its own route's forward bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from stair_tpu_torch.ir.lowering import Opcode
from stair_tpu_torch.models.modules import (
    abs_jax, conv1d_same_matrix, cosine, cosine_matrix, layer_norm,
    masked_softmax,
)
from stair_tpu_torch.ops import _build
from stair_tpu_torch.utils.device import exact_f32

# Scalar field columns of the per-example [T, NSF] instruction block.
(F_OP, F_E1, F_VA, F_VB, F_VC, F_FA, F_FB, F_AA, F_AB, F_MODE, F_COUNT,
 F_SS, F_SE, F_OUT_V, F_OUT_F, F_OUT_A, F_OUT_AB) = range(17)
NSF = 17

_U32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = (x * (c & 0xFFFF)) & _U32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_keep(shape, b, t, site, seed0, seed1, rate, device=None):
    """The executor's dropout mask (port of ``stair_tpu/ops/mega_exec.py
    hash_keep``): float32 ``{0, 1/(1-rate)}`` over ``shape`` (rows, cols).

    JAX computes a murmur3-style hash of (row, column, example ``b``, step
    ``t``, ``site``, seed) in wrapping int32 arithmetic with logical right
    shifts; here the same bits come from int64 tensors reduced mod 2^32
    after every multiply and add. ``b`` may be an int or an int64 tensor of
    example indices ``[n]``; the result is then ``[n, rows, cols]``."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = (_mul32(r, 0x9E3779B1) + _mul32(c, 0x85EBCA77)) & _U32
    b = torch.as_tensor(b, dtype=torch.int64, device=device)
    key = ((seed0 & _U32) + _mul32(b & _U32, 0xC2B2AE3D)
           + _mul32(torch.tensor(t & _U32, device=device), 0x27D4EB2F)
           + _mul32(torch.tensor(site & _U32, device=device), 0x165667B1)
           ) & _U32
    h = h ^ key.reshape(key.shape + (1, 1))
    h = (h + (seed1 & _U32)) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    u = (h >> 8) & 0xFFFFFF
    thresh = int(rate * float(1 << 24))
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return torch.where(u >= thresh, scale.to(device),
                       torch.zeros((), device=device))


def dropout_params(rate, seed):
    """The kernels' dropout arguments ``(on, seed0, seed1, thresh,
    scale)``; off when ``seed`` is None or ``rate`` is 0, as in JAX."""
    if seed is None or rate <= 0.0:
        return 0, 0, 0, 0, 1.0
    s0, s1 = (int(v) for v in seed)
    return 1, s0, s1, int(rate * float(1 << 24)), float(1.0 / (1.0 - rate))


#: names of ``prepare_args``'s tensors, in order (the kernel's pointer table)
ARG_NAMES = (
    "scal", "vf_a", "vf_b", "vm", "tok_a", "tok_b", "tm", "aux",
    "w1u", "b1u", "w2u", "b2u", "w2t", "b2t", "fdw", "fdb",
    "cw", "cb", "eqw", "eqb", "xw", "xb", "qw", "qb",
    "taw1", "tab1", "taw2", "tab2", "exw1", "exb1", "exw2", "exb2",
    "supw", "supb", "ffwf", "ffkw", "ffab", "fltw", "fltk", "fltb",
    "lns", "lnb", "beta", "t1", "t2", "t3", "tb1", "tb2", "tb3",
)


def prepare_args(cfg, mods, tables, trace_fields, video_halves,
                 video_mask, token_halves, token_mask, aux_vec=None):
    """Pack the executor's inputs into the kernel argument tuple.

    ``mods``/``tables`` are already in the compute dtype; halves are
    ``(fwd, bwd)`` ``[B, F|L, H/2]`` pairs in that dtype. Returns
    ``(meta, args)``: ``meta = (B, T, Nv, Nf, Na, F, H, Hh, L, dt, fsoft)``
    and ``args`` in ``ARG_NAMES`` order, every tensor contiguous.
    """
    vf_a, vf_b = video_halves
    tok_a, tok_b = token_halves
    B, F, Hh = vf_a.shape
    L = tok_a.shape[1]
    H = 2 * Hh
    assert vf_b.shape == vf_a.shape and tok_b.shape == tok_a.shape
    assert tok_a.shape[-1] == Hh
    T = trace_fields["opcode"].shape[1]
    dt = vf_a.dtype
    dev = vf_a.device
    Nv, Nf, Na = cfg.num_vec + 1, cfg.num_frames + 1, cfg.num_attn + 1

    # ---- scalar pack: [B, T, NSF] int32 --------------------------------
    op = trace_fields["opcode"].long()
    mode = trace_fields["mode"].long()
    is_ff = (op == int(Opcode.FILTERFRAME_V)) | (
        op == int(Opcode.FILTERFRAME_K))
    is_filter = is_ff | (op == int(Opcode.FILTER_V)) | (
        op == int(Opcode.FILTER_K))
    is_kw = (op == int(Opcode.FILTER_K)) | (op == int(Opcode.FILTERFRAME_K))
    is_locsup = ((op == int(Opcode.LOCALIZE))
                 | (op == int(Opcode.SUPERLATIVE_V))
                 | (op == int(Opcode.SUPERLATIVE_F)))
    zero = torch.zeros_like(op)
    e1 = torch.where(
        is_filter,
        torch.where(is_ff, 4, zero) + torch.where(is_kw, 1 + mode, zero),
        torch.where(is_locsup, 8,
                    torch.where(op == int(Opcode.HASITEM), 10, 9 + zero)),
    )
    scal = torch.stack([
        op, e1, trace_fields["va"].long(), trace_fields["vb"].long(),
        trace_fields["vc"].long(), trace_fields["fa"].long(),
        trace_fields["fb"].long(), trace_fields["aa"].long(),
        trace_fields["ab"].long(), mode, trace_fields["count"].long(),
        trace_fields["span_start"].long(), trace_fields["span_end"].long(),
        trace_fields["out_vec"].long(), trace_fields["out_frames"].long(),
        trace_fields["out_attn"].long(), trace_fields["out_attn_b"].long(),
    ], dim=-1).to(torch.int32).contiguous()                  # [B, T, NSF]

    # ---- temporal band matrices (hoisted; tiny) -------------------------
    tmp = mods["temporal"]
    if cfg.conv_temporal:
        def bands(w):
            return torch.stack([
                conv1d_same_matrix(ww.float(), F).T for ww in w
            ]).to(dt)

        t1m, t2m, t3m = (bands(tmp["c1_w"]), bands(tmp["c2_w"]),
                         bands(tmp["c3_w"]))
        tb1, tb2, tb3 = (
            tmp[k][:, None, None].expand(3, 1, F).to(dt)
            for k in ("c1_b", "c2_b", "c3_b")
        )
    else:
        t1m, t2m, t3m = (tmp["l1_w"].to(dt), tmp["l2_w"].to(dt),
                         tmp["l3_w"].to(dt))
        tb1, tb2, tb3 = (tmp[k][:, None, :].to(dt)
                         for k in ("l1_b", "l2_b", "l3_b"))

    if aux_vec is None:
        aux_vec = torch.zeros((B, T, H), dtype=dt, device=dev)

    ffw = mods["filterframe"]["attn_w"].to(dt)               # [2H, 1]
    flw = mods["filter"]["attn_w"].to(dt)                    # [2H, 1]
    fsoft = cfg.filter_attention == "softmax"

    def row(x):
        return torch.as_tensor(x).to(dt).reshape(1, -1)

    args = (
        scal,
        vf_a, vf_b,
        video_mask.to(dt).reshape(B, 1, F),
        tok_a, tok_b,
        token_mask.to(dt).reshape(B, 1, L),
        aux_vec.to(dt),
        tables["w1u"], tables["b1u"][:, None, :],
        tables["w2u"], tables["b2u"][:, None, :],
        tables["w2t"], tables["b2t"][:, None, :],
        tables["dense3"][0], row(tables["db3"][0]),
        mods["compare"]["w"].to(dt), row(mods["compare"]["b"]),
        mods["equals"]["w"].to(dt), row(mods["equals"]["b"]),
        mods["xor"]["w"].to(dt), row(mods["xor"]["b"]),
        mods["query"]["l1"]["w"].to(dt), row(mods["query"]["l1"]["b"]),
        mods["toaction"]["l1"]["w"].to(dt),
        row(mods["toaction"]["l1"]["b"]),
        mods["toaction"]["l2"]["w"].to(dt),
        row(mods["toaction"]["l2"]["b"]),
        mods["exists"]["l1"]["w"].to(dt), row(mods["exists"]["l1"]["b"]),
        mods["exists"]["l2"]["w"].to(dt), row(mods["exists"]["l2"]["b"]),
        mods["superlative"]["dense"]["w"].to(dt),
        row(mods["superlative"]["dense"]["b"]),
        ffw[:H], ffw[H:],
        row(mods["filterframe"]["attn_b"]).reshape(1, 1),
        flw[:H], flw[H:],
        row(mods["filter"]["attn_b"]).reshape(1, 1),
        row(tmp["ln"]["scale"]), row(tmp["ln"]["bias"]),
        row(mods["relate"]["beta"][:F]),
        t1m, t2m, t3m, tb1, tb2, tb3,
    )
    args = tuple(a.contiguous() for a in args)
    meta = (B, T, Nv, Nf, Na, F, H, Hh, L, dt, fsoft)
    return meta, args


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def mega_exec_reference(meta, args, rate=0.0, seed=None, files=None):
    """Eager executor over ``prepare_args`` output, batched over B.

    Values are carried in float32 holding compute-dtype numbers; ``rd``
    rounds to the compute dtype exactly where the JAX kernel casts, and
    every matmul multiplies compute-dtype values with float32 accumulation
    (``preferred_element_type=f32``). Returns ``(rv, rf, ra)`` in dt.

    With ``seed`` (two ints) and ``rate`` > 0 it is the training forward:
    ``hash_keep`` dropout at the JAX kernel's sites 0-7. It is
    differentiable (the plain version of the backward kernel is autograd
    through it): ``|x|`` has slope +1 at 0 and ``min`` splits ties, as in
    JAX. Register writes are gradient-transparent (``put``): every step
    that writes a slot receives the cotangent of the slot's final value,
    as the JAX backward kernel gives it by reading the final cotangent
    files of an SSA machine. That differs from plain autodiff only for
    slots written more than once: the scratch slots, which take the zero
    writes and Localize's second score row when it has one keyword.

    With ``files`` (a forward's final ``(rv, rf, ra)``) every register read
    takes its value from ``files`` and passes its cotangent to the slot it
    read, as the backward kernel reads the saved files: autograd through
    it is the VJP at that forward's values. Given this function's own
    output, the values and gradients are the same as without ``files``.
    """
    B, T, Nv, Nf, Na, F, H, Hh, L, dt, fsoft = meta
    dev = args[0].device
    if dev.type == "cuda":
        exact_f32()
    a = dict(zip(ARG_NAMES, (x if x.dtype == torch.int32 else x.float()
                             for x in args)))
    scal = a["scal"].long()

    def rd(x):
        return x.to(dt).float()

    def lin_dt(x, w, b):
        return rd(rd(rd(x) @ w) + b)

    relu = torch.relu
    vm = a["vm"][:, 0]                                       # [B, F]
    vmask_b = vm > 0
    w2t, b2t = a["w2t"], a["b2t"][:, 0]
    ar = torch.arange(B, device=dev)

    rv = torch.zeros(B, Nv, H, device=dev)
    ra = torch.zeros(B, Na, F, device=dev)
    rf = torch.zeros(B, Nf, F, H, device=dev)
    feat = torch.zeros(B, F, H, device=dev)
    video = torch.cat([a["vf_a"], a["vf_b"]], dim=-1)
    rf[:, 0] = rd(video * vm[:, :, None])

    def loc_cos(kw, featf, vmr):
        """kw [n, H] vs feat [n, F, H] -> [n, F] rescaled cosine scores."""
        cos_k = rd(cosine_matrix(kw[:, None, :], featf)[:, 0])
        return (cos_k + 1.0) * 0.49 * vmr

    def superlative(scores, actions, amask, mode_r, vmr):
        """scores [n, K, F], actions [n, K, H], amask [n, K] -> [n, H]."""
        row = (scores * vmr[:, None, :]).sum(-1)            # [n, K]
        w = masked_softmax(row, amask)
        w = torch.where(mode_r[:, None] == 1, 1.0 - w, w)
        w = torch.where(amask, w, torch.zeros_like(w))
        pooled = (w[:, :, None] * actions).sum(1)
        return relu(lin_dt(pooled, a["supw"], a["supb"][0]))

    def put(file, rows, idx, val):
        old = file[rows, idx]
        file[rows, idx] = val + (old - old.detach())

    given = None if files is None else [f.float() for f in files]

    def read(file, k, rows, idx):
        """Register read of ``file`` (``given[k]``'s value with ``files``)."""
        x = file[rows, idx]
        return x if given is None else given[k][rows, idx] + (x - x.detach())

    def rows_of(mask):
        return torch.nonzero(mask).flatten()

    drop_on, s0, s1, _, _ = dropout_params(rate, seed)

    def drop(x, r, t, site):
        """x [n, rows, cols] or [n, cols] (one row) of examples r."""
        if not drop_on:
            return x
        shape = tuple(x.shape[1:]) if x.dim() == 3 else (1, x.shape[-1])
        m = hash_keep(shape, r, t, site, s0, s1, rate, dev)
        return x * (m if x.dim() == 3 else m[:, 0])

    pos = torch.arange(L, device=dev)
    for t in range(T):
        s = scal[:, t]
        op, e1, mode, count = s[:, F_OP], s[:, F_E1], s[:, F_MODE], \
            s[:, F_COUNT]
        va = read(rv, 0, ar, s[:, F_VA])
        vb = read(rv, 0, ar, s[:, F_VB])
        aa = read(ra, 2, ar, s[:, F_AA])
        ab = read(ra, 2, ar, s[:, F_AB])
        fa = read(rf, 1, ar, s[:, F_FA])
        is_filter = (op >= int(Opcode.FILTER_V)) & (
            op <= int(Opcode.FILTERFRAME_K))

        put(ra, ar, s[:, F_OUT_A], 0.0)
        put(ra, ar, s[:, F_OUT_AB], 0.0)

        # ---- stage 1: expert two-layer frames MLP (null expert 9) ------
        for e in torch.unique(e1).tolist():
            if e == 9:
                continue
            r = rows_of(e1 == e)
            h = rd(drop(relu(fa[r] @ a["w1u"][e] + a["b1u"][e]), r, t, 0))
            h2 = h @ a["w2u"][e] + a["b2u"][e]
            feat[r] = rd(torch.where(is_filter[r, None, None],
                                     drop(relu(h2), r, t, 1), h2))

        nv = torch.zeros(B, H, device=dev)

        def on(*codes):
            m = torch.zeros_like(op, dtype=torch.bool)
            for c in codes:
                m |= op == int(c)
            return rows_of(m)

        r = on(Opcode.PUSH_TEXT)
        if r.numel():
            ss, se = s[r, F_SS], s[r, F_SE]
            valid = (a["tm"][r, 0] > 0).float()
            in_span = ((pos[None] >= ss[:, None])
                       & (pos[None] < se[:, None])).float()
            span_w = torch.where(ss[:, None] < 0, valid, in_span * valid)
            pa = (span_w[:, None, :] @ a["tok_a"][r])[:, 0]
            pb = (span_w[:, None, :] @ a["tok_b"][r])[:, 0]
            push = torch.cat([pa, pb], -1) / torch.clamp(
                span_w.sum(-1, keepdim=True), min=1.0)
            aux_row = a["aux"][r, t]
            nv[r] = rd(torch.where(ss[:, None] == -2, aux_row, push))

        r = on(Opcode.AND_VEC)
        if r.numel():
            nv[r] = torch.minimum(va[r], vb[r])

        r = on(Opcode.CHOOSE)
        if r.numel():
            vc = read(rv, 0, r, s[r, F_VC])
            first = cosine(va[r], vc) > cosine(vb[r], vc)
            nv[r] = torch.where(first[:, None], va[r], vb[r])

        for code, w, b in ((Opcode.COMPARE, "cw", "cb"),
                           (Opcode.EQUALS, "eqw", "eqb")):
            r = on(code)
            if r.numel():
                y = va[r] @ a[w][:H] + vb[r] @ a[w][H:]
                nv[r] = relu(rd(rd(y) + a[b][0]))

        r = on(Opcode.XOR)
        if r.numel():
            d = rd(abs_jax(va[r] - vb[r]))
            xw = a["xw"]
            y = d @ xw[:H] + va[r] @ xw[H:2 * H] + vb[r] @ xw[2 * H:]
            nv[r] = relu(rd(rd(y) + a["xb"][0]))

        r = on(Opcode.QUERY)
        if r.numel():
            nv[r] = drop(relu(lin_dt(va[r], a["qw"], a["qb"][0])), r, t, 4)

        r = on(Opcode.TOACTION)
        if r.numel():
            y = va[r] @ a["taw1"][:H] + vb[r] @ a["taw1"][H:]
            h = rd(drop(relu(rd(rd(y) + a["tab1"][0])), r, t, 5))
            nv[r] = relu(lin_dt(h, a["taw2"], a["tab2"][0]))

        r = on(Opcode.EXISTS)
        if r.numel():
            prod = rd(vb[r] * va[r])
            w1 = a["exw1"]
            y = vb[r] @ w1[:H] + va[r] @ w1[H:2 * H] + prod @ w1[2 * H:]
            h = rd(drop(relu(rd(rd(y) + a["exb1"][0])), r, t, 6))
            nv[r] = drop(relu(lin_dt(h, a["exw2"], a["exb2"][0])), r, t, 7)

        r = on(Opcode.FILTER_V, Opcode.FILTER_K)
        if r.numel():
            fr, vmr = feat[r], vm[r]
            if fsoft:
                logits = (fr @ a["fltw"])[:, :, 0]
                kb = (va[r] @ a["fltk"])[:, 0] + a["fltb"][0, 0]
                soft = masked_softmax(logits + kb[:, None], vmask_b[r])
                w = torch.where(op[r, None] == int(Opcode.FILTER_V), soft,
                                vmr)
            else:
                w = vmr
            pooled = (fr * (w * vmr)[:, :, None]).sum(1)
            nv[r] = relu(lin_dt(pooled, a["fdw"], a["fdb"][0]))

        r = on(Opcode.SUPERLATIVE_V)
        if r.numel():
            fr, vmr = feat[r], vm[r]
            ka = lin_dt(va[r], w2t[2], b2t[2])
            kb = lin_dt(vb[r], w2t[2], b2t[2])
            scores = torch.stack(
                [loc_cos(ka, fr, vmr), loc_cos(kb, fr, vmr)], 1)
            actions = torch.stack([va[r], vb[r]], 1)
            amask = torch.arange(2, device=dev)[None] < count[r, None]
            nv[r] = superlative(scores, actions, amask, mode[r], vmr)

        r = on(Opcode.SUPERLATIVE_F)
        if r.numel():
            fr, vmr = feat[r], vm[r]
            fb = read(rf, 1, r, s[r, F_FB])
            kf = lin_dt(fb, w2t[2], b2t[2])                  # [n, F, H]
            cosm = rd(cosine_matrix(kf, fr))                 # [n, F, F]
            scores = (cosm + 1.0) * 0.49 * vmr[:, None, :]
            nv[r] = superlative(scores, fb, vmr > 0, mode[r], vmr)

        put(rv, ar, s[:, F_OUT_V], rd(nv))

        # ---- frames producers -------------------------------------------
        r = on(Opcode.FILTERFRAME_V, Opcode.FILTERFRAME_K)
        if r.numel():
            fr, vmr = feat[r], vm[r]
            gk = (va[r] @ a["ffkw"])[:, 0] + a["ffab"][0, 0]
            glog = (fr @ a["ffwf"])[:, :, 0]
            gate = torch.where(op[r, None] == int(Opcode.FILTERFRAME_V),
                               torch.sigmoid(glog + gk[:, None]),
                               torch.ones_like(glog))
            x2 = rd(gate[:, :, None] * fr)
            y2 = x2 @ w2t[0] + b2t[0]
            put(rf, r, s[r, F_OUT_F],
                rd(drop(relu(y2), r, t, 2) * vmr[:, :, None]))

        r = on(Opcode.TEMPORAL)
        if r.numel():
            vmr, md = vm[r], mode[r]
            am = torch.where(count[r, None] == 2, (aa[r] + ab[r]) * 0.5,
                             aa[r])
            midx = torch.clamp(md - 1, min=0)
            amd = rd(am)[:, None, :]
            h1 = rd(relu(amd @ a["t1"][midx] + a["tb1"][midx]))
            h2 = rd(relu(h1 @ a["t2"][midx] + a["tb2"][midx]))
            g = torch.sigmoid(h2 @ a["t3"][midx] + a["tb3"][midx])[:, 0]
            related = torch.where(md[:, None] == 0, am, g) * vmr
            x2 = rd(related[:, :, None] * fa[r])
            ry = drop(relu(x2 @ w2t[1] + b2t[1]), r, t, 2)
            ln = layer_norm({"scale": a["lns"][0], "bias": a["lnb"][0]}, ry)
            put(rf, r, s[r, F_OUT_F], rd(ln))
            put(ra, r, s[r, F_OUT_AB], rd(related))

        r = on(Opcode.ATTNVIDEO)
        if r.numel():
            put(rf, r, s[r, F_OUT_F], rd(aa[r][:, :, None] * fa[r]))

        # ---- attn producers ---------------------------------------------
        r = on(Opcode.AND_ATTN, Opcode.XORFRAME)
        if r.numel():
            v = torch.where(op[r, None] == int(Opcode.AND_ATTN),
                            torch.minimum(aa[r], ab[r]),
                            abs_jax(aa[r] - ab[r]))
            put(ra, r, s[r, F_OUT_A], rd(v))

        r = on(Opcode.HASITEM)
        if r.numel():
            hv = drop(torch.sigmoid(feat[r][:, :, 0]), r, t, 3)
            put(ra, r, s[r, F_OUT_A], rd(hv * vm[r]))

        r = on(Opcode.EXISTSFRAME)
        if r.numel():
            cos = cosine(fa[r], va[r][:, None, :])
            put(ra, r, s[r, F_OUT_A], rd((cos + 1.0) * 0.49 * vm[r]))

        r = on(Opcode.RELATE)
        if r.numel():
            beta = a["beta"][0]
            shifted = torch.where(mode[r, None] == 1, aa[r] - beta,
                                  aa[r] + beta)
            put(ra, r, s[r, F_OUT_A],
                rd(masked_softmax(shifted, vmask_b[r])))

        r = on(Opcode.LOCALIZE)
        if r.numel():
            fr, vmr = feat[r], vm[r]
            ka = lin_dt(va[r], w2t[2], b2t[2])
            kb = lin_dt(vb[r], w2t[2], b2t[2])
            put(ra, r, s[r, F_OUT_A], rd(loc_cos(ka, fr, vmr)))
            put(ra, r, s[r, F_OUT_AB], rd(loc_cos(kb, fr, vmr)))

    return rv.to(dt), rf.to(dt), ra.to(dt)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

#: largest H, F and L the executor kernels' per-block arrays hold, read
#: from their one home, ``csrc/mega_limits.cuh``
_LIMITS = _build.header_ints("mega_limits.cuh")
MAX_H, MAX_F, MAX_L = _LIMITS["MAX_H"], _LIMITS["MAX_F"], _LIMITS["MAX_L"]


def _arg_shapes(B, T, F, H, Hh, L):
    """The shape of every ``prepare_args`` tensor, in ``ARG_NAMES`` order."""
    row, col, one = (1, H), (H, 1), (1, 1)
    sq, w2, w3 = (H, H), (2 * H, H), (3 * H, H)
    return (
        (B, T, NSF), (B, F, Hh), (B, F, Hh), (B, 1, F), (B, L, Hh),
        (B, L, Hh), (B, 1, L), (B, T, H),
        (11, H, H), (11, 1, H), (11, H, H), (11, 1, H), (4, H, H),
        (4, 1, H), sq, row,
        w2, row, w2, row, w3, row, sq, row,
        w2, row, sq, row, w3, row, sq, row,
        sq, row, col, col, one, col, col, one,
        row, row, (1, F), (3, F, F), (3, F, F), (3, F, F), (3, 1, F),
        (3, 1, F), (3, 1, F),
    )


def check_args(key, meta, args):
    """Raise unless the executor kernels take ``args``; returns the
    device."""
    B, T, Nv, Nf, Na, F, H, Hh, L, dt, fsoft = meta
    dev = args[0].device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{key} kernel: unsupported dtype {dt}")
    if (H != 2 * Hh or not (2 <= H <= MAX_H) or not (1 <= F <= MAX_F)
            or not (1 <= L <= MAX_L)):
        raise ValueError(f"{key} kernel: H={H} (even, <= {MAX_H}), "
                         f"F={F} (<= {MAX_F}), L={L} (<= {MAX_L})")
    if len(args) != len(ARG_NAMES):
        raise ValueError(f"{key}: wrong argument count")
    for name, x, shape in zip(ARG_NAMES, args,
                              _arg_shapes(B, T, F, H, Hh, L)):
        _build.check_tensor(f"{key} {name}", x,
                            torch.int32 if name == "scal" else dt, shape,
                            dev)
    return dev


def mega_exec_call(meta, args, cluster=None):
    """Executor over prepared args: plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (or an error). Returns (rv, rf, ra) in dt.
    ``cluster`` forces the CTAs of an example's cluster on the "fma32"
    route (``fma32_cluster``) or the tensor-core route
    (``tc_cluster``: 2 or more run the row-slice mode at any F);
    None: the launch's pick."""
    if _build.on_cpu("mega_exec", args[0]):
        return mega_exec_reference(meta, args)
    return _launch("mega_exec", meta, args, dropout_params(0.0, None),
                   cluster)


def mega_exec_train_call(meta, args, rate, seed, cluster=None):
    """Training forward (TPU kernel #5): ``mega_exec_call`` with
    ``hash_keep`` dropout at ``rate`` keyed on ``seed`` (two int32 values).
    Plain version for CPU tensors; for CUDA tensors the kernel on the route
    ``fwd_route(dt, H, F, True)`` picks (``mega_exec_tc_kernel<true>``,
    launch key ``mega_exec_train_tc``; ``mega_exec_kernel<float, true>``,
    ``mega_exec_train_fma32``; on the cluster size ``cluster`` forces or the
    launch picks, both; or ``mega_exec_kernel``, ``mega_exec_train``). Hand the
    backward this call's register files: its walk on the same route
    recomputes them bit for bit."""
    if _build.on_cpu("mega_exec_train", args[0]):
        return mega_exec_reference(meta, args, rate=rate, seed=seed)
    return _launch("mega_exec_train", meta, args, dropout_params(rate, seed),
                   cluster)


#: the tensor-core route's limits (``csrc/mega_limits.cuh``): its largest H,
#: the frame rows a CTA's bf16 tiles hold, its smallest and largest F
TC_MAX_H, TC_MAX_F = _LIMITS["TC_MAX_H"], _LIMITS["TC_MAX_F"]
TC_MIN_F, TC_ROUTE_MAX_F = _LIMITS["TC_MIN_F"], _LIMITS["TC_ROUTE_MAX_F"]
#: the CUDA sources' tiles that size the tensor-core route's shared memory
_TILES = _build.header_ints("mega_common.cuh")
SMEM_MAX = 232448   # bytes a block may use on an H100 (227 KB)


def tc_shape(H, F) -> bool:
    """True where a CTA's bf16 tiles hold the whole example: H a multiple
    of 64 in [64, TC_MAX_H], F a multiple of 16 in [16, TC_MAX_F] (whole
    mma tiles in shared memory). The executor forward's tensor-core route
    and the step kernel's (#10) run one CTA an example or tile there, and
    the row-slice mode at the other widths ``tc_route_shape`` takes."""
    return (H % 64 == 0 and 64 <= H <= TC_MAX_H and F % 16 == 0
            and 16 <= F <= TC_MAX_F)


def tc_route_shape(H, F) -> bool:
    """True where the executor's tensor-core kernels (#4-#6) take the
    widths: H a multiple of 64 in [64, TC_MAX_H], any F in [TC_MIN_F,
    TC_ROUTE_MAX_F] (16 to 256; the NMN CLIs' default F 150 too): at the
    widths ``tc_shape`` takes one CTA an example, elsewhere the row-slice
    mode (``tc_sliced``)."""
    return (H % 64 == 0 and 64 <= H <= TC_MAX_H
            and TC_MIN_F <= F <= TC_ROUTE_MAX_F)


def tc_sliced(F, cluster=None) -> bool:
    """Whether the tensor-core forward and walk run an example in the
    row-slice mode (``csrc/mega_exec.cu launch_tc``): where the shared
    tiles cannot hold F (above TC_MAX_F or not a multiple of 16) or a
    cluster of 2 or more is forced. The walk takes the forward's mode and
    cluster."""
    return (cluster or 0) > 1 or F % 16 != 0 or F > TC_MAX_F


def tc_slice_count(F) -> int:
    """Slices of TC_MAX_F frame rows at F frames (F 150: 3)."""
    return -(-F // TC_MAX_F)


def tc_cluster(B, F, slots) -> int:
    """CTAs of one example's thread-block cluster in the row-slice mode for a
    launch of ``B`` examples at ``F`` frames on a card of ``slots`` CTA
    slots, as ``csrc/mega_common.cuh tc_cluster`` computes it in the
    launch: one CTA a slice while ``B`` such clusters fit one wave of
    slots, else 2 while ``B`` clusters of 2 do, else one CTA an example
    (the forward and the walk alike, each over its own slots: one CTA an
    SM). On an H100 (132 slots) at F 150: B 32 takes 3, B 64 2, B 128 1."""
    most = tc_slice_count(F)
    if B * most <= slots:
        return most
    return 2 if most > 2 and 2 * B <= slots else 1


def tc_cta_rows(F, C) -> int:
    """Frame rows of each CTA of a cluster of ``C`` in the row-slice mode
    (``csrc/mega_common.cuh tc_cta_rows``: ceil(F / C) rounded up to whole
    16-row mma tiles; the last CTA's rows end at F)."""
    return (-(-F // C) + 15) & ~15


def tc_slots(F, H, L) -> int:
    """CTA slots of the row-slice mode's forward at ``(F, H, L)`` on the
    current card (its SMs x the kernel's CTAs an SM), as its launch reads
    them."""
    slots = _build.build().stair_mega_exec_tc_slots(F, H, L)
    if slots < 1:
        raise RuntimeError(f"tc_slots: F {F} H {H} L {L} failed")
    return slots


def tc_launch_cluster(B, F, H, L=None, walk=False) -> int:
    """The cluster size a tensor-core launch of ``B`` examples at ``(F, H,
    L)`` (``L`` the question length; None: at most H) takes on the current
    card, as the library computes it: one CTA where the shared tiles hold
    F, else ``tc_cluster`` over the card's slots (the forward's, or with
    ``walk`` the walk's)."""
    if not tc_sliced(F):
        return 1
    lib = _build.build()
    C = (lib.stair_mega_exec_bwd_tc_cluster(B, F, H) if walk
         else lib.stair_mega_exec_tc_cluster(B, F, H, L or H))
    if C < 1:
        raise RuntimeError(f"tc_launch_cluster: B {B} F {F} H {H} failed")
    return C


#: the float32 "fma32" route's limits (``csrc/mega_limits.cuh``)
FMA32_MAX_H, FMA32_MIN_F, FMA32_MAX_F = (
    _LIMITS["FMA32_MAX_H"], _LIMITS["FMA32_MIN_F"], _LIMITS["FMA32_MAX_F"])


def fma32_shape(H, F) -> bool:
    """True where the executor's float32 "fma32" kernels take the widths:
    H a multiple of ``gemm32``'s column tile ``G32_BN`` (128) in [G32_BN,
    FMA32_MAX_H], any F in [FMA32_MIN_F, FMA32_MAX_F] (16 to 256: ``gemm32``
    walks the frames in row tiles of ``G32_BM``, the last one ragged)."""
    bn = _TILES["G32_BN"]
    return (H % bn == 0 and bn <= H <= FMA32_MAX_H
            and FMA32_MIN_F <= F <= FMA32_MAX_F)


def fma32_cluster(B, H, slots, fit_2, fit_h) -> int:
    """CTAs of one example's thread-block cluster on the "fma32" route (the
    forward ``mega_exec_kernel<float, true>`` and the walk
    ``mega_bwd_kernel<float, true>`` alike) for a launch of ``B`` examples
    at width ``H`` on a card with ``slots`` CTA slots (its SMs x the
    kernel's CTAs an SM: one), as ``csrc/mega_common.cuh mega32_cluster``
    computes it in the launch: ``H / G32_BN`` (one CTA a column tile of
    ``gemm32``) while ``B`` such clusters fill at most one wave of slots,
    else 2 while ``B`` clusters of 2 do, else one CTA an example; a size
    only where its clusters fit the card at all (``fit_h``, ``fit_2``:
    ``fma32_fit`` at ``H / G32_BN`` and at 2, 0 where the size is not a
    candidate: 2 must be a proper divisor of ``H / G32_BN``). Each CTA
    computes its columns of every ``[F, H]``-sized product; the files are
    the one-CTA route's bit for bit at every size."""
    most = H // _TILES["G32_BN"]
    if fit_h > 0 and B * most <= slots:
        return most
    return 2 if fit_2 > 0 and 2 * B <= slots else 1


def fma32_fit(c, F=None, H=None) -> int:
    """Clusters of ``c`` CTAs that fit the current card at once
    (``cudaOccupancyMaxActiveClusters``): of the forward
    ``mega_exec_kernel<float, true>``, or with ``F`` and ``H`` of the walk
    ``mega_bwd_kernel<float, true>`` at those widths (its shared memory
    grows with them); ``c`` 1 gives the card's CTA slots."""
    lib = _build.build()
    fit = (lib.stair_mega_exec_fma32_fit(c) if F is None
           else lib.stair_mega_exec_bwd_fma32_fit(F, H, c))
    if fit < 0:
        raise RuntimeError(f"fma32_fit: cudaOccupancyMaxActiveClusters at "
                           f"cluster {c} failed")
    return fit


def fma32_launch_cluster(B, H, F=None) -> int:
    """The cluster size the "fma32" launch picks for ``B`` examples at
    width ``H`` on the current card, as the library computes it (the
    forward's, or with ``F`` the walk's)."""
    lib = _build.build()
    C = (lib.stair_mega_exec_fma32_cluster(B, H) if F is None
         else lib.stair_mega_exec_bwd_fma32_cluster(B, F, H))
    if C < 1:
        raise RuntimeError(f"fma32_launch_cluster: B {B} H {H} F {F} failed")
    return C


def fwd_route(dtype, H, F, drop) -> str:
    """The forward's kernel route, chosen before any launch: ``"tc"``
    (``mega_exec_tc_kernel``: bf16 at the widths ``tc_route_shape`` takes;
    eval, launch key ``mega_exec_tc``, or the training forward with
    dropout, ``drop`` true, ``mega_exec_train_tc``), ``"fma32"``
    (``mega_exec_kernel<float, true>``: float32 at the widths
    ``fma32_shape`` takes, its products on ``gemm32``; ``mega_exec_fma32``,
    ``mega_exec_train_fma32``; its files equal the general route's bit for
    bit) or ``"general"`` (``mega_exec_kernel``: every other dtype and
    width; ``mega_exec``, ``mega_exec_train``). The training forward's route
    is also the backward's (``mega_grad.bwd_route``): each route's walk
    recomputes its own forward's values bit for bit."""
    if dtype == torch.bfloat16 and tc_route_shape(H, F):
        return "tc"
    if dtype == torch.float32 and fma32_shape(H, F):
        return "fma32"
    return "general"


def fma32_smem_bytes() -> int:
    """Shared memory of ``mega_exec_kernel<float, true>`` per block, as
    ``csrc/mega_exec.cu FMA32_SMEM_BYTES`` computes it (the same at every
    width): the static ``SmemT<true>`` (six float vectors of ``MAX_H``, six
    of ``MAX_F``, one row of ``gemm``'s two tiles, the reduction slots, the
    instruction row) and ``gemm32``'s ring in dynamic shared memory (its
    stages of the A tile and of B as stored)."""
    t = _TILES
    static = 4 * (6 * MAX_H + 6 * MAX_F + t["BM"] + 1 + t["BN"]
                  + t["THREADS"] // 32 + t["NSF"])
    stage = (t["G32_BM"] * (t["G32_BK"] + t["G32_PAD"])
             + t["G32_BK"] * t["G32_BN"])
    return static + 4 * t["G32_STAGES"] * stage


def tc_smem_bytes(F, H, L) -> int:
    """Dynamic shared memory of ``mega_exec_tc_kernel`` per block (eval and
    training alike), as ``csrc/mega_exec.cu tc_smem_bytes`` computes it:
    two ``[F, H + 8]`` bf16 tiles, the weight ring, six float vectors of
    ``max(H, L)``, the vec products' partials, six ``[F]`` vectors."""
    t = _TILES
    V = (max(H, L) + 3) & ~3
    stage = t["FWD_BN"] * (t["TC_BK"] + t["TC_PAD"])
    return (2 * F * (H + t["TC_PAD"]) * 2 + t["TC_STAGES"] * stage * 2
            + (6 * V + t["THREADS"] * 8 + 6 * F + t["THREADS"] // 32) * 4)


def tc_slice_rows(F) -> int:
    """Rows of the row-slice mode's staging tile (``csrc/mega_common.cuh
    tc_slice_rows``): F in whole 16-row mma tiles, at most TC_MAX_F."""
    return min((F + 15) & ~15, TC_MAX_F)


def tc_sliced_smem_bytes(F, H, L) -> int:
    """Dynamic shared memory of ``mega_exec_tc_kernel`` per CTA in the
    row-slice mode, as ``csrc/mega_exec.cu tc_sliced_smem_bytes`` computes
    it: ``tc_smem_bytes`` with one staging tile of ``tc_slice_rows(F)``
    rows in place of the two ``[F, H + 8]`` tiles (which live in the
    workspace)."""
    return (tc_smem_bytes(F, H, L)
            - (2 * F - tc_slice_rows(F)) * (H + _TILES["TC_PAD"]) * 2)


def _launch(key, meta, args, drop, cluster=None):
    B, T, Nv, Nf, Na, F, H, Hh, L, dt, fsoft = meta
    dev = check_args(key, meta, args)
    rv = torch.empty(B, Nv, H, dtype=dt, device=dev)
    rf = torch.empty(B, Nf, F, H, dtype=dt, device=dev)
    ra = torch.empty(B, Na, F, dtype=dt, device=dev)
    if B == 0:
        return rv, rf, ra
    lib = _build.build()
    train = key == "mega_exec_train"
    route = fwd_route(dt, H, F, train)
    used = ctypes.c_int(0)
    if route == "tc":
        # float32 [F, H] workspace: SUPF's keyword rows, TEMPORAL's pre-LN
        # rows; in the row-slice mode then the hidden and feat tiles (bf16
        # [F, H + 8] each), else in shared memory
        pad = _TILES["TC_PAD"]
        ws = torch.empty(B, F, 2 * H + pad if tc_sliced(F, cluster) else H,
                         dtype=torch.float32, device=dev)
        common = (_build.pointers(args), len(args),
                  rv.data_ptr(), rf.data_ptr(), ra.data_ptr(), ws.data_ptr(),
                  B, T, Nv, Nf, Na, F, H, L, int(bool(fsoft)))
        more = (int(cluster or 0), ctypes.byref(used), _build.stream_ptr(dev))
        if train:
            key = "mega_exec_train_tc"
            err = lib.stair_mega_exec_fwd_tc_train(*common, *drop, *more)
        else:
            key = "mega_exec_tc"
            err = lib.stair_mega_exec_fwd_tc(*common, *more)
    elif route == "fma32":
        # the general route's workspace: gemm32 gives gemm's bits, and the
        # kernel is mega_exec_kernel with gemm32's ring in shared memory
        ws = torch.empty(B, 3, F, H, dtype=torch.float32, device=dev)
        key = "mega_exec_train_fma32" if train else "mega_exec_fma32"
        err = lib.stair_mega_exec_fwd_fma32(
            _build.pointers(args), len(args),
            rv.data_ptr(), rf.data_ptr(), ra.data_ptr(), ws.data_ptr(),
            B, T, Nv, Nf, Na, F, H, L, int(bool(fsoft)), *drop,
            int(cluster or 0), ctypes.byref(used), _build.stream_ptr(dev))
    else:
        # Per-example float32 workspace: stage-1 hidden / GEMM operand
        # tile, the feat tile (persists across steps), and the temporal
        # pre-LN rows.
        ws = torch.empty(B, 3, F, H, dtype=torch.float32, device=dev)
        err = lib.stair_mega_exec_fwd(
            _build.pointers(args), len(args),
            rv.data_ptr(), rf.data_ptr(), ra.data_ptr(), ws.data_ptr(),
            B, T, Nv, Nf, Na, F, H, L,
            int(dt == torch.bfloat16), int(bool(fsoft)), *drop,
            _build.stream_ptr(dev),
        )
    _build.check(err, key)
    _build.LAUNCHES[key] += 1
    if route != "general":
        _build.CLUSTERS[key][used.value] += 1
    return rv, rf, ra


def mega_exec(cfg, mods, tables, trace_fields, video_halves, video_mask,
              token_halves, token_mask, aux_vec=None):
    """Run the whole executor over a batch; returns the three final
    register files (rv [B, Nv+1, H], rf [B, Nf+1, F, H], ra [B, Na+1, F])
    in the compute dtype."""
    meta, args = prepare_args(
        cfg, mods, tables, trace_fields, video_halves, video_mask,
        token_halves, token_mask, aux_vec=aux_vec,
    )
    return mega_exec_call(meta, args)
