"""The executor's training path (port of ``stair_tpu/ops/mega_grad.py``).

``mega_exec_train`` runs the executor forward with counter-hash dropout
(``mega_exec.mega_exec_train_call``, TPU kernel #5) inside
``MegaExecTrain``, a ``torch.autograd.Function`` over ``prepare_args``'
tuple, whose backward is ``mega_exec_bwd_call`` (TPU kernel #6). As in the
JAX package, ``prepare_args`` (the casts to the compute dtype, the fused
expert tables, the temporal band matrices) stays outside the Function, so
the weight gradients reach the float32 master parameters through ordinary
autograd.

``mega_exec_bwd_call`` is the kernel wrapper: for CPU tensors it runs the
plain version ``mega_exec_bwd_reference`` (torch autograd through the plain
training forward ``mega_exec_reference``); for CUDA tensors it launches
the reverse walk, then the weight gradient reduction, on the route
``bwd_route`` picks before the launch, or raises: the tensor-core route
(``csrc/mega_grad_tc.cu``, launch keys ``mega_exec_bwd_tc``,
``mega_exec_wgrad_tc``) for bf16 at the widths it takes, the "fma32" route
(``csrc/mega_grad.cu``'s walk on ``gemm32``, an example on a thread-block
cluster while one CTA an example under-fills the card, and its
register-blocked weight gradients, ``mega_exec_bwd_fma32``,
``mega_exec_wgrad_fma32``) for float32 at the widths it takes, the general route (``csrc/mega_grad.cu``,
``mega_exec_bwd``, ``mega_exec_wgrad``) otherwise. ``bwd_route`` is the
training forward's route
(``mega_exec.fwd_route``): each walk recomputes the forward values it needs
(relu masks, bf16 roundings) with its own forward's product code, bit for
bit, so it is handed the register files of the forward on its route.
Cotangents enter cast to the compute dtype; weight gradients leave in
float32 and the Function casts them to each argument's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import mega_exec as TX

#: args-tuple layout: 8 data entries then the weights. Gradients are owed
#: for DATA_GRAD_IDX (vf_a, vf_b, tok_a, tok_b, aux) and every weight.
N_DATA = 8
DATA_GRAD_IDX = (1, 2, 4, 5, 7)
NSLOT = 5

#: record tables of the reduction launch: (ARG_NAMES of weight and bias,
#: experts, input rows as a multiple of H), in mega_grad.cu's order, and
#: the record slot of each (``TB_SLOT``: slots 0-2 hold [F, H] rows, 3-4 one
#: row)
TABLES = (
    ("w1u", "b1u", 11, 1), ("w2u", "b2u", 11, 1), ("w2t", "b2t", 4, 1),
    ("fdw", "fdb", 1, 1), ("cw", "cb", 1, 2), ("eqw", "eqb", 1, 2),
    ("xw", "xb", 1, 3), ("qw", "qb", 1, 1), ("taw1", "tab1", 1, 2),
    ("taw2", "tab2", 1, 1), ("exw1", "exb1", 1, 3), ("exw2", "exb2", 1, 1),
    ("supw", "supb", 1, 1),
)
SLOTS = (0, 1, 2, 3, 3, 3, 3, 3, 3, 4, 3, 4, 3)


def wgrad_rows_room(B, T, F) -> int:
    """Rows of the "fma32" weight gradients' index (``csrc/mega_grad.cu
    job_rows``): each job (a table's expert) has room for every record's
    rows, ``F`` in the ``[F, H]`` slots and 1 in the vec slots."""
    return B * T * sum(E * (F if slot <= 2 else 1)
                       for (_, _, E, _), slot in zip(TABLES, SLOTS))


def small_tables(H, F):
    """(name, size) of the small tables in a per-example partial, in
    mega_grad.cu ``Small``'s order."""
    return (("ffwf", H), ("ffkw", H), ("ffab", 1), ("fltw", H), ("fltk", H),
            ("fltb", 1), ("lns", H), ("lnb", H), ("beta", F),
            ("t1", 3 * F * F), ("t2", 3 * F * F), ("t3", 3 * F * F),
            ("tb1", 3 * F), ("tb2", 3 * F), ("tb3", 3 * F))


def workspace_floats(Nv, Nf, Na, F, H, L, T, tc=False):
    """Per-example float32 workspace of the walk (mega_grad.cu ``Ws``, its
    ``[F]``- and ``[F, F]``-sized slots padded to 4 floats so that every
    slot starts on 16 bytes). The tensor-core route adds the float32 dY
    rows of its five record slots and lays its ten ``[F, H]``, two ``[F,
    F]`` and two ``[H]`` slots out at its largest F and H,
    ``TC_ROUTE_MAX_F`` and ``TC_MAX_H`` (``mega_grad_tc.cu``), its ``[Na,
    F]`` slot padded as the others' are."""
    rest = Nv * H + Nf * F * H + L * H + T * H
    if tc:
        F_, H_ = TX.TC_ROUTE_MAX_F, TX.TC_MAX_H
        return 10 * F_ * H_ + 2 * F_ * F_ + 2 * H_ + _pad4(Na * F) + rest
    return rest + _pad4(Na * F) + 7 * F * H + 2 * _pad4(F * F)


def _pad4(n):
    return (n + 3) & ~3


def bwd_route(dtype, H, F) -> str:
    """The backward's kernel route, chosen before any launch: the training
    forward's (``mega_exec.fwd_route(dtype, H, F, True)``), so that the two
    cannot drift apart. ``"tc"`` (``mega_bwd_tc_kernel`` +
    ``mega_wgrad_tc_kernel``: bf16 at the widths ``mega_exec.tc_route_shape``
    takes, above 64 frames on the forward's cluster of frame-row slices; the
    recompute on #5's tensor-core product code, bit for bit
    ``mega_exec_tc_kernel<true>``'s, the bf16 gradient and weight products
    on the tensor cores), ``"fma32"`` (``mega_bwd_kernel<float, true>`` +
    ``mega_wgrad_fma32_kernel``: float32 at the widths
    ``mega_exec.fma32_shape`` takes; the walk's products on ``gemm32``, as
    #5's on that route, and every output bit for bit the general route's)
    or ``"general"`` (``mega_bwd_kernel`` + ``mega_wgrad_kernel``: every
    other dtype and width; the recompute on ``mega_exec_kernel``'s ``gemm``
    and ``vecmat``)."""
    return TX.fwd_route(dtype, H, F, True)


def bwd_smem_bytes(F, H, route) -> int:
    """Dynamic shared memory of the walk per block on ``route``, as
    ``csrc/mega_grad.cu bwd_smem_bytes`` (general and "fma32" routes) or
    ``csrc/mega_grad_tc.cu bwd_smem_floats`` (tensor-core route) computes
    it: NHV ``[H]`` and NFV + 5 ``[F]`` float vectors (at TC_MAX_H and
    TC_ROUTE_MAX_F on the tensor-core route), gemm's tiles; on the
    tensor-core route, 16-byte aligned, the larger of a row slice's bf16
    ``[tc_slice_rows(F), H + 8]`` operand tile with tc_gemm's ring and
    vecmat_tc's partials (``THREADS * 8`` floats); on the "fma32" route 16
    bytes of room to align ``gemm32``'s ring, then the ring at the walk's
    column tile ``G32_WALK_BN`` (its stages of the A tile and of B in the
    larger, transposed layout)."""
    t = TX._TILES
    tc = route == "tc"
    g = _build.header_ints("mega_grad_tc.cu" if tc else "mega_grad.cu")
    SH, SF = (TX.TC_MAX_H, TX.TC_ROUTE_MAX_F) if tc else (H, F)
    n = (g["NHV"] * SH + (g["NFV"] + 5) * SF + t["BK"] * (t["BM"] + 1)
         + t["BK"] * t["BN"] + t["THREADS"] // 32)
    if tc:
        n = (n + 3) & ~3
        stage = t["TC_BN"] * (t["TC_BK"] + t["TC_PAD"])
        n += max((TX.tc_slice_rows(F) * (H + t["TC_PAD"])
                  + t["TC_STAGES"] * stage) // 2, t["THREADS"] * 8)
    if route == "fma32":
        ld = t["G32_BK"] + t["G32_PAD"]
        ring = t["G32_STAGES"] * (t["G32_BM"] + t["G32_WALK_BN"]) * ld
        return 4 * n + 16 + 4 * ring
    return 4 * n


def mega_exec_bwd_reference(meta, args, outs, gouts, rate=0.0, seed=None,
                            at_files=False):
    """The plain backward: torch autograd through ``mega_exec_reference``
    (the training forward, same dropout masks). Returns ``(dvf_a, dvf_b,
    dtok_a, dtok_b, daux)`` in the compute dtype and the weight gradients
    in float32, in ``ARG_NAMES`` order from index ``N_DATA``.

    By default it differentiates through its own forward and reads no
    files. With ``at_files`` every register read takes its value from
    ``outs``, as the kernel walk's recompute does: the VJP at the forward
    that made ``outs``, the same function the kernel computes, so that a
    bf16 step between two forwards' files cannot move a relu's side."""
    dt = meta[9]
    want = list(DATA_GRAD_IDX) + list(range(N_DATA, len(args)))
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(i in want)
                  for i, a in enumerate(args)]
        new = TX.mega_exec_reference(meta, leaves, rate=rate, seed=seed,
                                     files=outs if at_files else None)
        pairs = [(o, g.to(dt)) for o, g in zip(new, gouts)
                 if o.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [leaves[i] for i in want],
            [g for _, g in pairs], allow_unused=True)
    grads = [torch.zeros_like(leaves[i]) if g is None else g
             for i, g in zip(want, grads)]
    data = tuple(g.to(dt) for g in grads[:len(DATA_GRAD_IDX)])
    return data + tuple(g.float() for g in grads[len(DATA_GRAD_IDX):])


def mega_exec_bwd_call(meta, args, outs, gouts, rate=0.0, seed=None,
                       cluster=None):
    """Backward (TPU kernel #6): plain version for CPU tensors, the kernels
    for CUDA tensors. ``outs`` are the forward's final files (rv, rf, ra),
    ``gouts`` their cotangents. Same contract as
    ``mega_exec_bwd_reference``. ``cluster`` forces the CTAs of an
    example's cluster of the "fma32" walk (``mega_exec.fma32_cluster``) or
    the tensor-core walk (``mega_exec.tc_launch_cluster``); None: the
    launch's pick."""
    if _build.on_cpu("mega_exec_bwd", args[0]):
        return mega_exec_bwd_reference(meta, args, outs, gouts, rate, seed)
    return _launch_bwd(meta, args, outs, gouts,
                       TX.dropout_params(rate, seed), cluster)


def recompute_check(A, Bm, vec=False, chain=False):
    """The card check of the tensor-core pair: runs each product as the
    training forward #5 (``mega_exec_tc_kernel<true>``) calls it and as
    the backward's walk (``mega_bwd_tc_kernel``) recomputes it, on the same
    operands and epilogue (the float32 sum stored as it is). Returns the
    two float32 results (forward's, walk's), which must be equal bit for
    bit.

    Matrix product (``vec`` false): A bf16 ``[M, K]`` (the walk's operands
    are bf16 rows of a file or a record), B bf16 ``[K, N]``; ``fwd_gemm``
    (A in a shared-memory tile, 128-column chunks) against ``walk_gemm``
    (A's rows from global memory over slices of 64 rows, 64-column chunks)
    at M a multiple of 16 up to 64; at any other M up to 256 (the
    row-slice mode, F 150 among them) ``fwd_rows`` over the same slices
    against ``walk_gemm``; K a multiple of 64, N of 8.
    Vec-level product (``vec``): A float32 ``[S, K]``, S <= 3 segments, B
    bf16 ``[S K, N]``; ``vecmat_tc`` as each kernel calls it. With
    ``chain``, stage 1's two products in a row: ``h = bf16(relu(A @ B))``
    kept as each kernel keeps it (the forward in shared memory, the walk
    as bf16 rows in global memory), then ``h @ B[:N, :N]`` (N <= K; for
    the matrix product N a multiple of 64)."""
    dev = A.device
    M, K = A.shape
    N = Bm.shape[1]
    _build.check_tensor("recompute_check A", A,
                        torch.float32 if vec else torch.bfloat16, (M, K), dev)
    _build.check_tensor("recompute_check B", Bm, torch.bfloat16,
                        (M * K if vec else K, N), dev)
    out = torch.empty(*(() if vec else (M,)), N, dtype=torch.float32,
                      device=dev)
    walk = torch.empty_like(out)
    hbuf = torch.empty(2 * M, N, dtype=torch.bfloat16, device=dev)
    err = _build.build().stair_mega_recompute_check(
        A.data_ptr(), Bm.data_ptr(), M, K, N, int(bool(vec)),
        int(bool(chain)), hbuf.data_ptr(), out.data_ptr(), walk.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(err, "mega_recompute_check")
    return out, walk


def f32_product_check(A, W, nk=False, bn=None, reps=1):
    """The card check of the "fma32" route's product helper: runs
    ``stair::mega::gemm`` (the general route's) in one block and ``gemm32``
    (column tile ``bn``: 64, 128 or 256; default ``G32_BN``) in another,
    ``reps`` times each, on A float32 ``[M, K]`` (M <= ``MAX_F``: past 64
    rows, ``gemm32``'s row tiles, the last one ragged) and W float32
    ``[K, N]`` (B as stored) or, with ``nk``, ``[N, K]`` (B = W^T, the
    walk's gradient products). Returns gemm's and gemm32's ``[M, N]`` sums,
    which must be equal bit for bit, and each block's ``clock64()`` span
    (int64 ``[2]``, on the CPU)."""
    dev = A.device
    M, K = A.shape
    N = W.shape[0] if nk else W.shape[1]
    _build.check_tensor("f32_product_check A", A, torch.float32, (M, K), dev)
    _build.check_tensor("f32_product_check W", W, torch.float32,
                        (N, K) if nk else (K, N), dev)
    outg = torch.empty(M, N, dtype=torch.float32, device=dev)
    out32 = torch.empty_like(outg)
    clk = torch.zeros(2, dtype=torch.int64, device=dev)
    err = _build.build().stair_mega_f32_product_check(
        A.data_ptr(), W.data_ptr(), M, K, N, int(bool(nk)),
        bn or TX._TILES["G32_BN"], reps, outg.data_ptr(), out32.data_ptr(),
        clk.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "mega_f32_product_check")
    return outg, out32, clk.cpu()


#: launch keys of each backward route: the walk, the weight gradients
ROUTE_KEYS = {"tc": ("mega_exec_bwd_tc", "mega_exec_wgrad_tc"),
              "fma32": ("mega_exec_bwd_fma32", "mega_exec_wgrad_fma32"),
              "general": ("mega_exec_bwd", "mega_exec_wgrad")}


def bwd_launches(meta, args, outs, gouts, drop, cluster=None):
    """The backward's two launches on CUDA tensors, apart (``drop``:
    ``mega_exec.dropout_params``; ``cluster``: as ``mega_exec_bwd_call``'s).
    Allocates the outputs and scratch once and returns ``(walk, wgrad,
    result)``: ``walk()`` launches the reverse walk, then ``wgrad()`` the
    weight gradients on the walk's records (either may be called again, to
    time it alone), and ``result()`` gives ``mega_exec_bwd_call``'s
    outputs."""
    B, T, Nv, Nf, Na, F, H, Hh, L, dt, fsoft = meta
    dev = TX.check_args("mega_exec_bwd", meta, args)
    if F > 256:
        raise ValueError(f"mega_exec_bwd kernel: F={F} (<= 256)")
    route = bwd_route(dt, H, F)
    tc = route == "tc"
    gouts = tuple(g.to(dt).contiguous() for g in gouts)
    for name, x in zip(("rv", "rf", "ra", "drv", "drf", "dra"),
                       tuple(outs) + gouts):
        shape = {"v": (B, Nv, H), "f": (B, Nf, F, H), "a": (B, Na, F)}
        _build.check_tensor(f"mega_exec_bwd {name}", x, dt,
                            shape[name[-1]], dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dvid = torch.zeros(B, F, H, dtype=dt, device=dev)
    dtok = torch.zeros(B, L, H, dtype=dt, device=dev)
    daux = torch.zeros(B, T, H, dtype=dt, device=dev)
    n_small = sum(n for _, n in small_tables(H, F))
    nrec = B * T
    meta_rec = torch.full((nrec, NSLOT, 3), -1, dtype=torch.int32,
                          device=dev)
    # the weight products' records: X and dY rows, float32 on the general
    # route, bf16 on the tensor-core route with float32 bias partials
    rt = dict(dtype=dt if tc else torch.float32, device=dev)
    recs = [torch.empty(nrec, F, H, **rt) for _ in range(6)] + [
        torch.empty(nrec, 3 * H, **rt), torch.empty(nrec, H, **rt),
        torch.empty(nrec, H, **rt), torch.empty(nrec, H, **rt)]
    bias = (torch.empty(nrec, NSLOT, H, **f32),) if tc else ()
    small = torch.empty(B, n_small, **f32)
    wgrads = [(torch.zeros(E, K * H, H, **f32), torch.zeros(E, H, **f32))
              for _, _, E, K in TABLES]
    dsmall = torch.zeros(n_small, **f32)
    ws = torch.empty(B, workspace_floats(Nv, Nf, Na, F, H, L, T, tc), **f32)
    # the "fma32" weight gradients' row index and its counts (scratch)
    index = (torch.empty(wgrad_rows_room(B, T, F), dtype=torch.int32,
                         device=dev),
             torch.empty(sum(E for _, _, E, _ in TABLES), dtype=torch.int32,
                         device=dev)) if route == "fma32" else ()
    sfx = route if route != "general" else (
        "bf16" if dt == torch.bfloat16 else "f32")
    walk_key, wgrad_key = ROUTE_KEYS[route]
    ptrs = (*args, *outs, *gouts, dvid, dtok, daux, meta_rec, *recs, *bias,
            small)
    wptrs = (meta_rec, *recs, *bias, small,
             *[t for pair in wgrads for t in pair], dsmall, *index)

    def walk():
        # the "fma32" and tensor-core walks: the cluster size, and the one
        # launched
        used = ctypes.c_int(0)
        more = ((int(cluster or 0), ctypes.byref(used))
                if route in ("fma32", "tc") else ())
        err = getattr(_build.build(), f"stair_mega_exec_bwd_{sfx}")(
            _build.pointers(ptrs), len(ptrs), ws.data_ptr(),
            B, T, Nv, Nf, Na, F, H, L, int(bool(fsoft)), *drop, *more,
            _build.stream_ptr(dev))
        _build.check(err, walk_key)
        _build.LAUNCHES[walk_key] += 1
        if route != "general":
            _build.CLUSTERS[walk_key][used.value] += 1

    def wgrad():
        err = getattr(_build.build(), f"stair_mega_exec_wgrad_{sfx}")(
            _build.pointers(wptrs), len(wptrs), B, T, F, H,
            _build.stream_ptr(dev))
        _build.check(err, wgrad_key)
        _build.LAUNCHES[wgrad_key] += 1

    def result():
        return _bwd_outputs(meta, wgrads, dsmall, dvid, dtok, daux)

    return walk, wgrad, result


def _bwd_outputs(meta, wgrads, dsmall, dvid, dtok, daux):
    """``mega_exec_bwd_call``'s outputs from the kernels' buffers."""
    B, T, Nv, Nf, Na, F, H, Hh, L, dt, fsoft = meta
    by_name = {}
    shapes = dict(zip(TX.ARG_NAMES, TX._arg_shapes(B, T, F, H, Hh, L)))
    for (wn, bn, _, _), (dw, db) in zip(TABLES, wgrads):
        by_name[wn] = dw.reshape(shapes[wn])
        by_name[bn] = db.reshape(shapes[bn])
    o = 0
    for name, n in small_tables(H, F):
        by_name[name] = dsmall[o:o + n].reshape(shapes[name])
        o += n
    weights = tuple(by_name[n] for n in TX.ARG_NAMES[N_DATA:])
    return (dvid[..., :Hh].contiguous(), dvid[..., Hh:].contiguous(),
            dtok[..., :Hh].contiguous(), dtok[..., Hh:].contiguous(),
            daux) + weights


def _launch_bwd(meta, args, outs, gouts, drop, cluster=None):
    walk, wgrad, result = bwd_launches(meta, args, outs, gouts, drop,
                                       cluster)
    if meta[0] > 0:
        walk()
        wgrad()
    return result()


class MegaExecTrain(torch.autograd.Function):
    """``(meta, rate, seed, *args) -> (rv, rf, ra)`` with the hand-written
    backward (the port of ``_train_fn``'s custom VJP). The forward and
    backward calls get detached tensors; the masks are recomputed from
    ``seed``, not stored."""

    @staticmethod
    def forward(ctx, meta, rate, seed, *args):
        dargs = tuple(a.detach() for a in args)
        outs = TX.mega_exec_train_call(meta, dargs, rate, seed)
        ctx.meta, ctx.rate, ctx.seed = meta, rate, seed
        ctx.save_for_backward(*dargs, *outs)
        return outs

    @staticmethod
    def backward(ctx, grv, grf, gra):
        saved = ctx.saved_tensors
        # the saved outputs come back attached to the graph
        args, outs = saved[:-3], tuple(o.detach() for o in saved[-3:])
        gouts = tuple(torch.zeros_like(o) if g is None else g
                      for g, o in zip((grv, grf, gra), outs))
        grads = mega_exec_bwd_call(ctx.meta, args, outs, gouts, ctx.rate,
                                   ctx.seed)
        d_args = [None] * len(args)
        for i, g in zip(DATA_GRAD_IDX, grads[:len(DATA_GRAD_IDX)]):
            d_args[i] = g
        for i, g in enumerate(grads[len(DATA_GRAD_IDX):], start=N_DATA):
            d_args[i] = g.to(args[i].dtype)
        return (None, None, None, *d_args)


def mega_exec_train(cfg, mods, tables, trace_fields, video_halves,
                    video_mask, token_halves, token_mask, rate, seed,
                    aux_vec=None):
    """Training executor: ``mega_exec``'s contract plus ``rate`` (dropout)
    and ``seed`` (two int32 values). Differentiable w.r.t. the module
    weights, the video/token direction stacks and ``aux_vec``."""
    meta, args = TX.prepare_args(
        cfg, mods, tables, trace_fields, video_halves, video_mask,
        token_halves, token_mask, aux_vec=aux_vec)
    return MegaExecTrain.apply(meta, float(rate), tuple(seed), *args)
