"""Masked bidirectional LSTM (port of ``stair_tpu/ops/lstm.py``).

The input projection is hoisted out of the recurrence as one matmul
(``_prep``, as in the JAX package); only the ``[h, 4h]`` recurrent product
rides the time loop. Masked steps carry state through unchanged, so the
final forward carry is the state at the last valid token and the final
backward carry (run over reversed positions) the state at the first — the
sentence feature. Gate layout is torch's ``[i, f, g, o]``.

``bilstm`` is the kernel wrapper: for CPU tensors it runs
``bilstm_reference`` (the plain recurrence); for CUDA tensors it launches
the hand-written kernel of the route ``fwd_route`` picks in
``csrc/bilstm.cu`` (the cluster route ``bilstm_tc`` for bf16 at the main
path's shapes, on a batch tile ``fwd_tile`` picks from B and how many
clusters the card holds; the general route ``bilstm`` otherwise) or
raises.

Training: ``bilstm_train_call`` is the forward that also returns the
float32 post-mask h/c state stacks (on the same two routes:
``bilstm_train_tc``, ``bilstm_train``), ``bilstm_bwd_call`` the backward over
them (plain ``bilstm_bwd_reference``, an explicit adjoint recurrence, on
the CPU; on the card the kernels of the route ``bwd_route`` picks: the
cluster route ``bilstm_bwd_tc`` + ``bilstm_dwh_tc`` + ``bilstm_dwh_sum``
for bf16 at the main path's shapes, the general route ``bilstm_bwd`` +
``bilstm_dwh`` otherwise).
``BiLSTMTrain`` is the ``torch.autograd.Function`` around the two (the
port of ``_train_core``) and ``bilstm_forward_train`` the port of
``bilstm_pallas_train``; ``_prep``'s input projection stays outside the
Function, so autograd gives ``wi``, ``bi``, ``bh`` and ``x`` their
gradients.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.utils.device import exact_f32


def init_lstm_params(gen, input_size: int, hidden_size: int,
                     device=None) -> dict:
    """One bidirectional layer, U(-1/sqrt(h), 1/sqrt(h)); weights stored
    ``[in, out]`` (wi [D, 4h], wh [h, 4h]) with torch's two biases."""
    bound = 1.0 / math.sqrt(hidden_size)

    def u(shape):
        x = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (x * (2 * bound) - bound).to(device)

    def direction():
        return {
            "wi": u((input_size, 4 * hidden_size)),
            "wh": u((hidden_size, 4 * hidden_size)),
            "bi": u((4 * hidden_size,)),
            "bh": u((4 * hidden_size,)),
        }

    return {"fwd": direction(), "bwd": direction()}


def _prep(params, x, mask, mm_dtype=None):
    """Hoisted input projection (a plain matmul, as XLA ran it outside the
    TPU kernel).

    Returns ``(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b)``: xp ``[B, L,
    4h]``, mask ``[B, L]`` float32, wh ``[h, 4h]``, bias ``[4h]`` float32.
    float32 mode folds both biases into xp (bias = 0); with ``mm_dtype``
    (bf16) xp is stored in bf16 WITHOUT bias and ``bi + bh`` is re-added in
    float32 at every step, so only the matmul output is rounded.
    """
    pf, pb = params["fwd"], params["bwd"]
    h = pf["wh"].shape[0]
    mask = mask.float().contiguous()
    if mm_dtype is None:
        xp_f = x @ pf["wi"] + pf["bi"] + pf["bh"]
        xp_b = x @ pb["wi"] + pb["bi"] + pb["bh"]
        zero = torch.zeros(4 * h, dtype=torch.float32, device=x.device)
        return (xp_f.contiguous(), xp_b.contiguous(), mask,
                pf["wh"].contiguous(), pb["wh"].contiguous(), zero, zero)
    xm = x.to(mm_dtype)
    xp_f = torch.matmul(xm, pf["wi"].to(mm_dtype))
    xp_b = torch.matmul(xm, pb["wi"].to(mm_dtype))
    return (xp_f.contiguous(), xp_b.contiguous(), mask,
            pf["wh"].to(mm_dtype).contiguous(),
            pb["wh"].to(mm_dtype).contiguous(),
            (pf["bi"] + pf["bh"]).float().contiguous(),
            (pb["bi"] + pb["bh"]).float().contiguous())


def bilstm_reference(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
                     token_dtype=torch.float32, return_stacks=False):
    """The plain masked recurrence over ``_prep``'s outputs.

    Returns ``(tok_f, tok_b, sent)``, and with ``return_stacks`` a fourth
    element ``(h_f, c_f, h_b, c_b)``: the float32 post-mask states ``[B, L,
    h]`` in position order. Token halves are ``[B, L, h]`` in
    ``token_dtype`` (zero at masked steps, in original position order for
    both directions) and the float32 sentence feature ``[B, 2h]`` = the two
    final carries. The recurrent matmul takes ``h`` cast to wh's dtype with
    float32 accumulation, as the JAX kernel's ``jnp.dot(h.astype(wh.dtype),
    wh, preferred_element_type=f32)``.
    """
    if xp_f.is_cuda:
        exact_f32()
    B, L, G = xp_f.shape
    h = G // 4
    valid = mask > 0
    halves, finals, stacks = [], [], []
    for xp, wh, bias, order in ((xp_f, wh_f, bias_f, range(L)),
                                (xp_b, wh_b, bias_b, range(L - 1, -1, -1))):
        whf = wh.float()
        hs = torch.zeros(B, h, dtype=torch.float32, device=xp.device)
        cs = torch.zeros_like(hs)
        tok = torch.empty(B, L, h, dtype=token_dtype, device=xp.device)
        hst = torch.empty(B, L, h, dtype=torch.float32, device=xp.device)
        cst = torch.empty_like(hst)
        for t in order:
            gates = (xp[:, t].float() + bias.float()
                     + hs.to(wh.dtype).float() @ whf)
            i, f, g, o = gates.split(h, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c_new = f * cs + i * g
            h_new = o * torch.tanh(c_new)
            v = valid[:, t, None]
            hs = torch.where(v, h_new, hs)
            cs = torch.where(v, c_new, cs)
            tok[:, t] = (hs * v).to(token_dtype)
            hst[:, t], cst[:, t] = hs, cs
        halves.append(tok)
        finals.append(hs)
        stacks += [hst, cst]
    out = halves[0], halves[1], torch.cat(finals, dim=-1)
    return (*out, tuple(stacks)) if return_stacks else out


def _check_kernel_args(name, xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
                       token_dtype, max_h):
    """Raise unless the kernel takes these tensors; returns (B, L, h)."""
    dev = xp_f.device
    B, L, G = xp_f.shape
    h = G // 4
    dt = xp_f.dtype
    if dt not in (torch.float32, torch.bfloat16) or token_dtype != dt:
        raise ValueError(f"{name} kernel: xp, wh and tokens must all be "
                         f"float32 or all bf16 (xp {dt}, tokens "
                         f"{token_dtype})")
    if G != 4 * h or h < 1 or h > max_h:
        raise ValueError(f"{name} kernel: hidden size {h} not in "
                         f"1..{max_h}")
    for what, t, tdt, shape in (
        ("xp_f", xp_f, dt, (B, L, G)), ("xp_b", xp_b, dt, (B, L, G)),
        ("mask", mask, torch.float32, (B, L)),
        ("wh_f", wh_f, dt, (h, G)), ("wh_b", wh_b, dt, (h, G)),
        ("bias_f", bias_f, torch.float32, (G,)),
        ("bias_b", bias_b, torch.float32, (G,)),
    ):
        _build.check_tensor(f"{name} {what}", t, tdt, shape, dev)
    return B, L, h


def _launch_fwd(key, args, token_dtype, stacks):
    """Launch the forward on the route ``fwd_route`` picks: the cluster
    kernel (launch key ``key + "_tc"``) or the general one (``key``)."""
    xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b = args
    dev = xp_f.device
    B, L, h = _check_kernel_args(key, *args, token_dtype,
                                 512 if stacks else 1024)
    dt = xp_f.dtype
    tok_f = torch.empty(B, L, h, dtype=dt, device=dev)
    tok_b = torch.empty(B, L, h, dtype=dt, device=dev)
    sent = torch.zeros(B, 2 * h, dtype=torch.float32, device=dev)
    st = tuple(torch.zeros(B, L, h, dtype=torch.float32, device=dev)
               for _ in range(4)) if stacks else None
    if B == 0 or L == 0:
        return tok_f, tok_b, sent, st
    lib = _build.build()
    sptrs = _build.pointers(st) if stacks else None
    stream = _build.stream_ptr(dev)
    if fwd_route(dt, h) == "cluster":
        key += "_tc"
        err = lib.stair_bilstm_fwd_tc(
            _build.pointers((*args, tok_f, tok_b, sent)), sptrs, B, L, h,
            fwd_tile(B, _clusters_held(dev, h)), stream)
    else:
        err = lib.stair_bilstm_fwd(
            xp_f.data_ptr(), xp_b.data_ptr(), mask.data_ptr(),
            wh_f.data_ptr(), wh_b.data_ptr(), bias_f.data_ptr(),
            bias_b.data_ptr(), tok_f.data_ptr(), tok_b.data_ptr(),
            sent.data_ptr(), sptrs, B, L, h, int(dt == torch.bfloat16),
            stream)
    _build.check(err, key)
    _build.LAUNCHES[key] += 1
    return tok_f, tok_b, sent, st


def bilstm(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
           token_dtype=torch.float32):
    """BiLSTM recurrence: plain version on CPU, CUDA kernel on the card.

    Same contract as ``bilstm_reference``. The kernel takes two modes:
    all-float32 (xp, wh, tokens), or all-bf16 with float32 state.
    """
    if _build.on_cpu("bilstm", xp_f):
        return bilstm_reference(xp_f, xp_b, mask, wh_f, wh_b, bias_f,
                                bias_b, token_dtype)
    args = (xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b)
    return _launch_fwd("bilstm", args, token_dtype, stacks=False)[:3]


def bilstm_train_call(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
                      token_dtype=torch.float32):
    """Training forward (TPU kernel #2): ``bilstm``'s outputs plus the
    float32 post-mask state stacks ``(h_f, c_f, h_b, c_b)``, each ``[B, L,
    h]`` in position order. Plain version on CPU, the kernel of
    ``fwd_route`` on the card (h <= 512)."""
    if _build.on_cpu("bilstm_train", xp_f):
        return bilstm_reference(xp_f, xp_b, mask, wh_f, wh_b, bias_f,
                                bias_b, token_dtype, return_stacks=True)
    args = (xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b)
    return _launch_fwd("bilstm_train", args, token_dtype, stacks=True)


def bilstm_bwd_reference(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
                         stacks, dtok_f, dtok_b, dsent):
    """The plain backward: an explicit eager adjoint recurrence over the
    forward's state stacks, at the JAX kernel's rounding sites (not
    autograd).

    Each direction walks its steps in reverse and recomputes the gates
    from the stored ``h_{t-1}`` cast to wh's dtype. Returns ``(dxp_f,
    dxp_b)`` in xp's dtype and ``(dwh_f, dwh_b, dbias_f, dbias_b)`` in
    float32; ``dwh`` takes ``h_{t-1}`` and dgates both in wh's dtype."""
    if xp_f.is_cuda:
        exact_f32()
    B, L, G = xp_f.shape
    h = G // 4
    hf, cf, hb, cb = stacks
    out = []
    for d, (xp, wh, bias, hst, cst, dtok, order) in enumerate((
            (xp_f, wh_f, bias_f, hf, cf, dtok_f, list(range(L))),
            (xp_b, wh_b, bias_b, hb, cb, dtok_b,
             list(range(L - 1, -1, -1))))):
        whf = wh.float()
        dh = dsent[:, d * h:(d + 1) * h].float().clone()
        dc = torch.zeros_like(dh)
        zero = torch.zeros_like(dh)
        dxp = torch.empty_like(xp)
        dwh = torch.zeros(h, G, dtype=torch.float32, device=xp.device)
        db = torch.zeros(G, dtype=torch.float32, device=xp.device)
        for k in range(L - 1, -1, -1):
            t = order[k]
            hp = hst[:, order[k - 1]] if k > 0 else zero
            cp = cst[:, order[k - 1]] if k > 0 else zero
            hpd = hp.to(wh.dtype).float()
            gates = xp[:, t].float() + bias.float() + hpd @ whf
            i, f, g, o = gates.split(h, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            valid = (mask[:, t] > 0).float()[:, None]
            dhv = dh + dtok[:, t].float() * valid
            dh_new = dhv * valid
            tc = torch.tanh(cst[:, t])
            dc_new = dc * valid + dh_new * o * (1.0 - tc * tc)
            dg = torch.cat([dc_new * g * i * (1.0 - i),
                            dc_new * cp * f * (1.0 - f),
                            dc_new * i * (1.0 - g * g),
                            dh_new * tc * o * (1.0 - o)], dim=-1)
            dxp[:, t] = dg.to(xp.dtype)
            dgd = dg.to(wh.dtype).float()
            dwh += hpd.T @ dgd
            db += dg.sum(0)
            dh = dhv * (1.0 - valid) + dgd @ whf.T
            dc = dc * (1.0 - valid) + dc_new * f
        out.append((dxp, dwh, db))
    (dxp_f, dwh_f, db_f), (dxp_b, dwh_b, db_b) = out
    return dxp_f, dxp_b, dwh_f, dwh_b, db_f, db_b


@functools.lru_cache(maxsize=None)
def _consts():
    """The kernels' sizes and limits, from ``csrc/bilstm.cu``."""
    return _build.header_ints("bilstm.cu")


def _cluster_route(dtype, h) -> str:
    if (dtype == torch.bfloat16 and h % 64 == 0
            and 64 <= h <= _consts()["TC_MAX_H"]):
        return "cluster"
    return "general"


def fwd_route(dtype, h) -> str:
    """The forward's kernel route (eval and training) for xp and wh of
    ``dtype`` at hidden size ``h``, chosen before any launch: ``"cluster"``
    (``bilstm_tc`` / ``bilstm_train_tc``: bf16, h a multiple of 64 up to
    ``TC_MAX_H``) or ``"general"`` (``bilstm`` / ``bilstm_train``: float32,
    the exact route, and every other h the wrapper takes)."""
    return _cluster_route(dtype, h)


def fwd_tile(B, clusters) -> int:
    """The cluster forward's batch tile for ``B`` rows on a card that holds
    ``clusters`` of its clusters at once (30 on an H100 SXM: one CTA per
    SM, four SMs of one GPC per cluster): the smallest multiple of
    ``FWD_BT_MIN`` up to ``FWD_BT_MAX`` whose grid (2 directions x
    ``ceil(B / tile)`` clusters) runs in one wave, else ``FWD_BT_MAX``.
    A step takes longer the larger the tile (``csrc/bilstm.cu``), so the
    smallest tile that needs no second wave wins, and above ``FWD_BT_MAX``
    a tile loses to two waves of it (B 1024 takes 40 in two waves, B 128
    16 in one)."""
    c = _consts()
    bt = c["FWD_BT_MIN"]
    while bt < c["FWD_BT_MAX"] and 2 * -(-B // bt) > clusters:
        bt += c["FWD_BT_MIN"]
    return bt


@functools.lru_cache(maxsize=None)
def _clusters_held(dev, h) -> int:
    """How many clusters of the forward's cluster route at hidden size
    ``h`` (largest tile) the card ``dev`` holds at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _build.check(_build.build().stair_bilstm_fwd_tc_clusters(
            h, _consts()["FWD_BT_MAX"], ctypes.byref(n)),
            "bilstm_fwd_tc_clusters")
    return n.value


def bwd_route(dtype, h) -> str:
    """The backward's kernel route for xp and wh of ``dtype`` at hidden size
    ``h``, chosen before any launch: ``"cluster"`` (``bilstm_bwd_tc``: bf16,
    h a multiple of 64 up to ``TC_MAX_H``) or ``"general"`` (``bilstm_bwd``:
    float32, the exact route, and every other h the wrapper takes)."""
    return _cluster_route(dtype, h)


def bilstm_bwd_call(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b, stacks,
                    dtok_f, dtok_b, dsent):
    """Backward (TPU kernel #3): plain version on CPU; on the card the
    kernels of ``bwd_route``: the cluster route ``bilstm_bwd_tc`` (dxp and
    per-tile dbias partials), ``bilstm_dwh_tc`` (dwh in row slices) and
    ``bilstm_dwh_sum`` (the slices and the dbias partials in order), or the
    general route ``bilstm_bwd`` then ``bilstm_dwh`` (dwh and the dbias
    sum). Same contract as ``bilstm_bwd_reference``; ``dtok`` in xp's
    dtype, ``dsent`` float32."""
    if _build.on_cpu("bilstm_bwd", xp_f):
        return bilstm_bwd_reference(xp_f, xp_b, mask, wh_f, wh_b, bias_f,
                                    bias_b, stacks, dtok_f, dtok_b, dsent)
    args = (xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b)
    dev = xp_f.device
    B, L, h = _check_kernel_args("bilstm_bwd", *args, xp_f.dtype, 512)
    G, dt = 4 * h, xp_f.dtype
    for name, t, tdt, shape in (
        ("h_f", stacks[0], torch.float32, (B, L, h)),
        ("c_f", stacks[1], torch.float32, (B, L, h)),
        ("h_b", stacks[2], torch.float32, (B, L, h)),
        ("c_b", stacks[3], torch.float32, (B, L, h)),
        ("dtok_f", dtok_f, dt, (B, L, h)), ("dtok_b", dtok_b, dt, (B, L, h)),
        ("dsent", dsent, torch.float32, (B, 2 * h)),
    ):
        _build.check_tensor(f"bilstm_bwd {name}", t, tdt, shape, dev)
    dxp_f = torch.zeros(B, L, G, dtype=dt, device=dev)
    dxp_b = torch.zeros(B, L, G, dtype=dt, device=dev)
    dwh_f, dwh_b = (torch.zeros(h, G, dtype=torch.float32, device=dev)
                    for _ in range(2))
    db_f, db_b = (torch.zeros(G, dtype=torch.float32, device=dev)
                  for _ in range(2))
    if B == 0 or L == 0:
        return dxp_f, dxp_b, dwh_f, dwh_b, db_f, db_b
    nb = -(-B // _consts()["BT"])  # row tiles
    part = torch.empty(nb, 2, G, dtype=torch.float32, device=dev)
    lib = _build.build()
    stream = _build.stream_ptr(dev)
    ptrs = _build.pointers((*args, *stacks, dtok_f, dtok_b, dsent, dxp_f,
                            dxp_b, part))
    if bwd_route(dt, h) == "cluster":
        _build.check(lib.stair_bilstm_bwd_tc(ptrs, B, L, h, stream),
                     "bilstm_bwd_tc")
        _build.LAUNCHES["bilstm_bwd_tc"] += 1
        slices = torch.empty(2, _consts()["DW_SPLIT"], h, G,
                             dtype=torch.float32, device=dev)
        _build.check(lib.stair_bilstm_dwh_tc(
            _build.pointers((stacks[0], stacks[2], dxp_f, dxp_b, slices)),
            B, L, h, stream), "bilstm_dwh_tc")
        _build.LAUNCHES["bilstm_dwh_tc"] += 1
        _build.check(lib.stair_bilstm_dwh_sum(
            _build.pointers((slices, part, dwh_f, dwh_b, db_f, db_b)), nb,
            h, stream), "bilstm_dwh_sum")
        _build.LAUNCHES["bilstm_dwh_sum"] += 1
        return dxp_f, dxp_b, dwh_f, dwh_b, db_f, db_b
    bf16 = int(dt == torch.bfloat16)
    err = lib.stair_bilstm_bwd(ptrs, B, L, h, bf16, stream)
    _build.check(err, "bilstm_bwd")
    _build.LAUNCHES["bilstm_bwd"] += 1
    err = lib.stair_bilstm_dwh(
        _build.pointers((stacks[0], stacks[2], dxp_f, dxp_b, part, dwh_f,
                         dwh_b, db_f, db_b)), B, L, h, bf16, stream)
    _build.check(err, "bilstm_dwh")
    _build.LAUNCHES["bilstm_dwh"] += 1
    return dxp_f, dxp_b, dwh_f, dwh_b, db_f, db_b


class BiLSTMTrain(torch.autograd.Function):
    """Differentiable recurrence over ``_prep``'s outputs (the port of
    ``_train_core``): forward ``bilstm_train_call``, backward
    ``bilstm_bwd_call``. The calls get detached, contiguous tensors; the
    backward casts ``dtok`` to the token dtype and ``dsent`` to float32,
    and returns ``dwh``/``dbias`` in their parameters' dtypes."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
                token_dtype):
        args = tuple(a.detach().contiguous() for a in
                     (xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b))
        tok_f, tok_b, sent, stacks = bilstm_train_call(
            *args, token_dtype=token_dtype)
        ctx.save_for_backward(*args, *stacks)
        ctx.token_dtype = token_dtype
        return tok_f, tok_b, sent

    @staticmethod
    def backward(ctx, dtok_f, dtok_b, dsent):
        saved = ctx.saved_tensors
        args, stacks = saved[:7], saved[7:]
        xp_f, _, _, wh_f, wh_b, bias_f, bias_b = args
        B, L, G = xp_f.shape

        def cot(g, shape, dtype):
            if g is None:
                return torch.zeros(shape, dtype=dtype, device=xp_f.device)
            return g.to(dtype).contiguous()

        tdt = ctx.token_dtype
        dxp_f, dxp_b, dwh_f, dwh_b, db_f, db_b = bilstm_bwd_call(
            *args, stacks, cot(dtok_f, (B, L, G // 4), tdt),
            cot(dtok_b, (B, L, G // 4), tdt),
            cot(dsent, (B, G // 2), torch.float32))
        return (dxp_f, dxp_b, None, dwh_f.to(wh_f.dtype),
                dwh_b.to(wh_b.dtype), db_f.to(bias_f.dtype),
                db_b.to(bias_b.dtype), None)


def bilstm_forward(params, x, mask, mm_dtype=None,
                   token_dtype=torch.float32):
    """Batched BiLSTM over ``x`` [B, L, D] with ``mask`` [B, L] (the port of
    ``bilstm_pallas``). Returns ``(tokens [B, L, 2h] token_dtype, sentence
    [B, 2h] float32, (tok_f, tok_b))``."""
    tok_f, tok_b, sent = bilstm(*_prep(params, x, mask, mm_dtype),
                                token_dtype=token_dtype)
    return torch.cat([tok_f, tok_b], dim=-1), sent, (tok_f, tok_b)


def bilstm_forward_train(params, x, mask, mm_dtype=None,
                         token_dtype=torch.float32):
    """Differentiable batched BiLSTM (the port of ``bilstm_pallas_train``):
    the hoisted projection ``_prep`` under autograd, then ``BiLSTMTrain``.
    Same outputs as ``bilstm_forward``; gradients reach every parameter
    and ``x``."""
    tok_f, tok_b, sent = BiLSTMTrain.apply(*_prep(params, x, mask, mm_dtype),
                                           token_dtype)
    return torch.cat([tok_f, tok_b], dim=-1), sent, (tok_f, tok_b)
