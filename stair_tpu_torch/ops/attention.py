"""Fused masked attention (port of ``stair_tpu/ops/attention.py``), forward
and backward.

One function serves both of the JAX package's masks: plain causal
(``prefix_len`` 0) and the prefix-LM mask, where the first ``prefix_len``
key positions of an example are visible to every query on top of the
causal triangle; key positions at or past ``valid_len`` are padding. The
mask is two integers per example, never a tensor.

``flash_attention`` is the kernel wrapper: for CPU tensors it runs
``reference_attention`` (the plain version); for CUDA tensors it launches
the hand-written kernel ``csrc/flash_attn.cu`` (TPU kernel #7,
``_flash_kernel``) or raises. Both return ``(out, lse)`` conventions of the
kernel:

* ``out`` is ``[B, H, Lq, D]`` in q's dtype, a view of ``[B, Lq, H, D]``
  memory, so the caller's ``out.transpose(1, 2).reshape(B, Lq, H * D)``
  copies nothing;
* ``lse`` (``return_lse=True``) is the row log-sum-exp ``[B, H, Lq]``
  float32, ``+inf`` on rows with no live column;
* query rows at or past ``valid_len`` are padding: ``out`` is 0 and ``lse``
  ``+inf`` there. (The JAX kernel zeroes them only where a whole tile is
  padding, so its values there depend on the tile size and are no part of
  the function.) A row with no live column (``valid_len`` 0) gives 0 too,
  as the JAX kernel does, not the dense reference's mean of V;
* scores, the running max and sum and the output accumulate in float32;
  the probabilities are rounded to v's dtype before the ``P V`` product and
  the row sum is taken before that rounding, as in ``_flash_kernel``.

k and v carry ``H_kv`` heads with ``H % H_kv == 0``; query head ``h`` reads
kv head ``h // (H / H_kv)``, so grouped-query callers never expand k/v.
q, k and v may be any strided views whose last dimension is contiguous
(for instance ``[B, L, H, D]`` projections seen as ``[B, H, L, D]``): the
kernel takes the strides. Lengths need not divide any tile.

When an input requires grad, ``flash_attention`` goes through
``FlashAttention`` (a ``torch.autograd.Function``): the forward launches
the same kernel with the lse and saves ``q, k, v, out, lse``; the backward
launches ``csrc/flash_attn_bwd.cu`` (TPU kernels #8 ``_bwd_dq_kernel`` and
#9 ``_bwd_dkv_kernel``) on detached tensors. For CPU tensors the same
Function runs ``reference_attention`` and ``flash_backward_reference``, the
backward's plain version. Conventions of the backward:

* ``di = rowsum(out * dO)`` ``[B, H, Lq]`` float32 is a torch expression
  in the wrapper, as the JAX package computes it outside its kernels;
* ``P = exp(S - lse)`` on live pairs and 0 elsewhere (a masked pair never
  reaches ``exp``), ``dP = dO V^T``, ``dS = P (dP - di) scale``, ``dQ = dS
  K``, ``dV = P^T dO``, ``dK = dS^T Q``, all accumulated in float32; ``P``
  is rounded to the input dtype before ``P^T dO`` and ``dS`` before ``dS
  K`` and ``dS^T Q`` (the JAX kernels keep ``P`` in float32 there, so bf16
  agrees with them by tolerance, float32 exactly in form);
* query rows at or past ``valid_len`` are padding: their ``dO`` is read
  as 0, so dQ is 0 there and they add nothing to dK/dV; dK/dV rows at or
  past ``valid_len`` are 0; ``valid_len`` 0 gives zeros, never NaN;
* dK/dV of kv head ``j`` are the sums over query heads ``j g .. j g + g -
  1`` (``g = H / H_kv``), taken inside the kernel in that order in
  float32: no expanded k/v and no float atomics, so a second launch gives
  the same bits;
* dQ is a ``[B, H, Lq, D]`` view of ``[B, Lq, H, D]`` memory and dK/dV
  ``[B, H_kv, Lkv, D]`` views of ``[B, Lkv, H_kv, D]`` memory, so the
  backward of the caller's transpose copies nothing. ``dO`` is taken with
  its strides when its last dimension is contiguous (what autograd hands
  back through ``out.transpose(1, 2).reshape(...)``), else copied once.
"""

from __future__ import annotations

import ctypes
import math

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.utils.device import exact_f32

MASK_VALUE = -1e30
MAX_HEAD_DIM = 128


def attention_mask(prefix_len, valid_len, q_len, kv_len, causal=True):
    """``[B, Lq, Lkv]`` boolean mask of live (query, key) pairs, padding
    query rows included as all-False."""
    dev = valid_len.device
    rows = torch.arange(q_len, device=dev)[None, :, None]
    cols = torch.arange(kv_len, device=dev)[None, None, :]
    valid = valid_len[:, None, None]
    ok = (cols < valid) & (rows < valid)
    if causal:
        ok = ok & ((cols <= rows) | (cols < prefix_len[:, None, None]))
    return ok


def _f(x):
    """The accumulation type: float32 (float64 stays, for gradcheck)."""
    return x if x.dtype == torch.float64 else x.float()


def reference_attention(q, k, v, prefix_len, valid_len, causal=True,
                        sm_scale=None):
    """The plain version: dense scores, the kernel's masking and rounding.
    Returns ``(out, lse)`` as the module docstring describes."""
    if q.is_cuda:
        exact_f32()
    B, H, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qg = _f(q.reshape(B, Hkv, g, Lq, D))
    s = torch.einsum("bkgqd,bkld->bkgql", qg, _f(k)) * scale
    mask = attention_mask(prefix_len, valid_len, Lq, Lkv, causal)
    mask = mask[:, None, None]                          # [B, 1, 1, Lq, Lkv]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)                                   # [B, Hkv, g, Lq]
    live = mask.any(dim=-1).expand_as(l)
    acc = torch.einsum("bkgql,bkld->bqkgd", _f(p.to(v.dtype)), _f(v))
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = acc / safe.permute(0, 3, 1, 2)[..., None]
    out = out.reshape(B, Lq, H, D).to(q.dtype).transpose(1, 2)
    lse = torch.where(live, m[..., 0] + torch.log(safe),
                      torch.full_like(l, math.inf))
    return out, lse.reshape(B, H, Lq)


def flash_backward_reference(q, k, v, out, lse, dout, prefix_len, valid_len,
                             causal=True, sm_scale=None):
    """The backward's plain version: dense and explicit, with the kernels'
    conventions and rounding sites (module docstring). Returns ``(dq, dk,
    dv)`` in q's dtype, as views of ``[B, L, heads, D]`` memory."""
    if q.is_cuda:
        exact_f32()
    B, H, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    g = H // Hkv
    dt = q.dtype
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    mask = attention_mask(prefix_len, valid_len, Lq, Lkv, causal)
    mask = mask[:, None, None]                          # [B, 1, 1, Lq, Lkv]
    rows = torch.arange(Lq, device=q.device)[None, :] < valid_len[:, None]
    do = _f(dout)
    do = torch.where(rows[:, None, :, None], do, torch.zeros_like(do))
    di = (_f(out) * do).sum(dim=-1).reshape(B, Hkv, g, Lq, 1)
    qg = _f(q).reshape(B, Hkv, g, Lq, D)
    dog = do.reshape(B, Hkv, g, Lq, D)
    kf, vf = _f(k), _f(v)
    s = torch.einsum("bkgqd,bkld->bkgql", qg, kf) * scale
    # exp(finite - inf) = 0 on padding rows; masked pairs are dropped by
    # where, whatever exp gave there
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, g, Lq, 1)),
                    torch.zeros_like(s))
    dp = torch.einsum("bkgqd,bkld->bkgql", dog, vf)
    ds = _f((p * (dp - di) * scale).to(dt))
    p = _f(p.to(dt))
    dq = torch.einsum("bkgql,bkld->bqkgd", ds, kf)
    dv = torch.einsum("bkgql,bkgqd->blkd", p, dog)
    dk = torch.einsum("bkgql,bkgqd->blkd", ds, qg)
    return (dq.reshape(B, Lq, H, D).to(dt).contiguous().transpose(1, 2),
            dk.to(dt).contiguous().transpose(1, 2),
            dv.to(dt).contiguous().transpose(1, 2))


class _Args(ctypes.Structure):
    """``FlashArgs`` of ``csrc/flash_attn.cu``, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("q", "k", "v", "o", "lse", "prefix_len", "valid_len")]
        + [(n, ctypes.c_longlong) for n in
           ("q_sb", "q_sh", "q_sl", "k_sb", "k_sh", "k_sl",
            "v_sb", "v_sh", "v_sl", "o_sb", "o_sh", "o_sl")]
        + [(n, ctypes.c_int) for n in
           ("B", "H", "Hkv", "Lq", "Lkv", "D", "causal", "bf16", "mma")]
        + [("sm_scale", ctypes.c_float)]
    )


def _check(name, t, dtype, shape, dev):
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"flash_attention {name}: expected a tensor on "
                         f"{dev}, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention {name}: expected {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.requires_grad:
        raise ValueError(f"flash_attention {name}: a kernel takes detached "
                         "tensors; differentiate through FlashAttention")


def _launch(q, k, v, prefix_len, valid_len, causal, scale, return_lse):
    dev = q.device
    B, H, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: q must be float32 or bf16, "
                         f"got {dt}")
    if D < 1 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} not in "
                         f"1..{MAX_HEAD_DIM}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {Hkv} kv heads")
    _check("q", q, dt, (B, H, Lq, D), dev)
    _check("k", k, dt, (B, Hkv, Lkv, D), dev)
    _check("v", v, dt, (B, Hkv, Lkv, D), dev)
    _check("prefix_len", prefix_len, torch.int32, (B,), dev)
    _check("valid_len", valid_len, torch.int32, (B,), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention {name}: the last dimension "
                             "must be contiguous")
    out = torch.empty(B, Lq, H, D, dtype=dt, device=dev).transpose(1, 2)
    lse = (torch.empty(B, H, Lq, dtype=torch.float32, device=dev)
           if return_lse else None)
    if B == 0 or Lq == 0:
        return out, lse
    if Lkv == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(math.inf)
        return out, lse
    # The tensor-core kernel loads 16-byte chunks: bf16, D 64 or 128, and
    # every row start 16-byte aligned. Anything else takes the scalar one.
    mma = (dt == torch.bfloat16 and D in (64, 128)
           and all(_aligned(t) for t in (q, k, v)))
    args = _Args(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        prefix_len.contiguous().data_ptr(),
        valid_len.contiguous().data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3],
        B, H, Hkv, Lq, Lkv, D, int(bool(causal)),
        int(dt == torch.bfloat16), int(mma), float(scale),
    )
    lib = _build.build()
    err = lib.stair_flash_attn_fwd(ctypes.byref(args),
                                   _build.stream_ptr(dev))
    _build.check(err, "flash_attn")
    _build.LAUNCHES["flash_attn"] += 1
    return out, lse


class _BwdArgs(ctypes.Structure):
    """``FlashBwdArgs`` of ``csrc/flash_attn_bwd.cu``, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("q", "k", "v", "dout", "lse", "di", "dq", "dk", "dv",
          "prefix_len", "valid_len")]
        + [(f"{t}_{s}", ctypes.c_longlong)
           for t in ("q", "k", "v", "do", "dq", "dk", "dv")
           for s in ("sb", "sh", "sl")]
        + [(n, ctypes.c_int) for n in
           ("B", "H", "Hkv", "Lq", "Lkv", "D", "causal", "bf16", "mma")]
        + [("sm_scale", ctypes.c_float)]
    )


def _aligned(t):
    """What the tensor-core kernels' 16-byte loads need of a bf16 tensor."""
    return (t.data_ptr() % 16 == 0
            and all(t.stride(i) % 8 == 0 for i in range(3)))


def _backward_args(q, k, v, out, lse, dout, prefix_len, valid_len, causal,
                   scale):
    """Check the backward's tensors, allocate dQ, dK and dV and fill the
    kernels' argument block. Returns ``(args, (dq, dk, dv), keep)``; ``args``
    is None where there is nothing to launch (an empty dimension; the
    gradients are then zeros). ``keep`` holds the tensors whose pointers
    ``args`` carries."""
    dev = q.device
    B, H, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    dt = q.dtype
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    _check("q", q, dt, (B, H, Lq, D), dev)
    _check("k", k, dt, (B, Hkv, Lkv, D), dev)
    _check("v", v, dt, (B, Hkv, Lkv, D), dev)
    _check("out", out, dt, (B, H, Lq, D), dev)
    _check("dout", dout, dt, (B, H, Lq, D), dev)
    _check("lse", lse, torch.float32, (B, H, Lq), dev)
    dq = torch.empty(B, Lq, H, D, dtype=dt, device=dev).transpose(1, 2)
    dk = torch.empty(B, Lkv, Hkv, D, dtype=dt, device=dev).transpose(1, 2)
    dv = torch.empty(B, Lkv, Hkv, D, dtype=dt, device=dev).transpose(1, 2)
    if B == 0 or Lq == 0 or Lkv == 0:
        return None, (dq.zero_(), dk.zero_(), dv.zero_()), ()
    lse = lse.contiguous()
    di = (out.float() * dout.float()).sum(dim=-1).contiguous()
    prefix_len, valid_len = prefix_len.contiguous(), valid_len.contiguous()
    mma = (dt == torch.bfloat16 and D in (64, 128)
           and all(_aligned(t) for t in (q, k, v, dout)))
    args = _BwdArgs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), prefix_len.data_ptr(), valid_len.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
        *dv.stride()[:3],
        B, H, Hkv, Lq, Lkv, D, int(bool(causal)),
        int(dt == torch.bfloat16), int(mma), float(scale),
    )
    return args, (dq, dk, dv), (q, k, v, dout, lse, di, prefix_len,
                                valid_len)


def _launch_dq(args, dev):
    """Kernel #8: dQ of ``_backward_args``'s block."""
    lib = _build.build()
    _build.check(lib.stair_flash_attn_bwd_dq(ctypes.byref(args),
                                             _build.stream_ptr(dev)),
                 "flash_attn_bwd_dq")
    _build.LAUNCHES["flash_attn_bwd_dq"] += 1


def _launch_dkv(args, dev):
    """Kernel #9: dK and dV of ``_backward_args``'s block."""
    lib = _build.build()
    _build.check(lib.stair_flash_attn_bwd_dkv(ctypes.byref(args),
                                              _build.stream_ptr(dev)),
                 "flash_attn_bwd_dkv")
    _build.LAUNCHES["flash_attn_bwd_dkv"] += 1


def _launch_backward(q, k, v, out, lse, dout, prefix_len, valid_len, causal,
                     scale):
    """Kernels #8 and #9 on detached CUDA tensors; returns (dq, dk, dv)."""
    args, grads, _keep = _backward_args(q, k, v, out, lse, dout, prefix_len,
                                        valid_len, causal, scale)
    if args is not None:
        _launch_dq(args, q.device)
        _launch_dkv(args, q.device)
    return grads


def _forward(q, k, v, prefix_len, valid_len, causal, scale, return_lse):
    """The wrapper's route on detached tensors: plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if _build.on_cpu("flash_attention", q):
        return reference_attention(q, k, v, prefix_len, valid_len, causal,
                                   scale)
    return _launch(q, k, v, prefix_len, valid_len, causal, scale, return_lse)


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, prefix_len, valid_len, causal, scale) -> (out,
    lse)``, differentiable in q, k and v. One structure for both devices:
    kernels #7, #8, #9 on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, prefix_len, valid_len, causal, scale):
        q, k, v = q.detach(), k.detach(), v.detach()
        out, lse = _forward(q, k, v, prefix_len, valid_len, causal, scale,
                            True)
        ctx.save_for_backward(q, k, v, out, lse, prefix_len, valid_len)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, prefix_len, valid_len = (
            t.detach() for t in ctx.saved_tensors)
        dout = dout.detach()
        if _build.on_cpu("flash_attention", q):
            grads = flash_backward_reference(
                q, k, v, out, lse, dout, prefix_len, valid_len, ctx.causal,
                ctx.scale)
        else:
            grads = _launch_backward(
                q, k, v, out, lse, dout, prefix_len, valid_len, ctx.causal,
                ctx.scale)
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, prefix_len, valid_len, causal=True,
                    sm_scale=None, return_lse=False):
    """Masked attention: plain version on CPU, CUDA kernel on the card.

    q ``[B, H, Lq, D]``; k, v ``[B, H_kv, Lkv, D]``; prefix_len, valid_len
    ``[B]`` int32. Returns ``out`` ``[B, H, Lq, D]``, or ``(out, lse)``
    with ``return_lse``. Differentiable in q, k and v (through
    ``FlashAttention``) whenever one of them requires grad.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    prefix_len = prefix_len.to(torch.int32)
    valid_len = valid_len.to(torch.int32)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = FlashAttention.apply(q, k, v, prefix_len, valid_len,
                                        bool(causal), float(scale))
    else:
        out, lse = _forward(q.detach(), k.detach(), v.detach(), prefix_len,
                            valid_len, causal, scale, return_lse)
    return (out, lse) if return_lse else out
