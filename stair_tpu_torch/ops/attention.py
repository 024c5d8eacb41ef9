"""Fused masked attention (port of ``stair_tpu/ops/attention.py``, forward).

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

The backward kernels (TPU kernels #8, #9) are not ported yet, so the
wrapper refuses tensors that require grad.
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
    qg = q.reshape(B, Hkv, g, Lq, D).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k.float()) * scale
    mask = attention_mask(prefix_len, valid_len, Lq, Lkv, causal)
    mask = mask[:, None, None]                          # [B, 1, 1, Lq, Lkv]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)                                   # [B, Hkv, g, Lq]
    live = mask.any(dim=-1).expand_as(l)
    acc = torch.einsum("bkgql,bkld->bqkgd", p.to(v.dtype).float(), v.float())
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = acc / safe.permute(0, 3, 1, 2)[..., None]
    out = out.reshape(B, Lq, H, D).to(q.dtype).transpose(1, 2)
    lse = torch.where(live, m[..., 0] + torch.log(safe),
                      torch.full_like(l, math.inf))
    return out, lse.reshape(B, H, Lq)


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
        raise ValueError(f"flash_attention {name}: the backward kernels are "
                         "not ported; pass detached tensors")


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
           and all(t.data_ptr() % 16 == 0
                   and all(t.stride(i) % 8 == 0 for i in range(3))
                   for t in (q, k, v)))
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


def flash_attention(q, k, v, prefix_len, valid_len, causal=True,
                    sm_scale=None, return_lse=False):
    """Masked attention: plain version on CPU, CUDA kernel on the card.

    q ``[B, H, Lq, D]``; k, v ``[B, H_kv, Lkv, D]``; prefix_len, valid_len
    ``[B]`` int32. Returns ``out`` ``[B, H, Lq, D]``, or ``(out, lse)``
    with ``return_lse``.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    prefix_len = prefix_len.to(torch.int32)
    valid_len = valid_len.to(torch.int32)
    if _build.on_cpu("flash_attention", q):
        out, lse = reference_attention(q, k, v, prefix_len, valid_len,
                                       causal, scale)
    else:
        out, lse = _launch(q, k, v, prefix_len, valid_len, causal, scale,
                           return_lse)
    return (out, lse) if return_lse else out
