"""Port parity: the attention backward (stair_tpu_torch/ops/attention.py,
``flash_backward_reference`` and ``FlashAttention``).

The same numpy q, k, v and cotangent go through the TPU backward kernels
under the Pallas interpreter (``_flash_backward(interpret=True)`` fed by
``_flash_forward(interpret=True, save_residuals=True)``) and through the
port's plain backward: float32 at rtol 2e-4 / atol 2e-5 (summation order),
bf16 by ``max|a-b| / max|b|`` <= 3e-2 (the port rounds P before ``P^T dO``,
the JAX kernels do not). Rows at or past ``valid_len`` are padding in the
port (gradient 0) and are compared below it only; the JAX side gets k/v
expanded over the group and the port's dK/dV are held against the group
sums. ``jax.grad`` of the JAX dense reference, torch autograd through the
port's dense forward, and ``gradcheck`` in float64 hold the same function
from three more sides. The CUDA kernels are held against the plain version
on the card.
"""

import math

import numpy as np
import pytest
import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import attention as TA
from torch_port_util import cuda_device  # noqa: F401

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.ops import attention as JA
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")


def _inputs(B, H, Hkv, Lq, Lkv, D, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, Lq, D) * scale).astype(np.float32)
    k = (rng.randn(B, Hkv, Lkv, D) * scale).astype(np.float32)
    v = (rng.randn(B, Hkv, Lkv, D) * scale).astype(np.float32)
    do = rng.randn(B, H, Lq, D).astype(np.float32)
    return q, k, v, do


def _t(x, dtype=torch.float32, device=None):
    return torch.from_numpy(np.asarray(x)).to(device, dtype)


def _lens(prefix, valid, device=None):
    return (torch.tensor(prefix, dtype=torch.int32, device=device),
            torch.tensor(valid, dtype=torch.int32, device=device))


def _port_backward(q, k, v, do, prefix, valid, causal=True,
                   dtype=torch.float32):
    """The plain forward then the plain backward, as float32 numpy."""
    tq, tk, tv, tdo = (_t(x, dtype) for x in (q, k, v, do))
    pl, vl = _lens(prefix, valid)
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = TA.reference_attention(tq, tk, tv, pl, vl, causal, scale)
    grads = TA.flash_backward_reference(tq, tk, tv, out, lse, tdo, pl, vl,
                                        causal, scale)
    return [g.float().numpy() for g in grads]


def _group_sum(x, Hkv):
    B, H, L, D = x.shape
    return x.reshape(B, Hkv, H // Hkv, L, D).sum(axis=2)


# name, B, H, Hkv, L, D, prefix, valid, block
KERNEL_CASES = [
    ("causal", 2, 2, 2, 128, 16, [0, 0], [128, 128], 64),
    ("prefix-ragged", 2, 2, 2, 128, 32, [30, 0], [128, 100], 64),
    ("padded-300", 2, 2, 2, 512, 32, [40, 0], [300, 220], 128),
    ("valid-0-1-L", 3, 2, 2, 64, 16, [0, 0, 5], [0, 1, 64], 32),
    ("prefix>valid", 2, 2, 2, 64, 16, [50, 200], [20, 64], 32),
    ("gqa-4", 2, 8, 2, 64, 16, [0, 9], [64, 40], 32),
    ("gqa-H", 1, 4, 1, 64, 32, [7], [50], 32),
    ("D64", 2, 2, 2, 64, 64, [10, 0], [64, 50], 32),
    ("D128", 1, 2, 2, 64, 128, [0], [60], 64),
]


@needs_jax
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_against_pallas_backward_interpret(case, dtype):
    _, B, H, Hkv, L, D, prefix, valid, block = case
    q, k, v, do = _inputs(B, H, Hkv, L, L, D, seed=L + D + H)
    for b, nv in enumerate(valid):      # the port reads padding dO as 0
        do[b, :, nv:] = 0.0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    g = H // Hkv
    jq = jnp.asarray(q, jdt)
    jk = jnp.repeat(jnp.asarray(k, jdt), g, axis=1)
    jv = jnp.repeat(jnp.asarray(v, jdt), g, axis=1)
    jp, jvl = jnp.asarray(prefix, jnp.int32), jnp.asarray(valid, jnp.int32)
    scale = 1.0 / math.sqrt(D)
    out, lse = JA._flash_forward(
        jq, jk, jv, jp, jvl, causal=True, sm_scale=scale, block_q=block,
        block_kv=block, interpret=True, save_residuals=True)
    ref = JA._flash_backward(
        jq, jk, jv, out, lse, jnp.asarray(do, jdt), jp, jvl, causal=True,
        sm_scale=scale, block_q=block, block_kv=block, interpret=True)
    dq, dk, dv = (np.asarray(x.astype(jnp.float32)) for x in ref)
    want = [dq, _group_sum(dk, Hkv), _group_sum(dv, Hkv)]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = _port_backward(q, k, v, do, prefix, valid, dtype=tdt)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        for b, nv in enumerate(valid):
            assert np.all(a[b, :, nv:] == 0.0), (name, b)
            x, y = a[b, :, :nv], w[b, :, :nv]
            if dtype == "float32":
                np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5,
                                           err_msg=name)
            elif nv:
                assert (np.abs(x - y).max()
                        <= 3e-2 * max(np.abs(y).max(), 1e-6)), (name, b)


# name, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal
DENSE_CASES = [
    ("odd-lengths", 2, 3, 3, 37, 37, 8, [5, 0], [37, 20], True),
    ("gqa", 2, 4, 2, 19, 19, 8, [0, 4], [19, 11], True),
    ("noncausal-LqLkv", 2, 2, 2, 11, 23, 8, [0, 0], [23, 9], False),
    ("causal-LqLkv", 2, 4, 1, 11, 23, 16, [3, 0], [23, 9], True),
]


@needs_jax
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_against_jax_grad_of_dense_reference(case):
    """``jax.grad`` of the JAX package's dense attention, the loss taken on
    rows below ``valid_len`` (JAX's padding rows are not the port's)."""
    _, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal = case
    q, k, v, do = _inputs(B, H, Hkv, Lq, Lkv, D, seed=Lq + Lkv)
    g = H // Hkv
    jp, jvl = jnp.asarray(prefix, jnp.int32), jnp.asarray(valid, jnp.int32)
    rows = (jnp.arange(Lq)[None, :] < jvl[:, None])[:, None, :, None]

    def loss(q, k, v):
        out = JA.reference_attention(
            q, jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1), jp, jvl,
            causal, 1.0 / math.sqrt(D))
        return jnp.sum(jnp.where(rows, out * do, 0.0))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _port_backward(q, k, v, do, prefix, valid, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        for b, nv in enumerate(valid):
            # key rows at or past valid get no gradient on either side;
            # query rows there are padding in the port
            np.testing.assert_allclose(
                a[b, :, :nv], np.asarray(w)[b, :, :nv], rtol=2e-4, atol=2e-5,
                err_msg=name)


@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_function_matches_autograd_through_the_plain_forward(case):
    """``FlashAttention`` on CPU tensors (plain forward, plain backward)
    against torch autograd through ``reference_attention``."""
    _, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal = case
    q, k, v, do = _inputs(B, H, Hkv, Lq, Lkv, D, seed=7)
    pl, vl = _lens(prefix, valid)
    grads = []
    for fn in (TA.flash_attention,
               lambda *a, **kw: TA.reference_attention(*a, **kw)[0]):
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        out = fn(tq, tk, tv, pl, vl, causal=causal)
        assert out.requires_grad
        out.backward(_t(do))
        grads.append([t.grad.numpy() for t in (tq, tk, tv)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_function_layouts_lse_and_no_grad_route():
    q, k, v, do = _inputs(2, 4, 2, 9, 9, 8, seed=1)
    pl, vl = _lens([0, 3], [9, 6])
    # [B, L, H, D] projections viewed as [B, H, L, D], as the decoder does
    tq, tk, tv = (_t(x.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
                  .requires_grad_() for x in (q, k, v))
    out, lse = TA.flash_attention(tq, tk, tv, pl, vl, return_lse=True)
    assert out.requires_grad and not lse.requires_grad
    assert out.transpose(1, 2).is_contiguous()
    out.transpose(1, 2).reshape(2, 9, 32).sum().backward()
    for t in (tq, tk, tv):
        assert t.grad.shape == t.shape
    # gradients as views of [B, L, heads, D] memory
    scale = 1.0 / math.sqrt(8)
    grads = TA.flash_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse, _t(do), pl,
        vl, True, scale)
    for g in grads:
        assert g.transpose(1, 2).is_contiguous()
    with torch.no_grad():
        assert not TA.flash_attention(tq, tk, tv, pl, vl).requires_grad


def test_gradcheck_float64():
    rng = np.random.RandomState(0)
    mk = lambda h: torch.from_numpy(  # noqa: E731
        rng.randn(2, 7, h, 4)).transpose(1, 2).requires_grad_()
    q, k, v = mk(4), mk(2), mk(2)
    pl, vl = _lens([0, 3], [7, 5])
    assert torch.autograd.gradcheck(
        lambda q, k, v: TA.flash_attention(q, k, v, pl, vl), (q, k, v))


@pytest.mark.parametrize("valid", [[0, 0], [0, 5], [1, 9]],
                         ids=["all-empty", "one-empty", "one-row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_no_nan_on_empty_examples_and_nan_in_padding(valid, dtype):
    """``valid_len`` 0 gives zeros; a NaN cotangent or output on padding
    rows does not spread (their dO is read as 0)."""
    q, k, v, do = _inputs(2, 2, 2, 9, 9, 8, seed=2)
    for b, nv in enumerate(valid):
        do[b, :, nv:] = np.nan
    got = _port_backward(q, k, v, do, [0, 2], valid, dtype=dtype)
    for g in got:
        assert np.isfinite(g).all()
        for b, nv in enumerate(valid):
            assert np.all(g[b, :, nv:] == 0.0)
    assert all(np.all(g[0] == 0.0) for g in got) or valid[0] > 0


def test_launch_counters_exist_and_stay_zero_on_cpu():
    _build.reset_launches()
    q, k, v, do = _inputs(1, 2, 2, 8, 8, 8, seed=3)
    tq = _t(q).requires_grad_()
    pl, vl = _lens([0], [8])
    TA.flash_attention(tq, _t(k), _t(v), pl, vl).backward(_t(do))
    assert _build.LAUNCHES["flash_attn_bwd_dq"] == 0
    assert _build.LAUNCHES["flash_attn_bwd_dkv"] == 0
    assert _build.LAUNCHES["flash_attn"] == 0


# name, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal
CARD_CASES = [
    ("causal", 2, 8, 8, 512, 512, 128, [0, 0], [512, 512], True),
    ("prefix-D64", 4, 12, 12, 128, 128, 64, [64, 10, 0, 128],
     [128, 100, 70, 128], True),
    ("ragged", 4, 8, 8, 611, 611, 128, [0] * 4, [611, 300, 1, 64], True),
    ("valid0", 3, 4, 4, 200, 200, 128, [0] * 3, [200, 0, 77], True),
    ("odd-D32", 2, 3, 3, 77, 77, 32, [5, 0], [77, 60], True),
    ("gqa4", 2, 32, 8, 320, 320, 128, [0, 100], [320, 211], True),
    ("gqaH-D64", 2, 8, 1, 130, 130, 64, [0, 30], [130, 99], True),
    ("LqLkv", 2, 4, 2, 100, 160, 64, [20, 0], [160, 90], True),
    ("noncausal", 2, 4, 4, 100, 333, 64, [0, 0], [333, 90], False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_vs_plain_on_card(cuda_device, case, dtype):
    """Kernels #8 and #9 against the plain backward on the same CUDA
    tensors (strided q/k/v, a non-contiguous dO): float32 within 2e-4 of
    each gradient's scale, bf16 within 2e-2; the same bits twice; padding
    rows exactly 0; one launch of each kernel per backward."""
    _, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal = case
    q, k, v, do = _inputs(B, H, Hkv, Lq, Lkv, D, seed=Lq, scale=1.0)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    dev = cuda_device
    tq, tk, tv = (_t(x.transpose(0, 2, 1, 3).copy(), dt, dev).transpose(1, 2)
                  for x in (q, k, v))
    tdo = _t(np.concatenate([do, do], axis=-1), dt, dev)[..., :D]
    pl, vl = _lens(prefix, valid, dev)
    scale = 1.0 / math.sqrt(D)
    out, lse = TA.flash_attention(tq, tk, tv, pl, vl, causal=causal,
                                  return_lse=True)
    _build.reset_launches()
    got = TA._launch_backward(tq, tk, tv, out, lse, tdo, pl, vl, causal,
                              scale)
    assert _build.LAUNCHES["flash_attn_bwd_dq"] == 1
    assert _build.LAUNCHES["flash_attn_bwd_dkv"] == 1
    again = TA._launch_backward(tq, tk, tv, out, lse, tdo, pl, vl, causal,
                                scale)
    torch.cuda.synchronize()
    want = TA.flash_backward_reference(tq, tk, tv, out, lse, tdo, pl, vl,
                                       causal, scale)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, a2), name
        assert a.transpose(1, 2).is_contiguous(), name
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all(), name
        assert float((a - w).abs().max()) <= tol * max(
            float(w.abs().max()), 1e-6), name
        for b, nv in enumerate(valid):
            assert float(a[b, :, nv:].abs().sum()) == 0.0, (name, b)


@pytest.mark.cuda
def test_function_launches_the_kernels_on_card(cuda_device):
    q, k, v, do = _inputs(2, 4, 2, 96, 96, 64, seed=5)
    dev = cuda_device
    tq, tk, tv = (_t(x, torch.bfloat16, dev).requires_grad_()
                  for x in (q, k, v))
    pl, vl = _lens([0, 10], [96, 50], dev)
    _build.reset_launches()
    TA.flash_attention(tq, tk, tv, pl, vl).backward(
        _t(do, torch.bfloat16, dev))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attn"] == 1
    assert _build.LAUNCHES["flash_attn_bwd_dq"] == 1
    assert _build.LAUNCHES["flash_attn_bwd_dkv"] == 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (tq, tk, tv))
