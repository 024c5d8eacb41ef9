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
from stair_tpu_torch.scripts import flash_bwd_tiles
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
    # valid_len at the edges of the 64-row query tiles and 64- or 128-row
    # key blocks of the tensor-core kernels
    ("tile-edges", 6, 4, 4, 160, 160, 128, [0] * 6,
     [63, 64, 65, 127, 128, 129], True),
    ("tile-edges-D64", 6, 4, 2, 160, 160, 64, [0, 0, 70, 0, 0, 0],
     [63, 64, 65, 127, 128, 129], True),
    ("gqa32", 2, 32, 1, 200, 200, 128, [0, 50], [200, 131], True),
    ("noncausal-D128", 2, 4, 2, 130, 70, 128, [0, 0], [70, 50], False),
    # the float32 LLM trainer CLIs' backward shapes: with_video_lm's video
    # backward (the video-visible prefix) and its reply backward, with
    # ragged valid_len
    ("with_video_lm-video", 32, 8, 8, 214, 214, 64, [150] * 32,
     [214 - (11 * i) % 97 for i in range(32)], True),
    ("with_video_lm-reply", 32, 8, 8, 214, 214, 64, [0] * 32,
     [214 - (13 * i) % 89 for i in range(32)], True),
]
#: the float32 cases the split-TF32 kernels take (head_dim 64 or 128;
#: every card case's rows are 16-byte aligned)
MMA32_CASES = [c for c in CARD_CASES if c[6] in (64, 128)]


def _want_route(dtype, D):
    """The route ``route`` gives a card case (aligned rows)."""
    if D not in (64, 128):
        return "simple"
    return "mma32" if dtype in ("float32", torch.float32) else "mma"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_vs_plain_on_card(cuda_device, case, dtype):
    """Kernels #8 and #9 against the plain backward on the same CUDA
    tensors (strided q/k/v, a non-contiguous dO), on the route ``route``
    picks (float32 at head_dim 64 / 128: ``"mma32"``): float32 within 2e-4
    of each gradient's scale, bf16 within 2e-2; the same bits twice;
    padding rows exactly 0; one launch of each kernel per backward."""
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
    TA.reset_route_launches()
    got = TA._launch_backward(tq, tk, tv, out, lse, tdo, pl, vl, causal,
                              scale)
    assert _build.LAUNCHES["flash_attn_bwd_dq"] == 1
    assert _build.LAUNCHES["flash_attn_bwd_dkv"] == 1
    route = _want_route(dtype, D)
    assert TA.BWD_ROUTE_LAUNCHES[route] == 2, TA.BWD_ROUTE_LAUNCHES
    assert sum(TA.BWD_ROUTE_LAUNCHES.values()) == 2
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
@pytest.mark.parametrize("case", MMA32_CASES, ids=[c[0] for c in MMA32_CASES])
def test_mma32_vs_simple_and_itself_on_card(cuda_device, case):
    """The float32 split-TF32 backward against the forced ``"simple"``
    backward (the FMA kernels) on the same inputs, each gradient within
    2e-4 of its scale, and against itself on a second launch (equal bits:
    no atomics)."""
    _, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal = case
    tq, tk, tv, out, lse, tdo, pl, vl = _card_inputs(case, torch.float32,
                                                     cuda_device)
    scale = 1.0 / math.sqrt(D)
    got = TA._launch_backward(tq, tk, tv, out, lse, tdo, pl, vl, causal,
                              scale, route="mma32")
    again = TA._launch_backward(tq, tk, tv, out, lse, tdo, pl, vl, causal,
                                scale, route="mma32")
    simple = TA._launch_backward(tq, tk, tv, out, lse, tdo, pl, vl, causal,
                                 scale, route="simple")
    torch.cuda.synchronize()
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, simple):
        assert torch.equal(a, a2), name
        assert float((a - w).abs().max()) <= 2e-4 * max(
            float(w.abs().max()), 1e-6), name


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


def _card_inputs(case, dtype, dev):
    _, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal = case
    q, k, v, do = _inputs(B, H, Hkv, Lq, Lkv, D, seed=Lq + 1, scale=1.0)
    tq, tk, tv = (_t(x.transpose(0, 2, 1, 3).copy(), dtype, dev)
                  .transpose(1, 2) for x in (q, k, v))
    pl, vl = _lens(prefix, valid, dev)
    out, lse = TA.flash_attention(tq, tk, tv, pl, vl, causal=causal,
                                  return_lse=True)
    return tq, tk, tv, out, lse, _t(do, dtype, dev), pl, vl


DI_CASES = [c for c in CARD_CASES
            if c[0] in ("causal", "ragged", "valid0", "odd-D32", "gqa4",
                        "tile-edges-D64", "noncausal-D128")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DI_CASES, ids=[c[0] for c in DI_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_di_written_by_the_dq_launch_on_card(cuda_device, case, dtype):
    """The dQ launch writes ``di = rowsum(f32(O) f32(dO))``: within 1e-5 of
    each live row's sum of ``|O dO|`` (float32 sums in another order) of
    ``reference_di``, exactly 0 on padding rows."""
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    tq, tk, tv, out, lse, tdo, pl, vl = _card_inputs(case, dt, cuda_device)
    D = tq.shape[-1]
    args, _, keep = TA._backward_args(tq, tk, tv, out, lse, tdo, pl, vl,
                                      case[-1], 1.0 / math.sqrt(D))
    assert TA.ROUTES[args.route] == _want_route(dtype, D)
    TA._launch_dq(args, cuda_device)
    torch.cuda.synchronize()
    got = keep["di"]
    want = TA.reference_di(out, tdo, vl)
    scale = TA.reference_di(out.float().abs(), tdo.float().abs(), vl)
    assert torch.isfinite(got).all()
    assert float(((got - want).abs() / scale.clamp(min=1e-30)).max()) <= 1e-5
    for b, nv in enumerate(case[8]):
        assert float(got[b, :, nv:].abs().sum()) == 0.0, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_backward_is_two_launches_on_card(cuda_device, dtype):
    """One ``_launch_backward`` call is the dQ launch then the dK/dV launch
    of the route's kernels (float32: ``flash_bwd_dq_mma32``,
    ``flash_bwd_dkv_mma32``; bf16: ``flash_bwd_dq_mma``,
    ``flash_bwd_dkv_mma``) and nothing else on the device
    (``torch.profiler`` device events): no eager ``di``, no copies."""
    from torch.profiler import ProfilerActivity, profile

    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    case = CARD_CASES[0]
    tq, tk, tv, out, lse, tdo, pl, vl = _card_inputs(case, dt, cuda_device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        TA._launch_backward(tq, tk, tv, out, lse, tdo, pl, vl, True,
                            1.0 / math.sqrt(tq.shape[-1]))
        torch.cuda.synchronize()
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2, names
    sfx = "_mma32" if dt == torch.float32 else "_mma"
    assert f"flash_bwd_dq{sfx}" in names[0], names
    assert f"flash_bwd_dkv{sfx}" in names[1], names
    if dt == torch.bfloat16:
        assert not any("mma32" in n for n in names), names


# dtype, head_dim, aligned -> route
ROUTES = [
    (torch.bfloat16, 64, True, "mma"),
    (torch.bfloat16, 128, True, "mma"),
    (torch.bfloat16, 128, False, "simple"),
    (torch.bfloat16, 96, True, "simple"),
    (torch.bfloat16, 32, True, "simple"),
    (torch.float32, 64, True, "mma32"),
    (torch.float32, 128, True, "mma32"),
    (torch.float32, 64, False, "simple"),
    (torch.float32, 40, True, "simple"),
]


@pytest.mark.parametrize(
    "route", ROUTES,
    ids=[f"{str(r[0])[6:]}-D{r[1]}-{'al' if r[2] else 'un'}" for r in ROUTES])
def test_kernel_route_choice(route):
    """The backward's route, ``route`` (the forward's too): the bf16
    tensor-core kernels for bf16 at head_dim 64 / 128 on aligned rows, the
    split-TF32 kernels for float32 there, the FMA kernels for every other
    shape (unaligned float32 rows included)."""
    dtype, D, aligned, want = route
    assert TA.route(dtype, D, aligned) == want


def test_backward_route_codes_match_the_source():
    """The backward's argument block carries the route code (``ROUTES``,
    in the order of ``ROUTE_*`` in flash_common.cuh) where it carried the
    mma flag."""
    codes = _build.header_ints("flash_common.cuh")
    assert [codes[f"ROUTE_{r.upper()}"] for r in TA.ROUTES] == [0, 1, 2]
    fields = [f for f, _ in TA._BwdArgs._fields_]
    assert fields[-2:] == ["route", "sm_scale"] and "mma" not in fields


@pytest.mark.parametrize("layout", ["q-offset", "dout-row-stride"])
def test_forced_mma32_backward_on_unaligned_rows_raises(monkeypatch, layout):
    """float32 q, k, v one element past 16 bytes, or dO rows of D + 1
    floats, take the ``"simple"`` backward; a forced ``"mma32"`` raises
    before anything is launched or built."""
    def no_build():
        raise AssertionError("built or launched a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    B, H, L, D = 2, 3, 8, 64
    off = 1 if layout == "q-offset" else 0
    q, k, v = (torch.randn(B * H * L * D + off)[off:].view(B, H, L, D)
               for _ in range(3))
    dout = torch.randn(B, H, L, D + 1 - off)[..., :D]
    pl, vl = _lens([0, 2], [8, 5])
    out, lse = TA.reference_attention(q, k, v, pl, vl)
    assert TA._route_of(q, k, v, out, dout) == "simple"
    with pytest.raises(ValueError, match="route 'mma32' does not take"):
        TA._launch_backward(q, k, v, out, lse, dout, pl, vl, True, 0.125,
                            route="mma32")
    with pytest.raises(ValueError, match="route 'mma' does not take"):
        TA._backward_args(q, k, v, out, lse, dout, pl, vl, True, 0.125,
                          route="mma")


#: the card's shared memory: per block, and per SM (each block reserves
#: 1 KB of it)
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024


@pytest.mark.parametrize("tile", [None, *flash_bwd_tiles.CANDIDATES.values()],
                         ids=["source", *flash_bwd_tiles.CANDIDATES])
@pytest.mark.parametrize("D", [64, 128])
def test_backward_shared_memory_fits(tile, D):
    """Every compiled tile of the tensor-core kernels (the source's and the
    tile script's candidates) fits a block's shared memory, and as many
    blocks as it is designed for fit one SM."""
    tile = tile or flash_bwd_tiles.source_tile(D)
    dq, dkv = flash_bwd_tiles.smem_bytes(D, tile)
    warps, mq, minb = tile
    assert mq % 16 == 0 and warps in (4, 8)
    assert dq <= SMEM_BLOCK and dkv <= SMEM_BLOCK
    assert 2 * (dq + SMEM_RESERVED) <= SMEM_SM     # dQ: two blocks per SM
    assert minb * (dkv + SMEM_RESERVED) <= SMEM_SM
    # the source's arithmetic at the first port's tiles
    assert flash_bwd_tiles.smem_bytes(128, (4, 32, 2))[1] == (
        (2 * 64 + 4 * 32) * 136 * 2 + 512)
    assert dq == (2 * 64 + 4 * 64) * (D + 8) * 2 + 256


@pytest.mark.parametrize("cands", ["source", *flash_bwd_tiles.CANDIDATES32])
@pytest.mark.parametrize("D", [64, 128])
def test_mma32_backward_shared_memory_fits(cands, D):
    """``flash_bwd_dq_mma32<D>`` and ``flash_bwd_dkv_mma32<D>`` (the
    source's constants and each float32 candidate of the tile script):
    shared memory per block from the source's constants fits a block's
    227 KB, and the blocks per SM each is designed for fit an SM's 228 KB
    (1 KB reserved a block)."""
    consts = None if cands == "source" else flash_bwd_tiles.CANDIDATES32[
        cands]
    for smem, blocks in TA.mma32_bwd_smem_bytes(D, consts):
        assert smem <= SMEM_BLOCK
        assert blocks in (1, 2, 3)
        assert blocks * (smem + SMEM_RESERVED) <= SMEM_SM
    if consts is None:
        (dq, dq_blocks), (dkv, dkv_blocks) = TA.mma32_bwd_smem_bytes(D)
        # three blocks an SM at D 64, two at D 128
        assert dq_blocks == dkv_blocks == {64: 3, 128: 2}[D]
        # the source's arithmetic: Q, dO, the K / V rings, di; K, V, the
        # Q / dO rings, the lse / di rings (rows of D + 4 floats)
        c = _build.header_ints("flash_attn_bwd.cu")
        kv, mq = c[f"DQ32_KV_D{D}"], c[f"DKV32_MQ_D{D}"]
        bkv = 16 * c[f"DKV32_WARPS_D{D}"]
        assert dq == 4 * ((2 * 64 + 4 * kv) * (D + 4) + 64)
        assert dkv == 4 * ((2 * bkv + 4 * mq) * (D + 4) + 4 * mq)


def test_tile_script_rewrites_the_float32_constants():
    """Every float32 candidate of the tile script rewrites the
    ``DQ32_*`` / ``DKV32_*`` constants it names, and nothing else."""
    have = _build.header_ints("flash_attn_bwd.cu")
    for name, consts in flash_bwd_tiles.CANDIDATES32.items():
        text = flash_bwd_tiles.source_with(consts)
        for key, val in consts.items():
            assert key.startswith(("DQ32_", "DKV32_")), key
            assert f"constexpr int {key} = {val};" in text, (name, key)
        for key, val in have.items():
            if key not in consts:
                assert f"constexpr int {key} = {val};" in text, (name, key)
    with pytest.raises(RuntimeError, match="no longer has"):
        flash_bwd_tiles.source_with({"DQ32_KV_D64": 8,
                                     "NOT_A_CONSTANT": 1})


def test_tile_script_rewrites_the_source_tile():
    text = flash_bwd_tiles.tile_source((8, 64, 1))
    for d in (64, 128):
        assert f"constexpr int DKV_WARPS_D{d} = 8;" in text
        assert f"constexpr int DKV_MQ_D{d} = 64;" in text
        assert f"constexpr int DKV_MINB_D{d} = 1;" in text
    assert text.count("constexpr int DKV_") == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_backward_args_allocate_di_and_compute_nothing(monkeypatch, dtype):
    """``_backward_args`` allocates the ``di`` buffer that the dQ launch
    fills and runs no arithmetic of its own (no eager ``di``): every aten
    op it runs is an allocation or a view."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(TA, "_check", lambda *a: None)
    B, H, Hkv, L, D = 2, 4, 2, 24, 64
    q, k, v, do = _inputs(B, H, Hkv, L, L, D, seed=4)
    tq, tk, tv, tdo = (_t(x.transpose(0, 2, 1, 3).copy(), dtype)
                       .transpose(1, 2) for x in (q, k, v, do))
    pl, vl = _lens([0, 3], [24, 17])
    out, lse = TA.reference_attention(tq, tk, tv, pl, vl)
    with Ops() as ops:
        args, grads, keep = TA._backward_args(tq, tk, tv, out, lse, tdo, pl,
                                              vl, True, 0.125)
    assert set(ops.names) <= {"empty", "transpose"}, ops.names
    di = keep["di"]
    assert di.shape == (B, H, L) and di.dtype == torch.float32
    assert args.di == di.data_ptr() and args.o == out.data_ptr()
    assert (args.o_sb, args.o_sh, args.o_sl) == out.stride()[:3]
    assert TA.ROUTES[args.route] == (
        "mma" if dtype == torch.bfloat16 else "mma32")
    assert [g.shape for g in grads] == [tq.shape, tk.shape, tv.shape]


def test_reference_di_reads_padding_rows_as_zero():
    rng = np.random.RandomState(8)
    out = rng.randn(2, 3, 7, 5).astype(np.float32)
    do = rng.randn(2, 3, 7, 5).astype(np.float32)
    do[1, :, 4:] = np.nan
    got = TA.reference_di(_t(out), _t(do), torch.tensor([7, 4])).numpy()
    want = (out.astype(np.float64) * do).sum(-1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1, :, :4], want[1, :, :4], rtol=1e-5,
                               atol=1e-6)
    assert np.all(got[1, :, 4:] == 0.0)


def test_ptxas_report_names_kernels_and_spills():
    """``chip_smoke.py`` and the tile script read registers and spills per
    kernel from the build log with ``_build.ptxas_report``."""
    dkv = ("_ZN5stair17flash_bwd_dkv_mmaILi128ELi4ELi32ELi2EEEv"
           "NS_12FlashBwdArgsE")
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{dkv}' for 'sm_90a'",
        f"ptxas info    : Function properties for {dkv}",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN5stair19flash_bwd_dq_simpleI13__nv_bfloat16EEvNS_12FlashBwdArgsE'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, "
        "528 bytes cmem[0]",
    ])
    assert _build.ptxas_report(log) == [
        {"kernel": "flash_bwd_dkv_mma<128, 4, 32, 2>", "spill_stores": 8,
         "spill_loads": 12, "registers": 255},
        {"kernel": "flash_bwd_dq_simple<__nv_bfloat16>", "spill_stores": 0,
         "spill_loads": 0, "registers": 168},
    ]
    assert _build.kernel_label(
        "_ZN5stair16flash_bwd_dq_mmaILi64EEEvNS_12FlashBwdArgsE") == (
        "flash_bwd_dq_mma<64>")
    assert _build.kernel_label("not_mangled") == "not_mangled"


def test_ab_script_runs_checkouts_in_turns():
    """``scripts/attention_bwd_ab.py`` compares checkouts in turns on one
    card: A B B A."""
    from stair_tpu_torch.scripts import attention_bwd_ab

    assert attention_bwd_ab.turn_order(["a", "b"], 2) == ["a", "b", "b", "a"]
    assert attention_bwd_ab.turn_order(["a"], 3) == ["a", "a", "a"]
