"""Port parity: the BiLSTM training pair (stair_tpu_torch/ops/lstm.py).

``bilstm_forward_train`` (the ``BiLSTMTrain`` autograd Function over the
training forward and the explicit backward) is held against the JAX
package's ``bilstm_pallas_train(..., interpret=True)`` (TPU kernels #2 and
#3 under the Pallas interpreter) on the same numpy inputs and weights:
tokens, sentence and the gradients of every parameter and of ``x``, with
non-suffix masks and an all-padding row; float32 at rtol 1e-4 / atol 1e-5,
bf16 at 2e-2 (as tests/test_lstm_pallas.py). The plain explicit backward is
held against torch autograd of ``bilstm_reference`` in float32. The CUDA
kernels are held against the plain versions on the card; the backward's
route choice, the float32 walk's batch tile and the cluster kernels'
shared-memory limits are checked on the CPU.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import lstm as TL
from stair_tpu_torch.weights import params_from_numpy
from torch_port_util import cuda_device, to_numpy_tree  # noqa: F401

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.ops import lstm as JL
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")


def _data(B, L, D, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, D).astype(np.float32)
    mask = (np.arange(L)[None] < rng.randint(1, L + 1, size=(B, 1)))
    mask = mask.astype(np.float32) * (rng.rand(B, L) > 0.3)   # holes
    mask[:, 0] = 1.0
    mask[2] = 0.0                                             # all padding
    return x, mask, rng


@needs_jax
@pytest.mark.parametrize("bf16", [False, True])
def test_bilstm_train_matches_jax_pallas_train(bf16):
    B, L, D, h = 6, 7, 10, 16
    x, mask, rng = _data(B, L, D, seed=4)
    p = JL.init_lstm_params(jax.random.PRNGKey(3), D, h)
    gt = rng.randn(B, L, 2 * h).astype(np.float32)
    gs = rng.randn(B, 2 * h).astype(np.float32)
    jmm, jtd = (jnp.bfloat16, jnp.bfloat16) if bf16 else (None, jnp.float32)

    def jloss(p, x):
        tok, sent = JL.bilstm_pallas_train(
            p, x, jnp.asarray(mask), mm_dtype=jmm, interpret=True,
            block_batch=8, token_dtype=jtd)
        return (jnp.sum(tok.astype(jnp.float32) * gt) + jnp.sum(sent * gs),
                (tok, sent))

    (jv, (jtok, jsent)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))

    tp = {d: {k: v.requires_grad_(True) for k, v in leaves.items()}
          for d, leaves in params_from_numpy(to_numpy_tree(p)).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    dt = torch.bfloat16 if bf16 else torch.float32
    tok, sent, _ = TL.bilstm_forward_train(
        tp, tx, torch.from_numpy(mask), mm_dtype=dt if bf16 else None,
        token_dtype=dt)
    loss = (tok.float() * torch.from_numpy(gt)).sum() + (
        sent * torch.from_numpy(gs)).sum()
    loss.backward()

    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(jv), float(loss.detach()), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jtok, np.float32),
                               tok.detach().float().numpy(), **tol)
    np.testing.assert_allclose(np.asarray(jsent), sent.detach().numpy(),
                               **tol)
    assert np.abs(tok.detach().float().numpy()[2]).max() == 0.0
    np.testing.assert_allclose(np.asarray(jgx), tx.grad.numpy(), **tol)
    for d in ("fwd", "bwd"):
        for k in ("wi", "wh", "bi", "bh"):
            np.testing.assert_allclose(
                np.asarray(jgp[d][k]), tp[d][k].grad.numpy(), **tol,
                err_msg=f"{d}/{k}")


def test_bilstm_bwd_reference_matches_autograd_f32():
    """The explicit adjoint recurrence equals torch autograd of the plain
    forward (non-suffix masks, an all-padding row)."""
    B, L, D, h = 5, 8, 6, 8
    x, mask, _ = _data(B, L, D, seed=9)
    gen = torch.Generator().manual_seed(0)
    p = TL.init_lstm_params(gen, D, h)
    args = TL._prep(p, torch.from_numpy(x), torch.from_numpy(mask))
    leaves = [a.clone().requires_grad_(i in (0, 1, 3, 4))
              for i, a in enumerate(args)]
    out = TL.bilstm_reference(*leaves)
    cots = [torch.randn(o.shape, generator=gen) for o in out]
    torch.autograd.backward(out, cots)
    _, _, _, stacks = TL.bilstm_reference(*args, return_stacks=True)
    dxp_f, dxp_b, dwh_f, dwh_b, _, _ = TL.bilstm_bwd_reference(
        *args, stacks, *cots)
    for mine, leaf in ((dxp_f, 0), (dxp_b, 1), (dwh_f, 3), (dwh_b, 4)):
        torch.testing.assert_close(mine, leaves[leaf].grad, rtol=1e-4,
                                   atol=1e-5)


def test_bilstm_train_wrappers_route_cpu_to_plain_and_reject_others():
    gen = torch.Generator().manual_seed(0)
    p = TL.init_lstm_params(gen, 6, 4)
    args = TL._prep(p, torch.randn(3, 5, 6, generator=gen), torch.ones(3, 5))
    out = TL.bilstm_train_call(*args)
    ref = TL.bilstm_reference(*args, return_stacks=True)
    for a, b in zip(out[:3] + out[3], ref[:3] + ref[3]):
        assert torch.equal(a, b)
    cots = (torch.ones(3, 5, 4), torch.ones(3, 5, 4), torch.ones(3, 8))
    bwd = TL.bilstm_bwd_call(*args, out[3], *cots)
    for a, b in zip(bwd, TL.bilstm_bwd_reference(*args, out[3], *cots)):
        assert torch.equal(a, b)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        TL.bilstm_train_call(*meta)
    with pytest.raises(ValueError):
        TL.bilstm_bwd_call(*meta, [s.to("meta") for s in out[3]],
                           *[c.to("meta") for c in cots])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_train_kernels_vs_plain_on_card(cuda_device, dtype):
    """Training forward (with stacks) and backward kernels vs the plain
    versions; B not a multiple of the row tile; the backward twice gives
    identical bits."""
    gen = torch.Generator().manual_seed(2)
    B, L, D, h = 37, 12, 20, 64
    x, mask, _ = _data(B, L, D, seed=6)
    p = TL.init_lstm_params(gen, D, h, device=cuda_device)
    mm = None if dtype == torch.float32 else dtype
    args = TL._prep(p, torch.from_numpy(x).to(cuda_device),
                    torch.from_numpy(mask).to(cuda_device), mm)
    out = TL.bilstm_train_call(*args, token_dtype=dtype)
    ref = TL.bilstm_reference(*args, token_dtype=dtype, return_stacks=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(out[:3] + out[3], ref[:3] + ref[3]):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    cots = [torch.randn(B, L, h, generator=gen).to(cuda_device, dtype)
            for _ in range(2)] + [torch.randn(B, 2 * h, generator=gen)
                                  .to(cuda_device)]
    k1 = TL.bilstm_bwd_call(*args, out[3], *cots)
    k2 = TL.bilstm_bwd_call(*args, out[3], *cots)
    rb = TL.bilstm_bwd_reference(*args, out[3], *cots)
    for a, b, r in zip(k1, k2, rb):
        assert torch.equal(a, b)
        scale = float(r.float().abs().max())
        torch.testing.assert_close(a.float(), r.float(), rtol=tol,
                                   atol=tol * scale)


# The backward's route, chosen before any launch: the cluster kernel takes
# bf16 at h a multiple of 64 up to TC_MAX_H (the main path's h = 256), the
# float32 cluster kernel float32 at h a multiple of 32 from 64 up to
# F32_MAX_H (the parser's h 128, the float32 NMN's h 256), the general
# kernel everything else.
ROUTE_CASES = [
    (torch.float32, 16, "general"), (torch.float32, 64, "cluster32"),
    (torch.float32, 256, "cluster32"), (torch.float32, 512, "general"),
    (torch.float32, 100, "general"), (torch.float32, 128, "cluster32"),
    (torch.float32, 192, "cluster32"), (torch.float32, 320, "general"),
    (torch.bfloat16, 16, "general"), (torch.bfloat16, 64, "cluster"),
    (torch.bfloat16, 100, "general"), (torch.bfloat16, 128, "cluster"),
    (torch.bfloat16, 192, "cluster"), (torch.bfloat16, 256, "cluster"),
    (torch.bfloat16, 320, "general"), (torch.bfloat16, 512, "general"),
]


@pytest.mark.parametrize("dtype,h,route", ROUTE_CASES,
                         ids=[f"{str(d)[6:]}-h{h}" for d, h, _ in ROUTE_CASES])
def test_bilstm_bwd_route_choice(dtype, h, route):
    assert TL.bwd_route(dtype, h) == route


def _tc_smem_bytes(h, c):
    """Per-CTA shared memory of the cluster kernel at hidden size ``h``, as
    ``csrc/bilstm.cu tc_smem_bytes`` computes it from the same constants:
    the ``[h, h]`` wh slice and ``[8, h]`` dgates in bf16, three ``[8, h]``
    float32 buffers, and two stages of one step's inputs (float32
    ``h_{t-1}``, ``c_t``, ``c_{t-1}``, mask; bf16 xp and dtok), rows
    padded."""
    bt, u = c["BT"], h // 4
    stage = 4 * bt * (h + c["TC_FPAD"] + 2 * u + 1) + 2 * bt * (h + u)
    return (2 * (h + bt) * (h + c["TC_PAD"])
            + 4 * 3 * bt * (h + c["TC_FPAD"]) + 2 * stage)


@pytest.mark.parametrize("h", [64, 128, 192, 256])
def test_bilstm_bwd_cluster_smem_fits_one_cta(h):
    """Every h the cluster route takes fits the 232,448 bytes a block may
    use; the limit is TC_MAX_H of csrc/bilstm.cu, read as the kernel reads
    it, and the next multiple of 64 would not fit."""
    c = _build.header_ints("bilstm.cu")
    assert h <= c["TC_MAX_H"]
    assert TL.bwd_route(torch.bfloat16, h) == "cluster"
    assert _tc_smem_bytes(h, c) <= 232448
    assert _tc_smem_bytes(c["TC_MAX_H"] + 64, c) > 232448
    assert c["TC_CLUSTER"] * (h // c["TC_CLUSTER"]) == h


def _f32_bwd_smem_bytes(h, bt, c):
    """Per-CTA shared memory of the float32 cluster walk, as ``csrc/
    bilstm.cu f32_bwd_smem_bytes`` computes it: the transposed ``[4 U, h]``
    wh slice, two ``[bt, h]`` partial buffers and one ``[bt, h]`` stage of
    h_{t-1} (rows padded by ``F32_PAD``), and the local dgates ``[bt, 4 U +
    F32_PAD]``, float32."""
    u, pad = c["F32_U"], c["F32_PAD"]
    return 4 * ((4 * u + 3 * bt) * (h + pad) + bt * (4 * u + pad))


@pytest.mark.parametrize("h", list(range(64, 257, 32)))
def test_bilstm_bwd_f32_cluster_smem_fits_one_cta(h):
    """Every h the float32 cluster walk takes, at the largest tile it is
    compiled for (and every smaller one), fits the 232,448 bytes a block may
    use, on a cluster of h / F32_U <= 8 CTAs; the walk's range is the
    float32 forward's, and h past F32_MAX_H takes the general route."""
    c = _build.header_ints("bilstm.cu")
    assert TL.bwd_route(torch.float32, h) == "cluster32"
    assert TL.fwd_route(torch.float32, h) == "cluster32"
    assert 2 <= h // c["F32_U"] <= 8 and h % c["F32_U"] == 0
    assert TL.bwd_tiles() == list(range(
        c["F32B_BT_MIN"], c["F32B_BT_MAX"] + 1, c["F32B_BT_MIN"]))
    assert TL.bwd_tiles()[-1] == c["F32B_BT_MAX"]
    for bt in TL.bwd_tiles():
        assert bt % 4 == 0   # F32_WARPS rows apart, a lane per unit
        assert _f32_bwd_smem_bytes(h, bt, c) <= 232448, bt
    assert TL.bwd_route(torch.float32, c["F32_MAX_H"] + c["F32_U"]) == \
        "general"


# B, clusters the card holds with one CTA an SM, the tile: the smallest
# tile whose 2 ceil(B / tile) clusters run in one wave, else the largest
# (the parser's B 64 on 30 four-CTA clusters takes 8, the float32 NMN's B
# 128 on 15 eight-CTA clusters 24)
BWD_TILE_CASES = [(64, 30, 8), (128, 15, 24), (125, 15, 24), (128, 16, 16),
                  (128, 32, 8), (1024, 15, 24), (1, 2, 8), (64, 0, 24),
                  (120, 30, 8), (121, 30, 16)]


@pytest.mark.parametrize("B,clusters,tile", BWD_TILE_CASES,
                         ids=[f"B{b}-c{c}" for b, c, _ in BWD_TILE_CASES])
def test_bilstm_bwd_f32_tile_choice(B, clusters, tile):
    c = _build.header_ints("bilstm.cu")
    got = TL.bwd_tile(B, clusters)
    assert got == tile
    assert got % c["F32B_BT_MIN"] == 0 and got <= c["F32B_BT_MAX"]
    if got < c["F32B_BT_MAX"]:   # one wave, and no smaller tile gives one
        assert 2 * -(-B // got) <= clusters
        smaller = got - c["F32B_BT_MIN"]
        assert smaller == 0 or 2 * -(-B // smaller) > clusters


# name, B, L, D, h: the float32 NMN's video and question encoders at the
# train step's B 128, the parser's training batch, and a ragged B at an h of
# six-CTA clusters
F32_BWD_CASES = [("video", 128, 64, 1024, 256), ("question", 128, 16, 300, 256),
                 ("parser", 64, 32, 256, 128), ("ragged-B", 125, 20, 64, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_BWD_CASES,
                         ids=[c[0] for c in F32_BWD_CASES])
def test_bilstm_bwd_f32_cluster_vs_plain_and_general_on_card(cuda_device,
                                                             case):
    """The float32 cluster walk, with holes in the masks and an all-padding
    row: each output within 1e-4 (max |a - b| / max |b|) of the plain
    backward and of the general route; two launches give the same bits; dxp
    at each row's first valid step of the walk equals the general route's
    bit for bit; only its launch keys count."""
    from stair_tpu_torch.scripts.bilstm_bwd_tiles import first_steps_equal

    _, B, L, D, h = case
    gen = torch.Generator().manual_seed(17)
    x, mask, _ = _data(B, L, D, seed=B + L)
    p = TL.init_lstm_params(gen, D, h, device=cuda_device)
    args = TL._prep(p, torch.from_numpy(x).to(cuda_device),
                    torch.from_numpy(mask).to(cuda_device))
    stacks = TL.bilstm_train_call(*args)[3]
    cots = [torch.randn(B, L, h, generator=gen).to(cuda_device)
            for _ in range(2)] + [torch.randn(B, 2 * h, generator=gen)
                                  .to(cuda_device)]
    assert TL.bwd_route(torch.float32, h) == "cluster32"
    _build.reset_launches()
    k1 = TL.bilstm_bwd_call(*args, stacks, *cots)
    k2 = TL.bilstm_bwd_call(*args, stacks, *cots)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "bilstm_bwd_f32c": 2, "bilstm_dwh_f32c": 2, "bilstm_dwh_sum": 2}
    pick = TL.bwd_route
    TL.bwd_route = lambda dtype, hh: "general"
    try:
        gb = TL.bilstm_bwd_call(*args, stacks, *cots)
    finally:
        TL.bwd_route = pick
    rb = TL.bilstm_bwd_reference(*args, stacks, *cots)
    for a, b, g, r in zip(k1, k2, gb, rb):
        assert torch.equal(a, b)
        for want in (r, g):
            scale = max(float(want.abs().max()), 1e-12)
            assert float((a - want).abs().max()) / scale <= 1e-4
    assert first_steps_equal(k1, gb, args[2])
    assert float(k1[0][2].abs().max()) == 0.0    # the all-padding row


# name, B, L, D: the main path's video and question encoders at B 128, and
# a batch that is not a multiple of the 8-row tile
CLUSTER_CASES = [("video", 128, 64, 1024), ("question", 128, 16, 300),
                 ("ragged-B", 125, 20, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLUSTER_CASES, ids=[c[0] for c in CLUSTER_CASES])
def test_bilstm_bwd_cluster_kernel_vs_plain_on_card(cuda_device, case):
    """The cluster route at h 256 in bf16 against the plain backward, with
    holes and an all-padding row: within 2e-2 of each gradient's largest
    value; a second run gives the same bits; its three launch keys, none of
    the general route."""
    _, B, L, D = case
    h, dt = 256, torch.bfloat16
    gen = torch.Generator().manual_seed(11)
    x, mask, _ = _data(B, L, D, seed=B + L)
    p = TL.init_lstm_params(gen, D, h, device=cuda_device)
    args = TL._prep(p, torch.from_numpy(x).to(cuda_device),
                    torch.from_numpy(mask).to(cuda_device), dt)
    out = TL.bilstm_train_call(*args, token_dtype=dt)
    cots = [torch.randn(B, L, h, generator=gen).to(cuda_device, dt)
            for _ in range(2)] + [torch.randn(B, 2 * h, generator=gen)
                                  .to(cuda_device)]
    _build.reset_launches()
    k1 = TL.bilstm_bwd_call(*args, out[3], *cots)
    k2 = TL.bilstm_bwd_call(*args, out[3], *cots)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bilstm_bwd_tc"] == 2
    assert _build.LAUNCHES["bilstm_dwh_tc"] == 2
    assert _build.LAUNCHES["bilstm_dwh_sum"] == 2
    assert _build.LAUNCHES["bilstm_bwd"] == 0
    rb = TL.bilstm_bwd_reference(*args, out[3], *cots)
    for a, b, r in zip(k1, k2, rb):
        assert torch.equal(a, b)
        scale = float(r.float().abs().max())
        torch.testing.assert_close(a.float(), r.float(), rtol=2e-2,
                                   atol=2e-2 * scale)
    assert float(k1[0][2].abs().max()) == 0.0    # the all-padding row
