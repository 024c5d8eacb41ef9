"""Port parity: the BiLSTM recurrence (stair_tpu_torch/ops/lstm.py).

``bilstm_reference`` over ``_prep``'s hoisted projection is held against
the JAX package's ``jax.vmap(bilstm)`` (the scan) and against
``bilstm_pallas(..., interpret=True)`` (the TPU kernel under the Pallas
interpreter) on the same numpy inputs and weights: float32 at rtol/atol
2e-5, bf16 matmuls at 2e-2 (as tests/test_lstm_pallas.py). Masks need not
be a suffix, and an all-padding row gives zero tokens and a zero sentence.
The CUDA kernels are held against the plain version on the card (the
float32 cluster route also against the general route, bit for bit); the
forward's route and batch-tile choices and the cluster kernels' shared
memory are checked on the CPU.
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


def _data(B, L, D, seed, holes=False, empty_row=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, D).astype(np.float32)
    lens = rng.randint(1, L + 1, size=B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    if holes:   # non-suffix masks: padding in the middle too
        mask *= (rng.rand(B, L) > 0.3)
        mask[:, 0] = 1.0
    if empty_row is not None:
        mask[empty_row] = 0.0
    return x, mask


def _port(params, x, mask, mm_dtype, token_dtype):
    tp = params_from_numpy(to_numpy_tree(params))
    tok_f, tok_b, sent = TL.bilstm(
        *TL._prep(tp, torch.from_numpy(x), torch.from_numpy(mask),
                  mm_dtype), token_dtype=token_dtype)
    tokens = torch.cat([tok_f, tok_b], -1).float().numpy()
    return tokens, sent.numpy()


CASES = [
    # B, L, D, h, non-suffix mask, all-padding row
    (5, 9, 12, 8, False, None),
    (6, 7, 10, 16, True, None),
    (4, 6, 10, 8, False, 2),
]


@needs_jax
@pytest.mark.parametrize("B,L,D,h,holes,empty", CASES)
def test_bilstm_reference_f32_vs_jax_scan(B, L, D, h, holes, empty):
    p = JL.init_lstm_params(jax.random.PRNGKey(B), D, h)
    x, mask = _data(B, L, D, seed=B, holes=holes, empty_row=empty)
    ref_t, ref_s = jax.vmap(lambda xx, mm: JL.bilstm(p, xx, mm))(
        jnp.asarray(x), jnp.asarray(mask))
    tok, sent = _port(p, x, mask, None, torch.float32)
    np.testing.assert_allclose(np.asarray(ref_t), tok, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ref_s), sent, rtol=2e-5, atol=2e-5)
    if empty is not None:
        assert np.abs(tok[empty]).max() == 0.0
        assert np.abs(sent[empty]).max() == 0.0


@needs_jax
@pytest.mark.parametrize("holes", [False, True])
def test_bilstm_reference_f32_vs_pallas_interpret(holes):
    B, L, D, h = 6, 8, 12, 8
    p = JL.init_lstm_params(jax.random.PRNGKey(7), D, h)
    x, mask = _data(B, L, D, seed=11, holes=holes, empty_row=1)
    ref_t, ref_s = JL.bilstm_pallas(p, jnp.asarray(x), jnp.asarray(mask),
                                    interpret=True, block_batch=8)
    tok, sent = _port(p, x, mask, None, torch.float32)
    np.testing.assert_allclose(np.asarray(ref_t), tok, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ref_s), sent, rtol=2e-5, atol=2e-5)


@needs_jax
def test_bilstm_reference_bf16_vs_jax_scan_and_pallas():
    B, L, D, h = 7, 10, 20, 16
    p = JL.init_lstm_params(jax.random.PRNGKey(2), D, h)
    x, mask = _data(B, L, D, seed=3, holes=True, empty_row=4)
    ref_t, ref_s = jax.vmap(
        lambda xx, mm: JL.bilstm(p, xx, mm, mm_dtype=jnp.bfloat16)
    )(jnp.asarray(x), jnp.asarray(mask))
    pal_t, pal_s = JL.bilstm_pallas(
        p, jnp.asarray(x), jnp.asarray(mask), mm_dtype=jnp.bfloat16,
        interpret=True, block_batch=8, token_dtype=jnp.bfloat16)
    tok, sent = _port(p, x, mask, torch.bfloat16, torch.bfloat16)
    for rt, rs in ((ref_t, ref_s), (pal_t, pal_s)):
        np.testing.assert_allclose(np.asarray(rt, np.float32), tok,
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(np.asarray(rs), sent, rtol=2e-2,
                                   atol=2e-2)
    assert np.abs(tok[4]).max() == 0.0


def test_bilstm_wrapper_routes_cpu_to_plain_and_rejects_other_devices():
    gen = torch.Generator().manual_seed(0)
    p = TL.init_lstm_params(gen, 6, 4)
    x = torch.randn(3, 5, 6, generator=gen)
    mask = torch.ones(3, 5)
    args = TL._prep(p, x, mask)
    out = TL.bilstm(*args)
    ref = TL.bilstm_reference(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        TL.bilstm(*meta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_kernel_vs_plain_on_card(cuda_device, dtype):
    """Kernel vs plain recurrence on the card; ragged, non-suffix masks and
    an all-padding row, B not a multiple of the kernel's row tile."""
    gen = torch.Generator().manual_seed(1)
    B, L, D, h = 37, 12, 20, 64
    p = TL.init_lstm_params(gen, D, h, device=cuda_device)
    x, mask = _data(B, L, D, seed=5, holes=True, empty_row=3)
    x = torch.from_numpy(x).to(cuda_device)
    mask = torch.from_numpy(mask).to(cuda_device)
    mm = None if dtype == torch.float32 else dtype
    args = TL._prep(p, x, mask, mm)
    out = TL.bilstm(*args, token_dtype=dtype)
    torch.cuda.synchronize()
    ref = TL.bilstm_reference(*args, token_dtype=dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    assert out[0][3].abs().max().item() == 0.0


# The forward's route, chosen before any launch: the cluster kernel takes
# bf16 at h a multiple of 64 up to TC_MAX_H (the main path's h = 256), the
# float32 cluster kernel float32 at h a multiple of 32 from 64 up to
# F32_MAX_H (the parser's h 128, the float32 NMN's h 256), the general
# kernel everything else.
FWD_ROUTE_CASES = [
    (torch.float32, 16, "general"), (torch.float32, 64, "cluster32"),
    (torch.float32, 100, "general"), (torch.float32, 128, "cluster32"),
    (torch.float32, 192, "cluster32"), (torch.float32, 256, "cluster32"),
    (torch.float32, 320, "general"), (torch.float32, 1024, "general"),
    (torch.bfloat16, 16, "general"), (torch.bfloat16, 64, "cluster"),
    (torch.bfloat16, 100, "general"), (torch.bfloat16, 128, "cluster"),
    (torch.bfloat16, 192, "cluster"), (torch.bfloat16, 256, "cluster"),
    (torch.bfloat16, 320, "general"), (torch.bfloat16, 1024, "general"),
]


@pytest.mark.parametrize(
    "dtype,h,route", FWD_ROUTE_CASES,
    ids=[f"{str(d)[6:]}-h{h}" for d, h, _ in FWD_ROUTE_CASES])
def test_bilstm_fwd_route_choice(dtype, h, route):
    assert TL.fwd_route(dtype, h) == route


# B, clusters the card holds, the tile: an H100 SXM holds 30 clusters of
# four one-CTA-per-SM blocks (132 SMs). The train step's B 128 runs in one
# wave (2 directions x ceil(B / tile) <= 30) on the smallest such tile; a
# batch no tile up to FWD_BT_MAX = 40 fits in one wave, serving's B 1024
# among them, takes 40 (on the card two waves of 40 beat one of 72).
TILE_CASES = [(1, 30, 8), (64, 30, 8), (120, 30, 8), (125, 30, 16),
              (128, 30, 16), (600, 30, 40), (1024, 30, 40), (1440, 30, 40),
              (4096, 30, 40), (1024, 16, 40), (128, 64, 8)]


@pytest.mark.parametrize("B,clusters,tile", TILE_CASES,
                         ids=[f"B{b}-c{c}" for b, c, _ in TILE_CASES])
def test_bilstm_fwd_tile_choice(B, clusters, tile):
    c = _build.header_ints("bilstm.cu")
    got = TL.fwd_tile(B, clusters)
    assert got == tile
    assert got % c["FWD_BT_MIN"] == 0 and got <= c["FWD_BT_MAX"]
    waves = -(-2 * -(-B // got) // clusters)
    if got < c["FWD_BT_MAX"]:   # one wave, and no smaller tile gives one
        assert waves == 1
        smaller = got - c["FWD_BT_MIN"]
        assert smaller == 0 or 2 * -(-B // smaller) > clusters


def _fwd_smem_bytes(h, bt):
    """Per-CTA shared memory of the cluster forward, as ``csrc/bilstm.cu
    fwd_smem_bytes`` computes it: the ``[h, h]`` wh slice and two ``[bt,
    h]`` operand buffers, bf16, unpadded."""
    return 2 * h * h + 2 * 2 * bt * h


@pytest.mark.parametrize("h", [64, 128, 192, 256])
def test_bilstm_fwd_cluster_smem_fits_one_cta(h):
    """Every (h, tile) the cluster forward is compiled for fits the 232,448
    bytes a block may use."""
    c = _build.header_ints("bilstm.cu")
    assert TL.fwd_route(torch.bfloat16, h) == "cluster"
    for bt in range(c["FWD_BT_MIN"], c["FWD_BT_MAX"] + 1, c["FWD_BT_MIN"]):
        assert _fwd_smem_bytes(h, bt) <= 232448, bt


def _f32_smem_bytes(h, bt):
    """Per-CTA shared memory of the float32 cluster forward, as
    ``csrc/bilstm.cu f32_smem_bytes`` computes it: the transposed ``[4 U,
    h]`` wh slice and two ``[bt, h]`` operand buffers, float32, rows padded
    by ``F32_PAD``."""
    c = _build.header_ints("bilstm.cu")
    return 4 * (4 * c["F32_U"] + 2 * bt) * (h + c["F32_PAD"])


F32_HS = list(range(64, 257, 32))


@pytest.mark.parametrize("h", F32_HS)
def test_bilstm_fwd_f32_cluster_smem_fits_one_cta(h):
    """Every h the float32 cluster forward takes, at every tile it is
    compiled for, fits the 232,448 bytes a block may use, on a cluster of
    h / F32_U <= 8 CTAs (the portable most); h past F32_MAX_H does not
    take the route."""
    c = _build.header_ints("bilstm.cu")
    assert TL.fwd_route(torch.float32, h) == "cluster32"
    assert 2 <= h // c["F32_U"] <= 8 and h % c["F32_U"] == 0
    assert TL.fwd_tiles("cluster32") == list(range(
        c["F32_BT_MIN"], c["F32_BT_MAX"] + 1, c["F32_BT_MIN"]))
    for bt in TL.fwd_tiles("cluster32"):
        assert _f32_smem_bytes(h, bt) <= 232448, bt
    assert TL.fwd_route(torch.float32, c["F32_MAX_H"] + c["F32_U"]) == \
        "general"


# B, clusters the card holds with one CTA an SM, the tile. An H100 SXM
# holds 30 four-CTA clusters (h 128) and 15 eight-CTA clusters (h 256) so:
# the parser's B 64 takes 8 and its decode chunk of 256 24 (16 would need
# 32 clusters); the float32 NMN's B 128 24, its B 1024 the largest tile
# (24) in several waves.
F32_TILE_CASES = [(64, 30, 8), (256, 30, 24), (128, 15, 24), (125, 15, 24),
                  (1024, 15, 24), (1024, 30, 24), (1, 2, 8), (64, 0, 24),
                  (120, 30, 8), (121, 30, 16), (256, 64, 8)]


@pytest.mark.parametrize("B,clusters,tile", F32_TILE_CASES,
                         ids=[f"B{b}-c{c}" for b, c, _ in F32_TILE_CASES])
def test_bilstm_fwd_f32_tile_choice(B, clusters, tile):
    c = _build.header_ints("bilstm.cu")
    got = TL.fwd_tile(B, clusters, "cluster32")
    assert got == tile
    assert got % c["F32_BT_MIN"] == 0 and got <= c["F32_BT_MAX"]
    if got < c["F32_BT_MAX"]:   # one wave, and no smaller tile gives one
        assert 2 * -(-B // got) <= clusters
        smaller = got - c["F32_BT_MIN"]
        assert smaller == 0 or 2 * -(-B // smaller) > clusters


# name, B, L, D, h: the parser's training batch and decode chunk, the
# float32 NMN's encoders (train step B 128, serving B 1024), a ragged B at
# an h of six-CTA clusters
F32_CLUSTER_CASES = [("parser-train", 64, 32, 256, 128),
                     ("parser-decode", 256, 32, 256, 128),
                     ("video-train", 128, 64, 1024, 256),
                     ("question-train", 128, 16, 300, 256),
                     ("video-serving", 1024, 64, 1024, 256),
                     ("ragged-B", 125, 20, 64, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_CLUSTER_CASES,
                         ids=[c[0] for c in F32_CLUSTER_CASES])
def test_bilstm_fwd_f32_cluster_equals_general_on_card(cuda_device, case):
    """The float32 cluster forward, eval and training, with holes in the
    masks and an all-padding row: tokens, sentence and the four stacks equal
    the general route's bit for bit, are within 1e-4 of the plain version,
    and two launches give the same bits; only its launch keys count. The
    general backward gives the same bits on either route's stacks."""
    _, B, L, D, h = case
    dt = torch.float32
    gen = torch.Generator().manual_seed(16)
    x, mask = _data(B, L, D, seed=B + L, holes=True, empty_row=3)
    p = TL.init_lstm_params(gen, D, h, device=cuda_device)
    args = TL._prep(p, torch.from_numpy(x).to(cuda_device),
                    torch.from_numpy(mask).to(cuda_device))
    assert TL.fwd_route(dt, h) == "cluster32"
    _build.reset_launches()
    ev1, ev2 = (TL.bilstm(*args) for _ in range(2))
    tr1, tr2 = (TL.bilstm_train_call(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bilstm_f32c"] == 2
    assert _build.LAUNCHES["bilstm_train_f32c"] == 2
    assert sum(_build.LAUNCHES.values()) == 4
    pick = TL.fwd_route
    TL.fwd_route = lambda dtype, hh: "general"
    try:
        gev = TL.bilstm(*args)
        gtr = TL.bilstm_train_call(*args)
        torch.cuda.synchronize()
    finally:
        TL.fwd_route = pick
    assert _build.LAUNCHES["bilstm"] == _build.LAUNCHES["bilstm_train"] == 1
    flat = (*ev1, *tr1[:3], *tr1[3])
    for a, b in zip(flat, (*ev2, *tr2[:3], *tr2[3])):
        assert torch.equal(a, b)
    for a, b in zip(flat, (*gev, *gtr[:3], *gtr[3])):
        assert torch.equal(a, b)
    ref = TL.bilstm_reference(*args, return_stacks=True)
    for a, b in zip(flat, (*ref[:3], *ref[:3], *ref[3])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert float(ev1[0][3].abs().max()) == 0.0   # the all-padding row
    cots = [torch.randn(B, L, h, generator=gen).to(cuda_device)
            for _ in range(2)] + [torch.randn(B, 2 * h, generator=gen)
                                  .to(cuda_device)]
    kb = TL.bilstm_bwd_call(*args, tr1[3], *cots)
    gb = TL.bilstm_bwd_call(*args, gtr[3], *cots)
    for a, b in zip(kb, gb):
        assert torch.equal(a, b)


# name, B, L, D: the main paths' encoders (serving's B 1024, the train
# step's B 128), the class table's B 64, and a ragged B
FWD_CLUSTER_CASES = [("video-serving", 1024, 64, 1024),
                     ("question-serving", 1024, 16, 300),
                     ("video-train", 128, 64, 1024),
                     ("question-train", 128, 16, 300),
                     ("class-table", 64, 16, 300), ("ragged-B", 125, 20, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FWD_CLUSTER_CASES,
                         ids=[c[0] for c in FWD_CLUSTER_CASES])
def test_bilstm_fwd_cluster_kernel_vs_plain_on_card(cuda_device, case):
    """The cluster forward at h 256 in bf16, eval and training, against the
    plain recurrence (tokens, sentence and stacks within 2e-2), with holes
    and an all-padding row; two launches give the same bits; only its
    launch keys count; then the cluster backward on its stacks against the
    plain backward (2e-2 of each gradient's largest value)."""
    _, B, L, D = case
    h, dt = 256, torch.bfloat16
    gen = torch.Generator().manual_seed(12)
    x, mask = _data(B, L, D, seed=B + L, holes=True, empty_row=3)
    p = TL.init_lstm_params(gen, D, h, device=cuda_device)
    args = TL._prep(p, torch.from_numpy(x).to(cuda_device),
                    torch.from_numpy(mask).to(cuda_device), dt)
    _build.reset_launches()
    ev1, ev2 = (TL.bilstm(*args, token_dtype=dt) for _ in range(2))
    tr1, tr2 = (TL.bilstm_train_call(*args, token_dtype=dt)
                for _ in range(2))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bilstm_tc"] == 2
    assert _build.LAUNCHES["bilstm_train_tc"] == 2
    assert _build.LAUNCHES["bilstm"] == _build.LAUNCHES["bilstm_train"] == 0
    ref = TL.bilstm_reference(*args, token_dtype=dt, return_stacks=True)
    for got, again in ((ev1, ev2), (tr1[:3] + tr1[3], tr2[:3] + tr2[3])):
        for a, b in zip(got, again):
            assert torch.equal(a, b)
    for a, b in zip(ev1 + tr1[:3] + tr1[3], ref[:3] + ref[:3] + ref[3]):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                   atol=2e-2)
    assert float(ev1[0][3].abs().max()) == 0.0   # the all-padding row
    cots = [torch.randn(B, L, h, generator=gen).to(cuda_device, dt)
            for _ in range(2)] + [torch.randn(B, 2 * h, generator=gen)
                                  .to(cuda_device)]
    kb = TL.bilstm_bwd_call(*args, tr1[3], *cots)
    rb = TL.bilstm_bwd_reference(*args, tr1[3], *cots)
    for a, r in zip(kb, rb):
        scale = float(r.float().abs().max())
        torch.testing.assert_close(a.float(), r.float(), rtol=2e-2,
                                   atol=2e-2 * scale)
