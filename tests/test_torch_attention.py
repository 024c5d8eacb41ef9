"""Port parity: masked flash attention (stair_tpu_torch/ops/attention.py).

The port's ``flash_attention`` (its plain version on the CPU) is held
against the TPU kernel under the Pallas interpreter,
``_flash_forward(interpret=True, save_residuals=True)``, on the output rows
below ``valid_len`` and on the log-sum-exp, and against the JAX dense
``reference_attention`` on rows with a live column: float32 at atol 1e-5,
bf16 at atol 2e-2 (one bf16 step of an O(1) output is 8e-3). Padding rows
(at or past ``valid_len``) are 0 with lse +inf by the port's rule and are
checked as such. Lengths that divide no tile go against the dense
reference only (the JAX kernel refuses them). The CUDA kernel is held
against the plain version on the card, on the route ``route`` picks
(float32 at head_dim 64 / 128 on aligned rows: ``"mma32"``, the split-TF32
tensor-core kernel, also against ``flash_fwd_simple`` and itself).
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import attention as TA
from torch_port_util import cuda_device  # noqa: F401

try:
    import jax.numpy as jnp

    from stair_tpu.ops import attention as JA
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jnp = None
needs_jax = pytest.mark.skipif(jnp is None, reason="JAX not installed")


def _qkv(B, H, Hkv, Lq, Lkv, D, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, Lq, D) * scale).astype(np.float32)
    k = (rng.randn(B, Hkv, Lkv, D) * scale).astype(np.float32)
    v = (rng.randn(B, Hkv, Lkv, D) * scale).astype(np.float32)
    return q, k, v


def _port(q, k, v, prefix, valid, causal=True, dtype=torch.float32,
          device=None):
    out, lse = TA.flash_attention(
        torch.from_numpy(q).to(device, dtype),
        torch.from_numpy(k).to(device, dtype),
        torch.from_numpy(v).to(device, dtype),
        torch.tensor(prefix, dtype=torch.int32, device=device),
        torch.tensor(valid, dtype=torch.int32, device=device),
        causal=causal, return_lse=True)
    return out.float().cpu().numpy(), lse.cpu().numpy()


def _check_padding_rows(out, lse, valid):
    for b, nv in enumerate(valid):
        assert np.all(out[b, :, nv:] == 0.0)
        assert np.all(np.isposinf(lse[b, :, nv:]))


# name, B, H, L, D, prefix, valid, causal, block
KERNEL_CASES = [
    ("parity-96", 2, 2, 128, 32, [30, 0], [128, 100], True, 64),
    ("padded-426", 2, 2, 512, 32, [50, 0], [384, 300], True, 128),
    ("causal", 2, 2, 128, 16, [0, 0], [128, 128], True, 64),
    ("prefix-mixed", 3, 2, 128, 16, [0, 17, 128], [128, 90, 128], True, 32),
    ("valid-0-1-L", 3, 2, 64, 16, [0, 0, 5], [0, 1, 64], True, 32),
    ("prefix>valid", 2, 2, 64, 16, [50, 200], [20, 64], True, 32),
    ("noncausal", 2, 2, 64, 16, [0, 0], [64, 37], False, 32),
    ("D64", 2, 2, 64, 64, [10, 0], [64, 50], True, 32),
    ("D128", 1, 2, 64, 128, [0], [60], True, 64),
    ("valid-edges", 4, 2, 256, 32, [0, 0, 5, 0], [1, 127, 128, 129], True,
     128),
]


@needs_jax
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_against_pallas_kernel_interpret(case, dtype):
    _, B, H, L, D, prefix, valid, causal, block = case
    q, k, v = _qkv(B, H, H, L, L, D, seed=len(prefix) + L, scale=0.5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref, ref_lse = JA._flash_forward(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(prefix, jnp.int32), jnp.asarray(valid, jnp.int32),
        causal=causal, sm_scale=1 / np.sqrt(D), block_q=block,
        block_kv=block, interpret=True, save_residuals=True)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_lse = np.asarray(ref_lse)[..., 0]
    out, lse = _port(q, k, v, prefix, valid, causal,
                     getattr(torch, dtype))
    atol = 1e-5 if dtype == "float32" else 2e-2
    for b, nv in enumerate(valid):
        np.testing.assert_allclose(out[b, :, :nv], ref[b, :, :nv],
                                   rtol=1e-5, atol=atol)
        np.testing.assert_allclose(lse[b, :, :nv], ref_lse[b, :, :nv],
                                   rtol=1e-5, atol=atol)
    _check_padding_rows(out, lse, valid)
    if 0 in valid:      # no live column: the kernel's 0 / +inf, both sides
        b = valid.index(0)
        assert np.all(ref[b] == 0.0) and np.all(np.isposinf(ref_lse[b]))


# name, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal
DENSE_CASES = [
    ("ragged-200", 2, 2, 2, 200, 200, 32, [0, 40], [200, 150], True),
    ("ragged-333", 1, 4, 4, 333, 333, 16, [7], [301], True),
    ("Lq!=Lkv", 2, 2, 2, 48, 80, 16, [0, 60], [80, 33], True),
    ("Lq!=Lkv-noncausal", 2, 2, 2, 48, 80, 16, [0, 0], [80, 33], False),
    ("gqa-8-2", 2, 8, 2, 96, 96, 16, [0, 20], [96, 70], True),
]


@needs_jax
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_against_dense_reference(case):
    """Rows with a live column against the JAX dense attention; the GQA
    case against the JAX path that expands the kv heads."""
    _, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal = case
    q, k, v = _qkv(B, H, Hkv, Lq, Lkv, D, seed=Lq + H)
    rep = H // Hkv
    ref = np.asarray(JA.reference_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1),
        jnp.repeat(jnp.asarray(v), rep, axis=1),
        jnp.asarray(prefix, jnp.int32), jnp.asarray(valid, jnp.int32),
        causal))
    out, lse = _port(q, k, v, prefix, valid, causal)
    for b, nv in enumerate(valid):
        rows = min(nv, Lq)
        np.testing.assert_allclose(out[b, :, :rows], ref[b, :, :rows],
                                   rtol=1e-5, atol=1e-5)
        assert np.all(np.isfinite(lse[b, :, :rows]))
    _check_padding_rows(out, lse, valid)


def test_output_layout_and_strided_inputs():
    """``out`` is a [B, H, L, D] view of [B, L, H, D] memory, and strided
    q/k/v views give what contiguous copies give."""
    q, k, v = _qkv(2, 4, 2, 24, 24, 8, seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    pl = torch.tensor([3, 0], dtype=torch.int32)
    vl = torch.tensor([24, 11], dtype=torch.int32)
    a = TA.flash_attention(tq, tk, tv, pl, vl)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (tq, tk, tv)]
    b = TA.flash_attention(*views, pl, vl)
    assert torch.equal(a, b)
    assert a.shape == (2, 4, 24, 8)
    assert a.transpose(1, 2).is_contiguous()
    assert TA.attention_mask(pl, vl, 24, 24).shape == (2, 24, 24)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 2, 8, 8, 8, seed=0))
    ln = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        TA.flash_attention(q.to("meta"), k, v, ln, ln)
    # tensors that require grad are taken: gradients come back through
    # FlashAttention (its backward is held in test_torch_attention_bwd.py)
    q.requires_grad_()
    out = TA.flash_attention(q, k, v, ln, ln)
    out.sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    assert q.grad.abs().max() > 0


# name, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal, strided
CARD_CASES = [
    ("L640", 4, 32, 32, 640, 640, 128, [0] * 4, [640, 500, 0, 611], True, 0),
    ("L611", 4, 32, 32, 611, 611, 128, [0] * 4, [611, 300, 1, 64], True, 1),
    ("gqa", 2, 32, 8, 640, 640, 128, [0, 100], [640, 333], True, 1),
    ("D64-prefix", 4, 12, 12, 128, 128, 64, [64, 10, 0, 128],
     [128, 100, 70, 128], True, 0),
    ("noncausal", 2, 4, 4, 100, 333, 64, [0, 0], [333, 90], False, 0),
    ("D40", 2, 3, 3, 77, 91, 40, [5, 0], [91, 60], True, 0),
    # valid_len at the edges of the tensor-core kernel's 64-row query tiles
    # (and of 128-row ones), and Lq not a multiple of either
    ("valid-edges", 4, 8, 8, 300, 300, 128, [0, 0, 5, 0], [1, 127, 128, 129],
     True, 1),
    ("Lq200-D64", 4, 4, 2, 200, 200, 64, [0, 0, 0, 130], [129, 128, 200, 200],
     True, 0),
    ("noncausal-edges", 3, 4, 4, 257, 257, 128, [0, 0, 0], [1, 128, 257],
     False, 1),
    # the float32 LLM trainer CLIs' shapes: with_video_lm's video forward
    # (the video-visible prefix) and the SFT step, with ragged valid_len
    ("with_video_lm-video", 32, 8, 8, 214, 214, 64, [150] * 32,
     [214 - (11 * i) % 97 for i in range(32)], True, 1),
    ("sft", 8, 4, 4, 512, 512, 64, [0] * 8,
     [512, 386, 442, 494, 466, 464, 441, 417], True, 1),
]
#: the cases whose float32 rows the split-TF32 kernel takes (head_dim 64
#: or 128; every case's rows are 16-byte aligned)
MMA32_CASES = [c for c in CARD_CASES if c[6] in (64, 128)]


def _card_qkv(case, dt, dev):
    _, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal, strided = case
    q, k, v = (torch.from_numpy(x).to(dev, dt)
               for x in _qkv(B, H, Hkv, Lq, Lkv, D, seed=Lq))
    if strided:
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
    pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    return q, k, v, pl, vl


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_vs_plain_on_card(cuda_device, case, dtype):
    """The CUDA kernel against the plain version on the same CUDA tensors:
    float32 within 1e-4, bf16 within 2e-2, lse within 1e-4, the same +inf
    pattern, padding rows exactly 0."""
    D, valid, causal = case[6], case[8], case[9]
    dt = getattr(torch, dtype)
    q, k, v, pl, vl = _card_qkv(case, dt, cuda_device)
    route = TA._route_of(q, k, v)
    assert route == ({torch.float32: "mma32", torch.bfloat16: "mma"}[dt]
                     if D in (64, 128) else "simple")
    TA.reset_route_launches()
    out, lse = TA.flash_attention(q, k, v, pl, vl, causal=causal,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert TA.ROUTE_LAUNCHES[route] == 1, TA.ROUTE_LAUNCHES
    ref, ref_lse = TA.reference_attention(q, k, v, pl, vl, causal)
    atol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], ref_lse[fin], rtol=0, atol=1e-4)
    _check_padding_rows(out.float().cpu().numpy(), lse.cpu().numpy(), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MMA32_CASES, ids=[c[0] for c in MMA32_CASES])
def test_mma32_vs_simple_and_itself_on_card(cuda_device, case):
    """The float32 tensor-core route against ``flash_fwd_simple`` on the
    same inputs (out and lse within 1e-4, the same +inf pattern) and
    against itself on a second launch (equal bits: no atomics)."""
    D, causal = case[6], case[9]
    q, k, v, pl, vl = _card_qkv(case, torch.float32, cuda_device)
    scale = D ** -0.5
    got = TA._launch(q, k, v, pl, vl, causal, scale, True, route="mma32")
    again = TA._launch(q, k, v, pl, vl, causal, scale, True, route="mma32")
    simple = TA._launch(q, k, v, pl, vl, causal, scale, True,
                        route="simple")
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    torch.testing.assert_close(got[0], simple[0], rtol=0, atol=1e-4)
    fin = torch.isfinite(simple[1])
    assert torch.equal(torch.isfinite(got[1]), fin)
    torch.testing.assert_close(got[1][fin], simple[1][fin], rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_float32_d64_forward_launches_mma32_on_card(cuda_device):
    """A float32 head_dim-64 forward is one device kernel, and it is
    ``flash_fwd_mma32`` (``torch.profiler``'s device events)."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, pl, vl = _card_qkv(MMA32_CASES[-1], torch.float32, cuda_device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        TA.flash_attention(q, k, v, pl, vl)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "flash_fwd_mma32" in names[0], names


# dtype, head_dim, aligned -> the forward's route
FWD_ROUTES = [
    (torch.bfloat16, 64, True, "mma"),
    (torch.bfloat16, 128, True, "mma"),
    (torch.bfloat16, 128, False, "simple"),
    (torch.bfloat16, 96, True, "simple"),
    (torch.float32, 64, True, "mma32"),
    (torch.float32, 128, True, "mma32"),
    (torch.float32, 40, True, "simple"),
    (torch.float32, 96, True, "simple"),
    (torch.float32, 64, False, "simple"),
    (torch.float32, 128, False, "simple"),
]


@pytest.mark.parametrize(
    "route", FWD_ROUTES,
    ids=[f"{str(r[0])[6:]}-D{r[1]}-{'al' if r[2] else 'un'}"
         for r in FWD_ROUTES])
def test_fwd_route_choice(route):
    """The forward's route, ``route`` (the backward's too): bf16 at head_dim
    64 / 128 on aligned rows the bf16 tensor-core kernel, float32 there the
    split-TF32 kernel, every other shape the FMA kernel."""
    dtype, D, aligned, want = route
    assert TA.route(dtype, D, aligned) == want


def _float32_views():
    """float32 q views: [B, L, H, D] memory (aligned), one element past a
    16-byte boundary, rows of D + 1 floats (both unaligned)."""
    B, H, L, D = 2, 3, 8, 64
    return {
        "BLHD": (torch.randn(B, L, H, D).transpose(1, 2), True),
        "offset": (torch.randn(B * H * L * D + 1)[1:].view(B, H, L, D),
                   False),
        "row-stride": (torch.randn(B, H, L, D + 1)[..., :D], False),
    }


@pytest.mark.parametrize("layout", ["BLHD", "offset", "row-stride"])
def test_alignment_of_float32_rows(layout):
    """``_aligned`` asks of float32 rows what the split-TF32 kernel's
    16-byte loads need; a forced ``"mma32"`` on rows it refuses raises
    before anything is launched."""
    q, want = _float32_views()[layout]
    assert TA._aligned(q) is want
    k = v = torch.randn(2, 3, 8, 64)
    ln = torch.tensor([8, 5], dtype=torch.int32)
    aligned = all(TA._aligned(t) for t in (q, k, v))
    assert TA.route(torch.float32, 64, aligned) == (
        "mma32" if want else "simple")
    if not want:
        with pytest.raises(ValueError, match="route 'mma32' does not take"):
            TA._launch(q, k, v, ln, ln, True, 0.125, True, route="mma32")


def test_route_codes_match_the_source():
    """``ROUTES`` is in the order of ``ROUTE_*`` in flash_common.cuh (which
    both attention sources read), and the argument block carries the code
    where it carried the mma flag."""
    codes = _build.header_ints("flash_common.cuh")
    assert [codes[f"ROUTE_{r.upper()}"] for r in TA.ROUTES] == [0, 1, 2]
    assert "ROUTE_MMA32" not in _build.header_ints("flash_attn.cu")
    assert [f for f, _ in TA._Args._fields_][-2:] == ["route", "sm_scale"]


@pytest.mark.parametrize("D", [64, 128])
def test_mma32_shared_memory_fits(D):
    """``flash_fwd_mma32<D>``'s shared memory, from flash_attn.cu's
    constants, fits a block's 227 KB, and twice in an SM's 228 KB (1 KB
    reserved a block): two blocks an SM, as its launch bounds ask."""
    smem = TA.mma32_smem_bytes(D)
    assert smem == {64: 87040, 128: 101376}[D]
    assert smem <= 232448
    assert 2 * (smem + 1024) <= 233472
