"""Port parity: the BiLSTM recurrence (stair_tpu_torch/ops/lstm.py).

``bilstm_reference`` over ``_prep``'s hoisted projection is held against
the JAX package's ``jax.vmap(bilstm)`` (the scan) and against
``bilstm_pallas(..., interpret=True)`` (the TPU kernel under the Pallas
interpreter) on the same numpy inputs and weights: float32 at rtol/atol
2e-5, bf16 matmuls at 2e-2 (as tests/test_lstm_pallas.py). Masks need not
be a suffix, and an all-padding row gives zero tokens and a zero sentence.
The CUDA kernel is held against the plain version on the card.
"""

import numpy as np
import pytest
import torch

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
