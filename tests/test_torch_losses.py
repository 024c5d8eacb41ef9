"""Port parity: the supervision losses (stair_tpu_torch/train/losses.py)
and the model pieces they need (choice_logits, dropout, l2_normalize).

The JAX package's ``supervision_losses``, ``total_loss``,
``eval_contrastive_similarity`` and ``filterframe_loss`` and the port's run
on the same forward outputs (each framework's deterministic forward, which
tests/test_torch_mega_exec.py holds equal at 1e-4) over an
``add_fake_supervision`` batch of every opcode, with contrastive windows 0,
8 and 32: scalar losses and per-family telemetry at rtol 1e-4. The port's
``add_fake_supervision`` gives the JAX twin's arrays from the same seed.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.models import modules as TM
from stair_tpu_torch.models.nmn import choice_logits
from stair_tpu_torch.testing import workload as TW
from stair_tpu_torch.train import losses as TLS
from torch_port_util import port_model, torch_batch

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.models import modules as JM
    from stair_tpu.models.nmn import choice_logits as jchoice_logits
    from stair_tpu.testing import workload as JW
    from stair_tpu.train import losses as JLS
    from test_mega_exec import PROGRAMS, _batch, _build
except ImportError:  # the GPU machine has no JAX
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")


def _setup(ff_slots=False, candidates=False):
    cfg, model, params = _build()
    batch, _ = _batch(cfg, PROGRAMS, seed=5)
    rng = np.random.RandomState(11)
    B = batch["video"].shape[0]
    batch["answer"] = rng.randint(0, cfg.answer_vocab_length,
                                  (B,)).astype(np.int32)
    batch = JW.add_fake_supervision(batch, cfg)
    if ff_slots:
        F, C = cfg.max_video_length, cfg.object_types
        batch["ff_index"] = np.array([[23, 1], [24, 1]], np.int32)
        batch["ff_valid"] = np.ones((2,), np.float32)
        batch["ff_gold"] = rng.rand(2, F, C).astype(np.float32)
    if candidates:
        batch["cand_emb"] = rng.randn(B, 3, 4, cfg.text_size).astype(
            np.float32)
        batch["cand_mask"] = np.ones((B, 3, 4), np.float32)
        batch["cand_valid"] = (rng.rand(B, 3) > 0.2).astype(np.float32)
        batch["cand_valid"][:, 0] = 1.0
        batch["answer"] = np.zeros((B,), np.int32)   # a valid candidate
    pm = port_model(cfg, params)
    return cfg, model, params, batch, pm, torch_batch(batch)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=1e-4,
                               atol=1e-4, err_msg=what)


@needs_jax
def test_add_fake_supervision_twin_gives_the_same_arrays():
    cfg, _, _ = _build()
    jb = JW.add_fake_supervision(_batch(cfg, PROGRAMS, seed=1)[0], cfg)
    tb = TW.add_fake_supervision(_batch(cfg, PROGRAMS, seed=1)[0], cfg)
    assert jb.keys() == tb.keys()
    for k in jb:
        if k != "trace":
            assert np.array_equal(jb[k], tb[k]), k


@needs_jax
@pytest.mark.parametrize("window", [0, 8, 32])
def test_supervision_losses_match_jax(window):
    cfg, model, params, batch, pm, tb = _setup(ff_slots=True)
    jout = model.forward(params, batch, deterministic=True)
    tout = pm(tb)
    js, jt = JLS.supervision_losses(model, params, jout, batch,
                                    train_filterframe=True,
                                    contrastive_window=window)
    ts, tt = TLS.supervision_losses(pm, tout, tb, train_filterframe=True,
                                    contrastive_window=window)
    for k in ("module_loss", "decoder_loss"):
        _close(js[k], ts[k], k)
    for k in ("loss_sums", "loss_counts"):
        _close(jt[k], tt[k], k)


@needs_jax
@pytest.mark.parametrize("window", [0, 32])
def test_total_loss_with_choice_head_matches_jax(window):
    cfg, model, params, batch, pm, tb = _setup(candidates=True)
    jl, jaux = JLS.total_loss(model, params, batch, jax.random.PRNGKey(0),
                              1.0, 0.5, jnp.float32(1.0), jnp.float32(1.0),
                              deterministic=True, contrastive_window=window)
    tl, taux = TLS.total_loss(pm, tb, None, 1.0, 0.5, 1.0, 1.0,
                              deterministic=True, contrastive_window=window)
    _close(jl, tl, "loss")
    _close(jaux["out"]["choice_logits"], taux["out"]["choice_logits"],
           "choice_logits")
    for k in ("module_loss", "decoder_loss"):
        _close(jaux["scalars"][k], taux["scalars"][k], k)
    _close(jaux["telemetry"]["loss_sums"], taux["telemetry"]["loss_sums"],
           "loss_sums")


@needs_jax
def test_eval_contrastive_similarity_and_choice_logits_match_jax():
    cfg, model, params, batch, pm, tb = _setup(candidates=True)
    jout = model.forward(params, batch, deterministic=True)
    tout = pm(tb)
    js, jn = JLS.eval_contrastive_similarity(model, params, jout, batch)
    ts, tn = TLS.eval_contrastive_similarity(pm, tout, tb)
    _close(js, ts, "similarity sum")
    assert int(jn) == int(tn)
    jc = jchoice_logits(model, params, jout, batch["cand_emb"],
                        batch["cand_mask"], batch["cand_valid"])
    with torch.no_grad():
        tc = choice_logits(pm, tout, tb["cand_emb"], tb["cand_mask"],
                           tb["cand_valid"])
    _close(jc, tc, "choice_logits")


@needs_jax
def test_l2_normalize_matches_jax_and_is_grad_safe_at_zero():
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    x[2] = 0.0
    ref = np.asarray(JM.l2_normalize(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    out = TM.l2_normalize(t)
    np.testing.assert_allclose(ref, out.detach().numpy(), rtol=1e-6,
                               atol=1e-7)
    out.sum().backward()
    assert torch.isfinite(t.grad).all()


def test_dropout_statistics_and_rate_zero():
    """Masks come from a torch.Generator (they cannot equal jax.random's):
    kept entries are scaled by 1/(1-rate), the kept share is 1-rate within
    sampling error, the same generator state repeats the mask, and rate 0
    or deterministic mode is the identity."""
    x = torch.ones(200, 500)
    out = TM.dropout(x, 0.25, torch.Generator().manual_seed(1), False)
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    share = kept.float().mean().item()
    assert abs(share - 0.75) < 4 * np.sqrt(0.25 * 0.75 / x.numel())
    again = TM.dropout(x, 0.25, torch.Generator().manual_seed(1), False)
    assert torch.equal(out, again)
    assert torch.equal(TM.dropout(x, 0.0, torch.Generator(), False), x)
    assert torch.equal(TM.dropout(x, 0.5, torch.Generator(), True), x)
