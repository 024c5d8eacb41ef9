"""Port parity: stair_tpu_torch.models.modules vs stair_tpu.models.modules.

The helpers the executor's plain version and the decoder use, on the same
numpy inputs, in float32 (rtol 1e-5); ``init_module_params`` giving the
JAX package's key tree and shapes; and every module forward function
against its JAX twin, deterministic, from one JAX-initialised parameter
tree: the port's functions take a leading batch axis where the JAX ones
are ``vmap``ped. ``|x|`` keeps JAX's slope +1 at 0 and ``min`` splits the
gradient of a tie, at equal operands.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from stair_tpu.models import modules as JM
from stair_tpu_torch.models import modules as TM

RTOL, ATOL = 1e-5, 1e-6


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=rtol, atol=atol)


def test_linear_cosine_and_safe_sqrt():
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(5, 8).astype(np.float32),
               rng.randn(8, 3).astype(np.float32),
               rng.randn(3).astype(np.float32))
    (jx, jw, jb), (tx, tw, tb) = _pair(x, w, b)
    _close(JM.linear({"w": jw, "b": jb}, jx),
           TM.linear({"w": tw, "b": tb}, tx))
    y = rng.randn(5, 8).astype(np.float32)
    y[2] = 0.0                                    # zero row: eps clamp
    (jy,), (ty,) = _pair(y)
    _close(JM.cosine(jx, jy), TM.cosine(tx, ty))
    s = np.array([0.0, 1e-40, 4.0], np.float32)
    _close(JM._safe_sqrt(jnp.asarray(s)), TM._safe_sqrt(torch.from_numpy(s)))


def test_cosine_matrix():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16).astype(np.float32)
    y = rng.randn(7, 16).astype(np.float32)
    y[3] = 0.0
    (jx, jy), (tx, ty) = _pair(x, y)
    _close(JM.cosine_matrix(jx, jy), TM.cosine_matrix(tx, ty))


def test_masked_softmax_including_all_masked_row():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 9).astype(np.float32) * 3
    mask = rng.rand(4, 9) > 0.4
    mask[1] = False                               # all-masked row -> 0
    mask[2, :] = False
    mask[2, 4] = True                             # single valid entry
    (jx, jm), (tx, tm) = _pair(x, mask)
    j = JM.masked_softmax(jx, jm)
    t = TM.masked_softmax(tx, tm)
    _close(j, t)
    assert np.all(t[1].numpy() == 0.0)
    assert t[2, 4].item() == pytest.approx(1.0)


def test_layer_norm():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 32).astype(np.float32) * 2 + 1
    scale = rng.rand(32).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    (jx, js, jb), (tx, ts, tb) = _pair(x, scale, bias)
    _close(JM.layer_norm({"scale": js, "bias": jb}, jx),
           TM.layer_norm({"scale": ts, "bias": tb}, tx), atol=1e-5)


@pytest.mark.parametrize("k,length", [(3, 8), (4, 8), (5, 16), (12, 48)])
def test_conv1d_same_matrix_odd_and_even(k, length):
    rng = np.random.RandomState(k)
    w = rng.randn(k).astype(np.float32)
    x = rng.randn(length).astype(np.float32)
    jt = JM.conv1d_same_matrix(jnp.asarray(w), length)
    tt = TM.conv1d_same_matrix(torch.from_numpy(w), length)
    _close(jt, tt)
    # and it is torch's Conv1d(padding='same') on x
    conv = torch.nn.functional.conv1d(
        torch.from_numpy(x)[None, None], torch.from_numpy(w)[None, None],
        padding="same")[0, 0]
    np.testing.assert_allclose((tt @ torch.from_numpy(x)).numpy(),
                               conv.numpy(), rtol=1e-5, atol=1e-5)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("F", [16, 48])   # linear and conv temporal modes
def test_init_module_params_key_tree_and_shapes(F):
    cfg = {"hidden_size": 32, "max_video_length": F, "dropout": 0.1,
           "object_types": 5, "have_pretrain_head": True}
    j = JM.init_module_params(jax.random.PRNGKey(0), cfg)
    t = TM.init_module_params(torch.Generator().manual_seed(0), cfg)
    assert _shapes(jax.tree_util.tree_map(np.asarray, j)) == _shapes(t)
    # fan-in bounds hold (torch-default uniform init)
    w = t["compare"]["w"]
    assert float(w.abs().max()) <= 1.0 / np.sqrt(64) + 1e-6


# ---------------------------------------------------------------------------
# Module forward functions against their JAX twins
# ---------------------------------------------------------------------------

H, NB = 16, 5


def _module_params(F):
    cfg = {"hidden_size": H, "max_video_length": F, "dropout": 0.0,
           "object_types": 3, "have_pretrain_head": False}
    j = JM.init_module_params(jax.random.PRNGKey(1), cfg)
    t = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)), j)
    return j, t


def _draw(F, seed=0):
    rng = np.random.RandomState(seed)
    d = {
        "va": rng.randn(NB, H), "vb": rng.randn(NB, H),
        "vc": rng.randn(NB, H), "frames": rng.randn(NB, F, H),
        "aa": rng.rand(NB, F), "ab": rng.rand(NB, F),
        "mask": (np.arange(F)[None] < rng.randint(2, F + 1, (NB, 1))),
    }
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["vb"][1] = d["va"][1]               # equal operands: ties, |0|
    d["ab"][1] = d["aa"][1]
    return d


KEY = None  # deterministic: the JAX twins take an rng they never read


def _vm(fn, *arrays, **kw):
    return jax.vmap(lambda *a: fn(*a, **kw))(*[jnp.asarray(a)
                                               for a in arrays])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("F", [12, 40])
def test_vec_modules_match_jax(F):
    jp, tp = _module_params(F)
    d = _draw(F)
    va, vb, vc = _t(d["va"], d["vb"], d["vc"])
    _close(_vm(JM.and_module, d["va"], d["vb"]), TM.and_module(va, vb))
    for name, jf, tf in (("compare", JM.compare_module, TM.compare_module),
                         ("equals", JM.equals_module, TM.equals_module),
                         ("xor", JM.xor_module, TM.xor_module)):
        _close(_vm(lambda a, b: jf(jp[name], a, b), d["va"], d["vb"]),
               tf(tp[name], va, vb))
    _close(_vm(JM.choose_module, d["va"], d["vb"], d["vc"]),
           TM.choose_module(va, vb, vc))
    _close(_vm(lambda a: JM.query_module(jp["query"], a, 0.0, KEY, True),
               d["va"]), TM.query_module(tp["query"], va, 0.0, None, True))
    _close(_vm(lambda a, b: JM.toaction_module(jp["toaction"], a, b, 0.0,
                                               KEY, True), d["va"], d["vb"]),
           TM.toaction_module(tp["toaction"], va, vb, 0.0, None, True))
    rngs = jax.random.split(jax.random.PRNGKey(0), NB)
    _close(jax.vmap(lambda a, b, r: JM.exists_module(
        jp["exists"], a, b, 0.0, r, True))(jnp.asarray(d["va"]),
                                            jnp.asarray(d["vb"]), rngs),
           TM.exists_module(tp["exists"], va, vb, 0.0, None, True))


@pytest.mark.parametrize("F", [12, 40])
def test_attn_and_frames_modules_match_jax(F):
    jp, tp = _module_params(F)
    d = _draw(F, seed=1)
    va, frames, aa, ab, mask = _t(d["va"], d["frames"], d["aa"], d["ab"],
                                  d["mask"])
    rngs = jax.random.split(jax.random.PRNGKey(0), NB)
    _close(_vm(JM.xorframe_module, d["aa"], d["ab"]),
           TM.xorframe_module(aa, ab))
    _close(_vm(JM.attnvideo_module, d["frames"], d["aa"]),
           TM.attnvideo_module(frames, aa))
    _close(_vm(JM.existsframe_module, d["va"], d["frames"], d["mask"]),
           TM.existsframe_module(va, frames, mask))
    _close(jax.vmap(lambda fr, m, r: JM.hasitem_module(
        jp["hasitem"], fr, m, 0.0, r, True))(
            jnp.asarray(d["frames"]), jnp.asarray(d["mask"]), rngs),
        TM.hasitem_module(tp["hasitem"], frames, mask, 0.0, None, True))
    for back in (False, True):
        _close(_vm(lambda a, m: JM.relate_module(jp["relate"], back, a,
                                                 m > 0), d["aa"], d["mask"]),
               TM.relate_module(tp["relate"], back, aa, mask > 0))
    back = torch.tensor([True, False, True, False, False])
    want = np.stack([np.asarray(JM.relate_module(
        jp["relate"], bool(back[i]), jnp.asarray(d["aa"][i]),
        jnp.asarray(d["mask"][i]) > 0)) for i in range(NB)])
    _close(want, TM.relate_module(tp["relate"], back, aa, mask > 0))


@pytest.mark.parametrize("F", [12, 40])   # linear and conv temporal modes
def test_temporal_modules_match_jax(F):
    jp, tp = _module_params(F)
    d = _draw(F, seed=2)
    frames, aa, mask = _t(d["frames"], d["aa"], d["mask"])
    conv = F > 32
    mode = np.array([0, 1, 2, 3, 1], np.int32)
    want = JM.temporal_related_attn_batched(
        jp["temporal"], jnp.asarray(mode), jnp.asarray(d["aa"]), conv)
    got = TM.temporal_related_attn_batched(
        tp["temporal"], torch.from_numpy(mode), aa, conv)
    _close(want, got)
    for i in range(4):
        one = JM.temporal_related_attn(jp["temporal"], int(mode[i]),
                                       jnp.asarray(d["aa"][i]), conv)
        _close(one, TM.temporal_related_attn(tp["temporal"], int(mode[i]),
                                             aa[i], conv))
        _close(one, got[i])
    jf, jr = jax.vmap(lambda m, fr, a, mk: JM.temporal_module(
        jp["temporal"], m, fr, a, mk, conv, 0.0, KEY, True))(
            jnp.asarray(mode), jnp.asarray(d["frames"]),
            jnp.asarray(d["aa"]), jnp.asarray(d["mask"]))
    tf, tr = TM.temporal_module(tp["temporal"], torch.from_numpy(mode),
                                frames, aa, mask, conv, 0.0, None, True)
    _close(jf, tf, atol=1e-5)
    _close(jr, tr)


@pytest.mark.parametrize("attention", ["parity", "softmax"])
def test_filter_modules_match_jax(attention):
    F = 12
    jp, tp = _module_params(F)
    d = _draw(F, seed=3)
    va, frames, mask = _t(d["va"], d["frames"], d["mask"])
    rngs = jax.random.split(jax.random.PRNGKey(0), NB)
    jin = (jnp.asarray(d["frames"]), jnp.asarray(d["va"]),
           jnp.asarray(d["mask"]), rngs)
    _close(jax.vmap(lambda fr, kw, m, r: JM.filter_module_vec(
        jp["filter"], fr, kw, m, 0.0, r, True, attention=attention))(*jin),
        TM.filter_module_vec(tp["filter"], frames, va, mask, 0.0, None, True,
                             attention=attention))
    _close(jax.vmap(lambda fr, kw, m, r: JM.filterframe_module_vec(
        jp["filterframe"], fr, kw, m, 0.0, r, True))(*jin),
        TM.filterframe_module_vec(tp["filterframe"], frames, va, mask, 0.0,
                                  None, True))
    for kw_index in range(3):
        _close(jax.vmap(lambda fr, m, r: JM.filter_module_kw(
            jp["filter"], fr, kw_index, m, 0.0, r, True))(
                jin[0], jin[2], rngs),
            TM.filter_module_kw(tp["filter"], frames, kw_index, mask, 0.0,
                                None, True))
        _close(jax.vmap(lambda fr, m, r: JM.filterframe_module_kw(
            jp["filterframe"], fr, kw_index, m, 0.0, r, True))(
                jin[0], jin[2], rngs),
            TM.filterframe_module_kw(tp["filterframe"], frames, kw_index,
                                     mask, 0.0, None, True))


def test_localize_and_superlative_match_jax():
    F, K = 12, 3
    jp, tp = _module_params(F)
    d = _draw(F, seed=4)
    rng = np.random.RandomState(5)
    actions = rng.randn(NB, K, H).astype(np.float32)
    amask = np.array([[1, 1, 1], [1, 0, 0], [1, 1, 0], [0, 0, 0],
                      [1, 1, 1]], bool)
    frames, mask, tact = _t(d["frames"], d["mask"], actions)
    _close(jax.vmap(lambda fr, kw, m: JM.localize_scores(
        jp["localize"], fr, kw, m, 0.0, KEY, True))(
            jnp.asarray(d["frames"]), jnp.asarray(actions),
            jnp.asarray(d["mask"])),
        TM.localize_scores(tp["localize"], frames, tact, mask, 0.0, None,
                           True))
    for is_min in (False, True):
        for am in (None, amask):
            jam = (None if am is None else jnp.asarray(am))
            want = jax.vmap(lambda a, fr, m, k: JM.superlative_module(
                jp["superlative"], jp["localize"], is_min, a, fr, m, 0.0,
                KEY, True, action_mask=k),
                in_axes=(0, 0, 0, None if am is None else 0))(
                    jnp.asarray(actions), jnp.asarray(d["frames"]),
                    jnp.asarray(d["mask"]), jam)
            got = TM.superlative_module(
                tp["superlative"], tp["localize"], is_min, tact, frames,
                mask, 0.0, None, True,
                action_mask=None if am is None else torch.from_numpy(am))
            _close(want, got)


def test_abs_and_min_gradients_at_equal_operands_match_jax():
    """``|x|`` has slope +1 at 0 and ``min`` splits a tie evenly, in the
    port as in JAX (torch's own ``abs`` has slope 0 at 0)."""
    a = np.array([0.5, -1.0, 2.0, 0.0], np.float32)
    b = np.array([0.5, 3.0, 2.0, 0.0], np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for jf, tf in ((JM.xorframe_module, TM.xorframe_module),
                   (JM.and_module, TM.and_module)):
        jg = jax.grad(lambda x, y: jnp.sum(jf(x, y) * jnp.arange(1.0, 5.0)),
                      argnums=(0, 1))(ja, jb)
        ta = torch.from_numpy(a).requires_grad_()
        tb = torch.from_numpy(b).requires_grad_()
        (tf(ta, tb) * torch.arange(1.0, 5.0)).sum().backward()
        _close(jg[0], ta.grad)
        _close(jg[1], tb.grad)
    x = torch.zeros(3, requires_grad=True)
    TM.abs_jax(x).sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]


def test_module_dropout_draws_in_site_order():
    """With a rate the masks come from the generator in the documented
    order, so two calls from equal generator states agree and a replay
    from a re-seeded generator reproduces a call."""
    _, tp = _module_params(12)
    d = _draw(12, seed=6)
    va, vb, frames, mask = _t(d["va"], d["vb"], d["frames"], d["mask"])

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return (TM.exists_module(tp["exists"], va, vb, 0.5, g, False),
                TM.hasitem_module(tp["hasitem"], frames, mask, 0.5, g, False))

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert float((a[0] == 0).float().mean()) > 0.3
