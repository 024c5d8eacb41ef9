"""Port parity: the program parsers (stair_tpu_torch/seq2seq/, and the T5
importers of llm/import_weights.py).

Small sizes (vocabularies of 12-20, width 32, S 7, T 8, padded rows),
inputs from a numpy seed, the JAX params carried across with
``params_from_numpy``, all float32. Each parser's teacher-forced logits
against the JAX model's (max abs 1e-4) and every leaf of the loss's
gradient (``‖port − jax‖ / ‖jax‖`` <= 1e-4; the transformer's key
biases, whose exact gradient is 0, to 1e-4 of the gradient's scale); T5's relative-position
buckets equal to JAX's over [-64, 64]; beam search token for token and
scores to 1e-4 (a padded chunk, beams that finish early, a target
vocabulary a little larger than the beam); three Adam steps of the CLI's
step function against ``optax.adam`` leaf by leaf (1e-5 relative; the key
biases, where Adam scales rounding noise up to steps of the rate, within
6 times the rate: three steps each side); the CLI both ways (a JAX-trained
directory decoded by the port gives the same TSV and validity rates; a
port-written directory loads in the JAX CLI with the same logits, its
``params.msgpack`` the bytes flax writes); ``import_t5`` on a random-init
``transformers`` T5.
"""

import os
import types

import numpy as np
import pytest
import torch

from stair_tpu_torch.seq2seq import beam as TB
from stair_tpu_torch.seq2seq import lstm as TL
from stair_tpu_torch.seq2seq import t5 as TT5
from stair_tpu_torch.seq2seq import train as TC
from stair_tpu_torch.seq2seq import transformer as TX
from stair_tpu_torch.seq2seq.vocab import BOS, EOS, PAD
from stair_tpu_torch.weights import (
    flatten_tree,
    grads_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from torch_port_util import cuda_device, to_numpy_tree  # noqa: F401

try:
    import jax
    import jax.numpy as jnp
    import optax

    from stair_tpu.seq2seq import beam as JB
    from stair_tpu.seq2seq import lstm as JL
    from stair_tpu.seq2seq import t5 as JT5
    from stair_tpu.seq2seq import train as JC
    from stair_tpu.seq2seq import transformer as JX
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

SRC_V, TGT_V, S, T = 17, 13, 7, 8
ARCHS = ("lstm", "transformer", "t5", "t5-relu-untied")


def _configs(arch, src_v=SRC_V, tgt_v=TGT_V):
    """(JAX model, port config class, config kwargs) at the tests' widths."""
    if arch == "lstm":
        kw = dict(src_vocab=src_v, tgt_vocab=tgt_v, embed_dim=32, hidden=32,
                  max_src_len=S, max_tgt_len=T)
        return JL.LSTMSeq2Seq(JL.LSTMSeq2SeqConfig(**kw)), \
            TL.LSTMSeq2SeqConfig(**kw), TL.LSTMSeq2Seq
    if arch == "transformer":
        kw = dict(src_vocab=src_v, tgt_vocab=tgt_v, d_model=32, num_heads=4,
                  num_layers=2, d_ff=64, max_src_len=S, max_tgt_len=T)
        return JX.TransformerSeq2Seq(JX.TransformerSeq2SeqConfig(**kw)), \
            TX.TransformerSeq2SeqConfig(**kw), TX.TransformerSeq2Seq
    ff, tied = (("relu", False) if arch == "t5-relu-untied"
                else ("gated-gelu", True))
    kw = dict(vocab_size=max(src_v, tgt_v), d_model=32, d_kv=8, num_heads=4,
              num_layers=2, num_decoder_layers=2, d_ff=64, feed_forward=ff,
              tie_word_embeddings=tied, max_src_len=S, max_tgt_len=T)
    return JT5.T5Seq2Seq(JT5.T5Config(**kw)), TT5.T5Config(**kw), \
        TT5.T5Seq2Seq


def _pair(arch, seed=0, **vocab):
    """(JAX model, JAX params, port model with the same weights)."""
    jm, pcfg, pcls = _configs(arch, **vocab)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, pcls(pcfg, params_from_numpy(to_numpy_tree(jp)))


def _inputs(seed=0, B=4, src_v=SRC_V, tgt_v=TGT_V, lens=(7, 4, 1, 6)):
    """src [B, S] padded at the end (mask from the lengths), BOS-shifted
    tgt_in and tgt_out [B, T] with PAD tails."""
    rng = np.random.RandomState(seed)
    src = rng.randint(4, src_v, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.asarray(lens)[:, None]).astype(
        np.float32)
    src = np.where(mask > 0, src, PAD).astype(np.int32)
    tgt = rng.randint(4, tgt_v, (B, T)).astype(np.int32)
    tlens = rng.randint(2, T + 1, B)
    for b, n in enumerate(tlens):
        tgt[b, n - 1] = EOS
        tgt[b, n:] = PAD
    tgt_in = np.concatenate([np.full((B, 1), BOS, np.int32), tgt[:, :-1]], 1)
    return src, mask, tgt_in, tgt


def _t(x):
    return torch.from_numpy(np.asarray(x)).long() if np.asarray(
        x).dtype.kind == "i" else torch.from_numpy(np.asarray(x))


def _jax_loss(model, p, s, sm, ti, to):
    logits = model.logits(p, s, sm, ti)
    lse = jax.nn.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(logits, to[..., None], axis=-1)[..., 0]
    mask = (to != PAD).astype(jnp.float32)
    return jnp.sum((lse - picked) * mask) / jnp.maximum(jnp.sum(mask), 1.0)


def _shift_invariant(key):
    """A key projection's bias adds the same score to every key of a query,
    which the softmax cancels: its exact gradient is 0, and both packages
    give rounding noise (~1e-10) there."""
    return key.endswith("/k/b")


def _jnp(tree):
    """A numpy params tree (the JAX CLI's ``load_parser``, ``import_t5``)
    as jax arrays, which a traced index can take."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------------------
# logits and gradients
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_jax(arch):
    jm, jp, pm = _pair(arch)
    src, mask, ti, _ = _inputs()
    want = np.asarray(jm.logits(jp, src, mask, ti))
    with torch.no_grad():
        got = pm.logits(_t(src), _t(mask), _t(ti)).numpy()
    assert got.shape == want.shape == (4, T, pm.config.tgt_vocab)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_leaf_by_leaf(arch):
    jm, jp, pm = _pair(arch, seed=1)
    src, mask, ti, to = _inputs(seed=1)
    jl, jg = jax.value_and_grad(
        lambda p: _jax_loss(jm, p, src, mask, ti, to))(jp)
    loss = TC.parser_loss(pm.logits(_t(src), _t(mask), _t(ti)), _t(to))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = flatten_tree(to_numpy_tree(jg))
    got = flatten_tree(grads_to_numpy(pm))
    assert want.keys() == got.keys()
    scale = max(np.linalg.norm(v) for v in want.values())
    for k in want:
        if _shift_invariant(k):
            # 0 but for rounding on both sides: held to the gradient's scale
            assert np.linalg.norm(got[k] - want[k]) <= 1e-4 * scale, k
            continue
        assert _rel(got[k], want[k]) <= 1e-4, (k, _rel(got[k], want[k]))


@needs_jax
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_buckets_equal_jax(bidirectional):
    rel = np.arange(-64, 65, dtype=np.int32)
    want = np.asarray(JT5.relative_position_bucket(
        jnp.asarray(rel), bidirectional, 32, 128))
    got = TT5.relative_position_bucket(torch.from_numpy(rel).long(),
                                       bidirectional, 32, 128).numpy()
    np.testing.assert_array_equal(got, want)
    # and on a [q, k] grid as the position bias builds it
    grid = np.arange(48)[None, :] - np.arange(48)[:, None]
    want = np.asarray(JT5.relative_position_bucket(
        jnp.asarray(grid, jnp.int32), bidirectional, 32, 128))
    got = TT5.relative_position_bucket(torch.from_numpy(grid).long(),
                                       bidirectional, 32, 128).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _padded_chunk(src, mask):
    """Two padding rows as ``decode_beams`` adds them to a short chunk."""
    src = np.concatenate([src, np.zeros((2, S), np.int32)])
    mask = np.concatenate([mask, np.zeros((2, S), np.float32)])
    mask[-2:, 0] = 1.0
    return src, mask


BEAM_CASES = {
    # a chunk padded as decode_beams pads it
    "padded_chunk": dict(vocab={}, eos_bias=0.0, K=5, pad_rows=True),
    # EOS favoured: beams finish early and are frozen on PAD
    "early_finish": dict(vocab={}, eos_bias=4.0, K=5, pad_rows=False),
    # a target vocabulary only a little larger than the beam
    "small_vocab": dict(vocab=dict(tgt_v=7), eos_bias=1.0, K=5,
                        pad_rows=True),
}


@needs_jax
@pytest.mark.parametrize("case", sorted(BEAM_CASES))
@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_beam_search_matches_jax(arch, case):
    c = BEAM_CASES[case]
    jm, jp, _ = _pair(arch, seed=2, **c["vocab"])
    # favour EOS through the output bias, on both sides alike
    jp = dict(jp, logit=dict(jp["logit"], b=jp["logit"]["b"].at[EOS].add(
        c["eos_bias"])))
    _, pcfg, pcls = _configs(arch, **c["vocab"])
    pm = pcls(pcfg, params_from_numpy(to_numpy_tree(jp)))
    src, mask, _, _ = _inputs(seed=2)
    if c["pad_rows"]:
        src, mask = _padded_chunk(src, mask)
    wt, ws = JB.beam_search(jm, jp, src, mask, beam_size=c["K"], max_len=T)
    gt, gs = TB.beam_search(pm, _t(src), _t(mask), beam_size=c["K"],
                            max_len=T)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-4)
    if case == "early_finish":
        # some beam ended before max_len and was held on PAD after EOS
        toks = gt.numpy()
        ended = (toks == EOS).any(-1)
        assert ended.any()
        b, k = np.argwhere(ended)[0]
        after = toks[b, k, list(toks[b, k]).index(EOS) + 1:]
        assert (after == PAD).all()


# ---------------------------------------------------------------------------
# the CLI's step against optax
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("arch", ["lstm", "transformer", "t5"])
def test_three_adam_steps_match_optax(arch):
    jm, jp, pm = _pair(arch, seed=3)
    lr = 1e-3
    opt = optax.adam(lr)
    state = opt.init(jp)

    @jax.jit
    def jstep(p, st, s, sm, ti, to):
        loss, g = jax.value_and_grad(
            lambda q: _jax_loss(jm, q, s, sm, ti, to))(p)
        up, st = opt.update(g, st, p)
        return optax.apply_updates(p, up), st, loss

    step = TC.make_step(pm, TC.make_optimizer(pm, lr))
    for i in range(3):
        src, mask, ti, to = _inputs(seed=10 + i)
        jp, state, jl = jstep(jp, state, src, mask, ti, to)
        loss = step(_t(src), _t(mask), _t(ti), _t(to))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = flatten_tree(to_numpy_tree(jp))
    got = flatten_tree(params_to_numpy(pm))
    for k in want:
        if _shift_invariant(k):
            # Adam scales rounding noise up to steps of about the rate:
            # three steps move an element by at most 3 lr on either side
            assert np.abs(got[k] - want[k]).max() <= 6 * lr, k
            continue
        assert _rel(got[k], want[k]) <= 1e-5, (k, _rel(got[k], want[k]))


# ---------------------------------------------------------------------------
# the CLI, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny synthetic AGQA world, preprocessed and split (the port's
    copies of make_world and preprocess)."""
    from stair_tpu_torch.testing.agqa_world import write_agqa_world

    return write_agqa_world(str(tmp_path_factory.mktemp("parser_world")),
                            num_videos=6, questions_per_video=5,
                            num_frames=16, seed=3)


def _cli_words(arch, w, out):
    return ["--arch", arch, "--train-filename", w["train"],
            "--output", out, "--embed-dim", "32", "--hidden", "32",
            "--num-layers", "1", "--max-src-len", "16", "--max-tgt-len",
            "24", "--batch-size", "4", "--num-epochs", "1",
            "--report-interval", "1000", "--beam-size", "3"]


@needs_jax
@pytest.mark.parametrize("arch", ["lstm", "transformer"])
def test_jax_trained_parser_decodes_the_same_in_the_port(arch, world,
                                                         tmp_path):
    out = str(tmp_path / "jax_parser")
    words = _cli_words(arch, world, out)
    JC.main(["--func", "train", *words])
    tsvs = {}
    for name, main, extra in (("jax", JC.main, []),
                              ("port", TC.main, ["--device", "cpu"])):
        tsvs[name] = str(tmp_path / f"{name}.tsv")
        main(["--func", "predict", *words, "--model-dir", out,
              "--test-filename", world["test"], "--result-filename",
              tsvs[name], *extra])
    with open(tsvs["jax"]) as f:
        want = f.read()
    with open(tsvs["port"]) as f:
        assert f.read() == want
    assert want.count("\n") == 3 * len(JC.load_pairs(world["test"]))
    rates = [fn(types.SimpleNamespace(result_filename=tsvs["jax"]))
             for fn in (JC.check_valid, TC.check_valid)]
    assert rates[0] == rates[1]
    # the loaded parser's logits are the JAX parser's
    model, sv, tv = TC.load_parser(out)
    jm, jparams, jsv, jtv = JC.load_parser(out)
    jparams = _jnp(jparams)
    assert sv.id2word == jsv.id2word and tv.id2word == jtv.id2word
    pairs = JC.load_pairs(world["valid"])
    src, mask, tgt = JC.encode_pairs(pairs, jsv, jtv, 16, 24)
    ti = np.concatenate([np.full((len(src), 1), BOS, np.int32),
                         tgt[:, :-1]], 1)
    with torch.no_grad():
        got = model.logits(_t(src), _t(mask), _t(ti)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.logits(jparams, src, mask,
                                                         ti)),
                               rtol=0, atol=1e-4)


@needs_jax
def test_port_written_parser_loads_in_the_jax_cli(world, tmp_path):
    out = str(tmp_path / "port_parser")
    words = _cli_words("lstm", world, out)
    model = TC.main(["--func", "train", *words, "--valid-filename",
                     world["valid"], "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["params.msgpack", "parser_config.json",
                                      "src_vocab.json", "tgt_vocab.json"]
    jm, jparams, sv, tv = JC.load_parser(out)
    jparams = _jnp(jparams)
    pairs = JC.load_pairs(world["valid"])
    src, mask, tgt = JC.encode_pairs(pairs, sv, tv, 16, 24)
    ti = np.concatenate([np.full((len(src), 1), BOS, np.int32),
                         tgt[:, :-1]], 1)
    with torch.no_grad():
        got = model.logits(_t(src), _t(mask), _t(ti)).numpy()
    want = np.asarray(jm.logits(jparams, src, mask, ti))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the same tree, bit for bit, in the bytes flax writes for it
    for k, v in flatten_tree(to_numpy_tree(jparams)).items():
        np.testing.assert_array_equal(flatten_tree(params_to_numpy(model))[k],
                                      v, k)
    from flax import serialization

    with open(os.path.join(out, "params.msgpack"), "rb") as f:
        assert f.read() == serialization.to_bytes(to_numpy_tree(jparams))
    # and the JAX CLI decodes it into the TSV the port writes
    tsvs = {}
    for name, main, extra in (("jax", JC.main, []),
                              ("port", TC.main, ["--device", "cpu"])):
        tsvs[name] = str(tmp_path / f"{name}.tsv")
        main(["--func", "predict", *words, "--model-dir", out,
              "--test-filename", world["test"], "--result-filename",
              tsvs[name], *extra])
    with open(tsvs["jax"]) as f, open(tsvs["port"]) as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# the pretrained T5 path
# ---------------------------------------------------------------------------

@needs_jax
def test_import_t5_gives_jax_logits_on_the_same_tree():
    transformers = pytest.importorskip("transformers")
    from stair_tpu.llm import import_weights as JW
    from stair_tpu_torch.llm import import_weights as TW
    from torch_port_util import assert_trees_equal

    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=SRC_V + 3, d_model=32, d_kv=8, num_heads=4, num_layers=2,
        num_decoder_layers=2, d_ff=64, dropout_rate=0.0,
        feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        decoder_start_token_id=0))
    sd = hf.state_dict()
    tree = TW.import_t5(sd)
    assert_trees_equal(JW.import_t5(sd), tree)
    jcfg = JW.t5_config_from_hf(hf.config, max_src_len=S, max_tgt_len=T)
    pcfg = TW.t5_config_from_hf(hf.config, max_src_len=S, max_tgt_len=T)
    assert pcfg.__dict__ == jcfg.__dict__
    pm = TT5.T5Seq2Seq(pcfg, params_from_numpy(tree))
    src, mask, ti, _ = _inputs(seed=4, tgt_v=SRC_V)
    ti[:, 0] = 0                    # T5 decodes from the pad id
    want = np.asarray(JT5.T5Seq2Seq(jcfg).logits(_jnp(tree), src, mask,
                                                  ti))
    with torch.no_grad():
        got = pm.logits(_t(src), _t(mask), _t(ti)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # T5 beam search decodes from pad with eos 1, on both sides alike
    wt, ws = JB.beam_search(JT5.T5Seq2Seq(jcfg), _jnp(tree), src, mask,
                            beam_size=3, max_len=T, bos=0, eos=1, pad=0)
    gt, gs = TB.beam_search(pm, _t(src), _t(mask), beam_size=3, max_len=T,
                            bos=0, eos=1, pad=0)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# entry points and the card
# ---------------------------------------------------------------------------

def test_cli_refuses_to_run_without_a_card(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CLI would run on it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        TC.main(["--func", "train", *_cli_words("lstm", world,
                                                str(tmp_path / "p"))])
    assert not os.path.exists(tmp_path / "p")


def test_encoder_runs_the_bilstm_on_the_train_pair_with_gradients(
        monkeypatch):
    # with gradients on the encoder goes through bilstm_forward_train (the
    # training kernels' wrappers), under no_grad through bilstm_forward
    from stair_tpu_torch.ops import lstm as OL

    seen = []

    def spy(name):
        fn = getattr(OL, name)

        def call(params, x, mask, **kw):
            # the eval kernel refuses tensors that require grad
            seen.append((name, any(t.requires_grad for d in params.values()
                                   for t in d.values())))
            return fn(params, x, mask, **kw)
        return call

    for name in ("bilstm_forward", "bilstm_forward_train"):
        monkeypatch.setattr(TL, name, spy(name))
    pm = TL.LSTMSeq2Seq(TL.LSTMSeq2SeqConfig(SRC_V, TGT_V, 32, 32, S, T),
                        generator=torch.Generator().manual_seed(0))
    src, mask, ti, to = _inputs()
    TC.parser_loss(pm.logits(_t(src), _t(mask), _t(ti)), _t(to)).backward()
    with torch.no_grad():
        TB.beam_search(pm, _t(src), _t(mask), beam_size=2, max_len=3)
    assert seen == [("bilstm_forward_train", True),
                    ("bilstm_forward", False)]


@pytest.mark.cuda
def test_parser_on_the_card_matches_the_cpu(cuda_device):  # noqa: F811
    # the encoder's BiLSTM kernels at float32 (#1, #2, #3 on their float32
    # cluster routes) against the plain versions, through the parser's loss
    # and beam search
    from stair_tpu_torch.ops import _build

    cfg = TL.LSTMSeq2SeqConfig(SRC_V, TGT_V, 64, 256, S, T)
    cpu = TL.LSTMSeq2Seq(cfg, generator=torch.Generator().manual_seed(0))
    card = TL.LSTMSeq2Seq(cfg, params_from_numpy(params_to_numpy(cpu)),
                          device=cuda_device)
    src, mask, ti, to = _inputs()
    _build.reset_launches()
    losses = []
    for m, dev in ((cpu, "cpu"), (card, cuda_device)):
        loss = TC.parser_loss(m.logits(*(_t(x).to(dev) for x in
                                         (src, mask, ti))), _t(to).to(dev))
        loss.backward()
        losses.append(float(loss))
    assert _build.LAUNCHES["bilstm_train_f32c"] == 1
    assert _build.LAUNCHES["bilstm_bwd_f32c"] == 1
    assert _build.LAUNCHES["bilstm_dwh_f32c"] == 1
    assert _build.LAUNCHES["bilstm_bwd"] == 0
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    want, got = (flatten_tree(grads_to_numpy(m)) for m in (cpu, card))
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-4, k
    wt, _ = TB.beam_search(cpu, _t(src), _t(mask), beam_size=3, max_len=T)
    gt, _ = TB.beam_search(card, _t(src).to(cuda_device),
                           _t(mask).to(cuda_device), beam_size=3, max_len=T)
    assert _build.LAUNCHES["bilstm_f32c"] == 1
    np.testing.assert_array_equal(gt.cpu().numpy(), wt.numpy())


def test_decode_pads_a_short_chunk_with_one_valid_position(world):
    # the padding rows of a short chunk never reach a fully masked softmax:
    # every row's decode is finite and the real rows equal an unpadded run
    pairs = TC.load_pairs(world["test"])[:3]
    sv = TC.Vocab.build([q for _, q, _, _ in pairs])
    tv = TC.Vocab.build([p for _, _, p, _ in pairs])
    args = types.SimpleNamespace(max_src_len=16, max_tgt_len=10,
                                 batch_size=2, beam_size=2, embed_dim=32,
                                 hidden=32, num_layers=1)
    model = TC.build_model("lstm", len(sv), len(tv), args)
    padded = list(TC.decode_beams(model, sv, tv, pairs, args))
    args.batch_size = 1
    single = list(TC.decode_beams(model, sv, tv, pairs, args))
    assert padded == single and len(padded) == 3
