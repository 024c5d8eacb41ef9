"""Port parity: the NMN trainer and evaluate CLIs
(``stair_tpu_torch/train/{loop,evaluate,checkpoint}.py``) and the
transformer encoder (``stair_tpu_torch/ops/lstm.py transformer_encode``).

On one tiny world written by the JAX package's ``make_world`` and
``preprocess`` (H 32, F 24, B 16), on the CPU:

- the eval step against the JAX one, from one JAX-written checkpoint on
  the same batch: equal predictions; ``loss_sums``, ``loss_counts`` and
  ``cos_sum`` within 1e-4 relative (the JAX side on its XLA scan, the
  plain reference of its kernels);
- checkpoints both ways, with ``optax.adam`` and, under ``--weight-decay``,
  ``optax.adamw``: the port's ``main`` resumes a JAX-written ``latest/``
  (two optax updates): the step, the learning rate at the resume
  (``lr_schedule(step)``, which a restarted schedule fails) and the Adam
  moments equal to optax's ``mu`` / ``nu`` bit for bit; the JAX package's
  ``load_opt_state(dir, optimizer.init(params))`` restores what the port
  wrote, arrays and counts equal;
- three steps of ``main`` at dropout 0 equal three ``make_train_step``
  calls on the same batches, bit for bit;
- ``main`` and ``evaluate.main`` end to end with ``device="cpu"``: the
  four checkpoint files, the JAX trainer's metric names, the evaluate
  accuracy on the valid split equal to the trainer's best, the Filter
  audit pickle, a profiler trace;
- both evaluate CLIs on one JAX checkpoint, AGQA and STAR (the
  candidates' text): equal accuracy and result files; the trainer on
  STAR, whose open answer vocabulary is empty;
- ``main`` refuses ``--mesh-dp 3`` on a batch of 16 and ``evaluate.main``
  ``--mesh-tp 2`` alone (the JAX CLIs' GSPMD fallbacks; the data-parallel
  route itself is held in tests/test_torch_parallel.py);
- ``transformer_encode`` (tokens, sentence feature) within 1e-4 of JAX's,
  and a ``VideoNMN`` forward with ``encoder="transformer"``;
- the seeded initialisation keeps its draw order (a digest of the
  weights).
"""

import json
import os

import numpy as np
import pytest
import torch

from stair_tpu_torch.data import dataset as TDS
from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
from stair_tpu_torch.train import checkpoint as TCK
from stair_tpu_torch.train import evaluate as TEV
from stair_tpu_torch.train import loop as TLP
from stair_tpu_torch.weights import flatten_tree, params_from_numpy
from stair_tpu_torch.testing.agqa_world import trainer_argv, write_agqa_world
from torch_port_util import to_numpy_tree, write_star_world

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import serialization  # noqa: E402

from stair_tpu.data import dataset as JDS  # noqa: E402
from stair_tpu.models.nmn import NMNConfig as JNMNConfig  # noqa: E402
from stair_tpu.models.nmn import VideoNMN as JVideoNMN  # noqa: E402
from stair_tpu.ops import lstm as JLS  # noqa: E402
from stair_tpu.programs import preprocess as JPP  # noqa: E402
from stair_tpu.programs import scene_graph as JSG  # noqa: E402
from stair_tpu.testing import synthetic as JSY  # noqa: E402
from stair_tpu.train import checkpoint as JCK  # noqa: E402
from stair_tpu.train import evaluate as JEV  # noqa: E402
from stair_tpu.train import loop as JLP  # noqa: E402
from stair_tpu.train.args import get_args  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_agqa_world(tmp_path_factory.mktemp("trainer_world"), JSY,
                            JPP, JSG, num_videos=6, questions_per_video=6,
                            num_frames=24, seed=21)


def _paths(w):
    return dict(rgb_path=w["features"], glove_filename=w["glove"],
                vocab_filename=w["vocab"], video_secs_path=w["video_secs"],
                train_filename=w["train"], valid_filename=w["valid"],
                test_filename=w["test"], word2id_filename=w["word2id"])


def _jax_model(w, args):
    train = JDS.AGQADataset(JDS.DataPaths(**_paths(w)), "train",
                            max_video_length=args.max_video_length)
    valid = JDS.AGQADataset(JDS.DataPaths(**_paths(w)), "valid",
                            max_video_length=args.max_video_length)
    model, cfg = JLP.build_model(args, [train, valid])
    return model, cfg, model.init(jax.random.PRNGKey(0)), valid


def _optax(args):
    sched = JLP.lr_schedule(args)
    if args.weight_decay:
        return optax.adamw(sched, weight_decay=args.weight_decay)
    return optax.adam(sched)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(to_numpy_tree(
        serialization.to_state_dict(tree))).items()}


def test_eval_step_matches_jax_from_a_jax_checkpoint(world, tmp_path):
    args = get_args(trainer_argv(world, tmp_path))
    jmodel, cfg, params, jvalid = _jax_model(world, args)
    JCK.save_checkpoint(str(tmp_path / "ckpt"), params, cfg)
    jtables = JLP.make_device_tables(jvalid)
    jbatch = next(JLP.make_batcher(args, jvalid, jmodel, device_tables=True)
                  .epoch(shuffle=False))
    want = JLP.make_eval_step(jmodel, jtables)(
        params, JLP.batch_to_device_dict(jbatch))

    args.model_ckpt = str(tmp_path / "ckpt")
    tvalid = TDS.AGQADataset(TDS.DataPaths(**_paths(world)), "valid",
                             max_video_length=args.max_video_length)
    model = TEV.load_model(args, tvalid, CPU)
    tables = TLP.make_device_tables(tvalid, CPU)
    batcher = TLP.make_batcher(args, tvalid, model, device_tables=True)
    batch, bdict = next(TLP._device_batches(batcher, CPU, shuffle=False))
    assert batch.meta == jbatch.meta
    got = TLP.make_eval_step(model, tables)(bdict)
    np.testing.assert_array_equal(np.asarray(want["preds"]),
                                  got["preds"].numpy())
    for k in ("loss_sums", "loss_counts", "cos_sum", "cos_count"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(want["cos_count"]) > 0 and np.asarray(
        want["loss_counts"]).sum() > 0


def _star_argv(paths, out):
    return ["--dataset", "STAR", "--rgb-path", paths["rgb_path"],
            "--glove-filename", paths["glove_filename"], "--train-filename",
            paths["train_filename"], "--valid-filename",
            paths["valid_filename"], "--test-filename", paths["test_filename"],
            "--video-secs-path", paths["video_secs_path"], "--vocab-filename",
            paths["vocab_filename"], "--output", str(out), "--video-size",
            "32", "--text-size", "16", "--hidden-size", "32",
            "--max-video-length", "24", "--batch-size", "4"]


@pytest.mark.parametrize("kind", ["AGQA", "STAR"])
def test_evaluate_acc_writes_what_jax_writes(kind, world, tmp_path):
    """Both evaluate CLIs on one JAX-written checkpoint over the test split
    (STAR: multiple choice, the candidates' text, grouped by question
    type): equal accuracy and equal result files."""
    if kind == "AGQA":
        argv = trainer_argv(world, tmp_path)
        paths = _paths(world)
    else:
        paths = write_star_world(tmp_path / "star")
        argv = _star_argv(paths, tmp_path)
    args = get_args(argv)
    ds_cls = JLP.DATASET_CLASSES[kind]
    sets = [ds_cls(JDS.DataPaths(**paths), split,
                   max_video_length=args.max_video_length)
            for split in ("train", "valid")]
    jmodel, cfg = JLP.build_model(args, sets)
    JCK.save_checkpoint(str(tmp_path / "ckpt"), jmodel.init(
        jax.random.PRNGKey(0)), cfg)
    argv += ["--model-ckpt", str(tmp_path / "ckpt"), "--evaluate-func",
             "acc"]
    want = JEV.main(get_args(argv + ["--result-filename", "jax.json"]))
    got = TEV.main(argv + ["--result-filename", "port.json"], device="cpu")
    assert got == want
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        jres, tres = json.load(f), json.load(g)
    assert tres == jres
    assert (sum(map(len, tres.values())) if kind == "STAR"
            else len(tres["preds"])) > 0


def test_main_trains_on_star(tmp_path):
    """The trainer on a multiple-choice corpus, whose open answer vocabulary
    is empty: the answer loss is the choice head's CE, and finite."""
    out = tmp_path / "run"
    argv = _star_argv(write_star_world(tmp_path / "star"), out)
    best = TLP.main(argv + ["--num-epochs", "2", "--report-interval", "1",
                            "--evaluate-interval", "3"], device="cpu")
    assert 0.0 <= best <= 1.0
    recs = [json.loads(x) for x in open(out / "metrics.jsonl")]
    losses = [r["loss/total"] for r in recs if "loss/total" in r]
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert any("valid/acc" in r for r in recs)


def _jax_run(world, out, wd):
    """A JAX-written ``latest/``: params and optax state after two updates
    with seeded gradients, trainer state at step 2."""
    args = get_args(trainer_argv(world, out, "--weight-decay", str(wd),
                                 "--scheduler-total-iters", "10"))
    _, cfg, params, _ = _jax_model(world, args)
    tx = _optax(args)
    state = tx.init(params)
    rng = np.random.RandomState(4)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
            params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    key = [7, 8, 9, 10]
    JCK.save_checkpoint(os.path.join(out, "latest"), params, cfg,
                        opt_state=state,
                        trainer_state={"step": 2, "best_acc": 2.0,
                                       "rng": key})
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(cfg, f)
    return args, cfg, params, state, key


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["adam", "adamw"])
def test_port_resumes_a_jax_run(world, tmp_path, wd, capsys):
    out = str(tmp_path)
    args, cfg, params, state, key = _jax_run(world, out, wd)
    want = _flat_np(state)
    latest = os.path.join(out, "latest")

    # the restore itself: the schedule resumes at the step count
    model = VideoNMN(NMNConfig(**TCK.load_config(latest)), device=CPU)
    TCK.load_params(latest, model)
    opt, sched = TLP.make_optimizer(model, args)
    assert isinstance(opt, torch.optim.AdamW) == bool(wd)
    assert TCK.load_opt_state(latest, model, opt, sched) == 2
    lr = TLP.lr_schedule(args)
    assert lr(2) != lr(0)
    assert [g["lr"] for g in opt.param_groups] == [lr(2)]
    for key_path, p in flatten_tree(model.param_tree()).items():
        st = opt.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      want[f"0/mu/{key_path}"], key_path)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      want[f"0/nu/{key_path}"], key_path)
        assert float(st["step"]) == 2.0

    # main resumes without training (0 epochs) and writes the state back
    argv = trainer_argv(world, out, "--weight-decay", str(wd),
                        "--scheduler-total-iters", "10", "--config-filename",
                        os.path.join(out, "config.json"), "--model-ckpt",
                        latest)
    TLP.main(argv + ["--num-epochs", "0"], device="cpu")
    printed = capsys.readouterr().out
    assert "resuming at step 2 (optimizer state restored)" in printed
    with open(os.path.join(latest, "opt_state.msgpack"), "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    got = {k: np.asarray(v) for k, v in flatten_tree(raw).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)
    restored = JCK.load_opt_state(latest, _optax(args).init(params))
    assert int(restored[0].count) == 2
    st = TCK.load_trainer_state(latest)
    assert st["step"] == 2 and st["rng"] == key and st["best_acc"] == 2.0

    # one epoch on: the first update after the resume reads lr(2), the
    # report after it lr(3), and the step count adds up
    TLP.main(argv + ["--num-epochs", "1", "--report-interval", "1"],
             device="cpu")
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    first = next(r for r in recs if "lr/lr" in r)
    assert first["step"] == 3 and first["lr/lr"] == lr(3)
    n = len(TLP.make_batcher(args, TDS.AGQADataset(
        TDS.DataPaths(**_paths(world)), "train", max_video_length=24),
        model).indices)
    assert TCK.load_trainer_state(latest)["step"] == 2 + -(-n // 16)


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["adam", "adamw"])
def test_jax_restores_what_the_port_wrote(world, tmp_path, wd):
    args = TLP.parse_cli(trainer_argv(world, tmp_path, "--weight-decay",
                                      str(wd), "--dropout", "0"))
    tds = TDS.AGQADataset(TDS.DataPaths(**_paths(world)), "train",
                          max_video_length=24)
    model, cfg = TLP.build_model(args, [tds], CPU)
    tables = TLP.make_device_tables(tds, CPU)
    opt = TLP.make_optimizer(model, args)
    step = TLP.make_train_step(model, args, opt, tables)
    batcher = TLP.make_batcher(args, tds, model, device_tables=True)
    for _, bdict in list(TLP._device_batches(batcher, CPU, True))[:2]:
        step(bdict, torch.Generator().manual_seed(0), 1.0, 1.0)
    out = str(tmp_path / "latest")
    TCK.save_checkpoint(out, model, cfg,
                        opt_state=TCK.opt_state_tree(model, *opt),
                        trainer_state={"step": 2, "best_acc": 0.0,
                                       "rng": TLP.new_key(1, "rbg")})

    jmodel = JVideoNMN(JNMNConfig(**JCK.load_config(out)))
    params = JCK.load_params(out, jmodel.init(jax.random.PRNGKey(1)))
    tx = _optax(args)
    restored = JCK.load_opt_state(out, tx.init(params))
    assert int(restored[0].count) == int(restored[-1].count) == 2
    want = {k: p.detach().numpy() for k, p in
            flatten_tree(model.param_tree()).items()}
    got = _flat_np(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    for k, p in flatten_tree(model.param_tree()).items():
        st = opt[0].state[p]
        np.testing.assert_array_equal(
            np.asarray(flatten_tree(restored[0].mu)[k]),
            st["exp_avg"].numpy(), k)
        np.testing.assert_array_equal(
            np.asarray(flatten_tree(restored[0].nu)[k]),
            st["exp_avg_sq"].numpy(), k)
    # the restored state takes an update
    tx.update(jax.tree_util.tree_map(jnp.zeros_like, params), restored,
              params)


def test_main_takes_three_make_train_step_steps(world, tmp_path):
    argv = trainer_argv(world, tmp_path, "--dropout", "0", "--num-epochs",
                        "1", "--report-interval", "1", "--evaluate-interval",
                        "1000", batch=9)
    TLP.main(argv, device="cpu")
    args = TLP.parse_cli(argv)
    tds = TDS.AGQADataset(TDS.DataPaths(**_paths(world)), "train",
                          max_video_length=24)
    vds = TDS.AGQADataset(TDS.DataPaths(**_paths(world)), "valid",
                          max_video_length=24)
    model, _ = TLP.build_model(args, [tds, vds], CPU, "mega",
                               torch.Generator().manual_seed(args.rand_seed))
    step = TLP.make_train_step(model, args,
                               tables=TLP.make_device_tables(tds, CPU))
    batcher = TLP.make_batcher(args, tds, model, seed=args.rand_seed,
                               device_tables=True)
    losses = [float(step(bdict, torch.Generator(), 1.0, 1.0)["loss"])
              for _, bdict in TLP._device_batches(batcher, CPU, True)]
    assert len(losses) == 3
    recs = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["loss/total"] for r in recs if "loss/total" in r] == losses
    saved = VideoNMN(model.config, device=CPU)
    TCK.load_params(str(tmp_path / "latest"), saved)
    for k, p in flatten_tree(model.param_tree()).items():
        np.testing.assert_array_equal(
            flatten_tree(saved.param_tree())[k].detach().numpy(),
            p.detach().numpy(), k)


def test_main_and_evaluate_on_a_tiny_world(world, tmp_path):
    out = tmp_path / "run"
    common = trainer_argv(world, out)
    best = TLP.main(common + [
        "--num-epochs", "2", "--report-interval", "1",
        "--evaluate-interval", "2", "--lr", "1e-3",
        "--scheduler-total-iters", "20", "--profile-dir",
        str(tmp_path / "prof"), "--profile-start", "1", "--profile-steps",
        "1"], device="cpu")
    assert 0.0 <= best <= 1.0
    for d in ("best_model", "latest"):
        for f in ("params.msgpack", "config.json", "opt_state.msgpack",
                  "trainer_state.json"):
            assert os.path.exists(out / d / f), (d, f)
    assert os.path.exists(out / "code" / "stair_tpu_torch" / "train"
                          / "loop.py")
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    recs = [json.loads(x) for x in open(out / "metrics.jsonl")]
    names = set().union(*recs)
    assert {"loss/total", "lr/lr", "valid/acc", "loss/decoder",
            "loss/Filter", "perf/steps_per_sec"} <= names
    assert max(r["valid/acc"] for r in recs if "valid/acc" in r) == best

    acc = TEV.main(common + ["--model-ckpt", str(out / "best_model"),
                             "--evaluate-func", "acc", "--test-filename",
                             world["valid"], "--result-filename",
                             "preds.json"], device="cpu")
    assert acc == best
    with open(out / "preds.json") as f:
        preds = json.load(f)
    assert len(preds["preds"]) == len(preds["qa_ids"]) > 0
    results = TEV.main(common + [
        "--model-ckpt", str(out / "best_model"), "--evaluate-func",
        "filter_text_result", "--filter-answer-vocab-filename",
        world["filter"], "--result-filename", str(out / "filter.pkl"),
        "--end-index", "6"], device="cpu")
    assert isinstance(results, dict) and 0 < len(results) <= 6
    assert os.path.exists(out / "filter.pkl")
    for per_step in results.values():
        for level, keyword, top10 in per_step.values():
            assert isinstance(level, int) and isinstance(keyword, str)
            assert len(top10) == 10


def test_main_refuses_data_parallel(world, tmp_path):
    # where the JAX CLIs fall back to GSPMD with their kernels off, the
    # port, which has no such route, refuses before starting a rank
    with pytest.raises(ValueError, match="batch_size % dp == 0"):
        TLP.main(trainer_argv(world, tmp_path, "--mesh-dp", "3"),
                 device="cpu")
    with pytest.raises(ValueError, match="GSPMD"):
        TEV.main(trainer_argv(world, tmp_path, "--mesh-tp", "2"),
                 device="cpu")


def test_dropout_keys_follow_the_prng_and_resume():
    assert len(TLP.new_key(3, "rbg")) == 4
    assert len(TLP.new_key(3, "threefry2x32")) == 2
    key = TLP.new_key(3, "rbg")
    nxt, gen = TLP.split_key(key)
    again, gen2 = TLP.split_key(list(key))
    assert nxt == again and nxt != key and all(0 <= w < 2 ** 32 for w in nxt)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=gen2))


def test_transformer_encode_matches_jax():
    rng = np.random.RandomState(0)
    B, L, D, H = 3, 7, 10, 32
    params = to_numpy_tree(JLS.init_transformer_encoder_params(
        jax.random.PRNGKey(2), D, H))
    x = rng.randn(B, L, D).astype(np.float32)
    mask = (rng.rand(B, L) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[2] = 0.0                       # an all-padding row
    tok, sent = jax.vmap(lambda a, m: JLS.transformer_encode(params, a, m))(
        jnp.asarray(x), jnp.asarray(mask))
    from stair_tpu_torch.ops.lstm import (
        init_transformer_encoder_params, transformer_encode,
    )

    ttok, tsent = transformer_encode(params_from_numpy(params),
                                     torch.from_numpy(x),
                                     torch.from_numpy(mask))
    np.testing.assert_allclose(ttok.numpy(), np.asarray(tok), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tsent.numpy(), np.asarray(sent), rtol=1e-4,
                               atol=1e-4)
    mine = init_transformer_encoder_params(torch.Generator().manual_seed(0),
                                           D, H)
    assert (jax.tree_util.tree_map(lambda a: a.shape, params)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), mine))


def test_transformer_encoder_forward_matches_jax():
    from stair_tpu.testing import workload as JW
    from stair_tpu_torch.testing import workload as TW
    from torch_port_util import port_model, torch_batch

    cfg = JNMNConfig(**{**JW.workload_config(
        hidden_size=32, video_size=12, text_size=10,
        max_video_length=12).to_dict(), "encoder": "transformer"})
    params = JVideoNMN(cfg).init(jax.random.PRNGKey(0))
    batch = TW.make_batch(NMNConfig(**cfg.to_dict()), batch_size=4,
                          question_len=6)
    want = JVideoNMN(cfg).forward(params, batch)
    got = port_model(cfg, params)(torch_batch(batch))
    for k in ("logits", "question_feature", "token_features", "regs_vec"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_seeded_init_keeps_its_draw_order():
    # chip_smoke.py's phases build their models from a seed: the draws
    # (modules, video encoder, text encoder, decoder, choice head) must
    # keep their order, or every reading of those phases moves
    import hashlib

    from stair_tpu_torch.testing import workload as TW

    model = TW.build_model(TW.workload_config(
        hidden_size=64, video_size=24, text_size=20, max_video_length=12),
        seed=0)
    h = hashlib.sha256()
    for k in sorted(model.weights.keys()):
        h.update(k.encode())
        h.update(model.weights[k].detach().numpy().tobytes())
    assert h.hexdigest()[:16] == "c5e346bb4eaff9dd"
