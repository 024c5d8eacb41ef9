"""Port parity: data-parallel NMN training and evaluation
(``stair_tpu_torch/parallel/mesh.py``, the ``dp`` route of
``stair_tpu_torch/train/{loop,evaluate}.py``).

Two gloo ranks on the CPU (``parallel.mesh.launch``) run the port's train
step on their shards of one batch made here, in the parent, from a seed;
the JAX package runs its ``jax.shard_map`` step on a 2-device host mesh
(the ``cpu_devices`` fixture) with its training kernels under the Pallas
interpreter, from the same weights (the weight bridge), at dropout 0. The
JAX step's gradients are read through an optimizer that keeps them as its
state, so the step under test is ``make_train_step(..., mesh=mesh)``
itself. Three cases: a window below the shard, a window equal to the
per-rank batch (``test_shard_map_window_equals_shard_batch``'s case), and
FilterFrame slots on both shards (trained):

- the loss at rtol 1e-4, the per-family sums and counts, and every
  gradient leaf as in ``test_train_step_gradients_match_jax`` (rtol 1e-4,
  atol 1e-4 of the leaf's largest value plus 1e-6);
- the two ranks' parameters equal bit for bit after every step.

Against the port's own single-process step on the global batch: the loss
and the first step's gradients within 1e-5, the parameters after three
Adam steps within 1e-4 (Adam turns a gradient's rounding into the same
relative error of its update), the eval step's predictions equal and its
sums within 1e-5. The trainer CLI with ``--mesh-dp 2`` (rank 0 alone
writes; a resume on both ranks continues the schedule) and the evaluate
CLI's accuracy and result file equal to one device's. The placement rules
(``shard_batch``, ``param_sharding``, ``llm_param_sharding``) against the
JAX ones leaf by leaf; ``use_data_parallel``'s guard and the refusals.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from stair_tpu_torch.parallel import mesh as TM
from stair_tpu_torch.testing.agqa_world import trainer_argv
from stair_tpu_torch.testing.dp import train_cases, train_steps
from stair_tpu_torch.train import evaluate as TEV
from stair_tpu_torch.train import loop as TLP
from stair_tpu_torch.weights import flatten_tree
from torch_port_util import to_numpy_tree

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from stair_tpu.llm import decoder as JD  # noqa: E402
from stair_tpu.parallel import mesh as JM  # noqa: E402
from stair_tpu.testing import workload as JW  # noqa: E402
from stair_tpu.train import loop as JLP  # noqa: E402
from test_mega_exec import PROGRAMS, _batch, _build  # noqa: E402

#: 12 examples of the all-opcode set: 6 a rank
B = 12
CASES = {
    "plain-window": dict(window=3, ff=False),
    "window-equals-shard": dict(window=6, ff=False),
    "filterframe-on-both-shards": dict(window=3, ff=True),
}


def _args(window, ff):
    return types.SimpleNamespace(
        lr=1e-2, scheduler_start_factor=1.0, scheduler_end_factor=0.1,
        scheduler_total_iters=4, module_loss_weight=1.0,
        decoder_loss_weight=1.0, batch_size=B,
        modules_no_intermediate_train=[] if ff else ["FilterFrame"],
        contrastive_window=window)


def _case_batch(cfg, ff):
    """The global batch: ``B`` all-opcode programs, fake supervision, and
    four FilterFrame slots (global example indices 1, 4 | 7, 10: two on
    each shard, the last not valid) when ``ff``."""
    batch, _ = _batch(cfg, PROGRAMS[::2][:B], seed=1)
    batch["answer"] = np.random.RandomState(3).randint(
        0, cfg.answer_vocab_length, (B,)).astype(np.int32)
    batch = JW.add_fake_supervision(batch, cfg)
    rng = np.random.RandomState(5)
    S, F = 4, cfg.max_video_length
    gold = rng.rand(S, F, cfg.object_types).astype(np.float32)
    gold /= gold.sum(-1, keepdims=True)
    batch["ff_index"] = np.array([[1, 0], [4, 1], [7, 0], [10, 2]], np.int32)
    batch["ff_gold"] = gold
    batch["ff_valid"] = np.array([1, 1, 1, 0], np.float32)
    if not ff:
        batch["ff_valid"] = np.zeros_like(batch["ff_valid"])
    return batch


@pytest.fixture(scope="module")
def setup():
    cfg, model, params = _build()
    assert cfg.dropout == 0.0
    cases = {name: (_args(**kw), _case_batch(cfg, kw["ff"]))
             for name, kw in CASES.items()}
    return cfg, model, params, cases


@pytest.fixture(scope="module")
def port_runs(setup):
    """The port's two gloo ranks over every case in one launch: one step
    of each JAX case, and three steps of the plain case with an eval
    batch; then the same on one process."""
    cfg, _, params, cases = setup
    npar = to_numpy_tree(params)
    calls = [dict(cfg_dict=cfg.to_dict(), params=npar, batch=b, args=a)
             for a, b in cases.values()]
    a, b = cases["plain-window"]
    calls.append(dict(cfg_dict=cfg.to_dict(), params=npar, batch=b, args=a,
                      steps=3, eval_batch=b))
    ranks = TM.launch(train_cases, 2, ["cpu", "cpu"], "gloo", args=(calls,))
    single = train_steps(None, **calls[-1])
    return {"ranks": ranks, "names": list(cases), "single": single}


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("STAIR_PALLAS_LSTM_TRAIN", "interpret")
    monkeypatch.setenv("STAIR_MEGA_TRAIN", "interpret")
    monkeypatch.setenv("STAIR_FUSED_EXEC", "0")
    monkeypatch.setenv("STAIR_MEGA_EXEC", "0")


def _keep_grads():
    """An optax transformation that leaves the parameters alone and keeps
    the gradients it is handed as its state."""
    def init(p):
        return jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, g), g

    return optax.GradientTransformation(init, update)


def _walk(ref, mine, check, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(mine), path
        for k in ref:
            _walk(ref[k], mine[k], check, f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(mine), path
        for i, (a, b) in enumerate(zip(ref, mine)):
            _walk(a, b, check, f"{path}/{i}")
    else:
        check(np.asarray(ref), np.asarray(mine), path)


def _close_to_scale(rel):
    def check(a, b, path):
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(b, a, rtol=rel,
                                   atol=rel * scale + 1e-6, err_msg=path)
    return check


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_jax_shard_map(setup, port_runs, cpu_devices,
                                       interpret_kernels, case):
    _, model, params, cases = setup
    args, batch = cases[case]
    mesh = JM.make_mesh(dp=2, tp=1, devices=cpu_devices[:2])
    assert JLP.use_shard_map(args, mesh) and TM.use_data_parallel(args, 2)
    keep = _keep_grads()
    step = JLP.make_train_step(model, keep, args, mesh=mesh)
    rep = NamedSharding(mesh, PartitionSpec())
    # the step donates its arguments: hand it a copy of the shared weights
    p = jax.device_put(jax.tree_util.tree_map(jnp.array, params), rep)
    _, jgrads, jm = step(p, jax.device_put(keep.init(p), rep),
                         JM.shard_batch(batch, mesh), jax.random.PRNGKey(0),
                         jnp.float32(1), jnp.float32(1))
    ranks = [r[port_runs["names"].index(case)] for r in port_runs["ranks"]]
    for r in ranks:
        np.testing.assert_allclose(r["loss"][0], float(jm["loss"]),
                                   rtol=1e-4)
        for k in ("loss_sums", "loss_counts"):
            np.testing.assert_allclose(r[k][0], np.asarray(jm[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    if CASES[case]["ff"]:
        # FilterFrame's telemetry row counts the three valid slots of both
        # shards beside what the plain case's batch (the same batch with no
        # valid slot) counts there
        plain = port_runs["ranks"][0][port_runs["names"].index(
            "plain-window")]
        fidx = 9
        assert (ranks[0]["loss_counts"][0][fidx]
                - plain["loss_counts"][0][fidx]) == 3
    assert ranks[0]["digest"] == ranks[1]["digest"]
    _walk(jax.device_get(jgrads), ranks[0]["grads"], _close_to_scale(1e-4))


def test_dp_step_matches_the_single_process_step(port_runs):
    dp0, dp1 = (r[-1] for r in port_runs["ranks"])
    one = port_runs["single"]
    assert dp0["digest"] == dp1["digest"]      # bit-equal after every step
    np.testing.assert_allclose(dp0["loss"], one["loss"], rtol=1e-5)
    for k in ("loss_sums", "loss_counts"):
        np.testing.assert_allclose(np.stack(dp0[k]), np.stack(one[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _walk(one["grads"], dp0["grads"], _close_to_scale(1e-5))

    def check(a, b, path):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4, err_msg=path)

    _walk(one["params"], dp0["params"], check)
    # the eval step: predictions gathered in example order, sums summed
    np.testing.assert_array_equal(dp0["eval"]["preds"], one["eval"]["preds"])
    np.testing.assert_array_equal(dp1["eval"]["preds"], one["eval"]["preds"])
    for k in ("loss_sums", "cos_sum"):
        np.testing.assert_allclose(dp0["eval"][k], one["eval"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(dp0["eval"]["loss_counts"],
                                  one["eval"]["loss_counts"])
    assert dp0["eval"]["cos_count"] == one["eval"]["cos_count"]


def test_shard_batch_follows_the_jax_specs(setup, cpu_devices):
    _, _, _, cases = setup
    _, batch = cases["filterframe-on-both-shards"]
    mesh = JM.make_mesh(dp=2, tp=1, devices=cpu_devices[:2])
    specs = JLP._dp_batch_specs(batch, mesh)
    parts = [TM.shard_batch(batch, r, 2) for r in range(2)]
    flat_specs = flatten_tree(specs)
    for key, x in flatten_tree(batch).items():
        for r, part in enumerate(parts):
            got = flatten_tree(part)[key]
            if flat_specs[key] == PartitionSpec("dp"):
                np.testing.assert_array_equal(got, x[r * 6:(r + 1) * 6],
                                              key)
            else:
                assert flat_specs[key] == PartitionSpec(), key
                assert got is x, key
    assert TM.REPLICATED_BATCH_KEYS == JM.REPLICATED_BATCH_KEYS


def _axis_table(shardings):
    """JAX NamedShardings -> the port's table: the axis named "tp"."""
    def axis(s):
        spec = tuple(s.spec)
        return spec.index("tp") if "tp" in spec else None
    return jax.tree_util.tree_map(axis, shardings)


@pytest.mark.parametrize("tp", [2, 7])
def test_param_sharding_tables_match_jax(setup, cpu_devices, tp):
    # 7 answers: tp 7 shards the decoder's vocab projection, tp 2 cannot
    _, _, params, _ = setup
    mesh = JM.make_mesh(dp=1, tp=tp, devices=cpu_devices[:tp])
    want = _axis_table(JM.param_sharding(params, mesh))
    assert TM.param_sharding(to_numpy_tree(params), tp) == want
    sharded = [v for v in flatten_tree(want).values() if v is not None]
    assert len(sharded) == (2 if tp == 7 else 0)


@pytest.mark.parametrize("tp", [2, 4])
def test_llm_param_sharding_tables_match_jax(cpu_devices, tp):
    from stair_tpu_torch.llm.decoder import Decoder, DecoderConfig

    kw = dict(vocab_size=40, d_model=32, num_heads=4, num_layers=2, d_ff=64,
              max_len=64)
    params = JD.Decoder(JD.DecoderConfig.llama(**kw)).init(
        jax.random.PRNGKey(0))
    mesh = JM.make_mesh(dp=1, tp=tp, devices=cpu_devices[:tp])
    want = _axis_table(JM.llm_param_sharding(params, mesh))
    assert TM.llm_param_sharding(to_numpy_tree(params), tp) == want
    port = Decoder(DecoderConfig.llama(**kw),
                   generator=torch.Generator().manual_seed(0))
    assert TM.llm_param_sharding(port.param_tree(), tp) == want
    assert any(v is not None for v in flatten_tree(want).values())


def test_use_data_parallel_guard_and_refusals(cpu_devices):
    def args(bs, window):
        return types.SimpleNamespace(batch_size=bs, contrastive_window=window)

    assert TM.use_data_parallel(args(16, 8), 1) is False
    assert TM.use_data_parallel(args(16, 8), 2) is True
    assert TM.use_data_parallel(args(16, 0), 4) is True
    with pytest.raises(ValueError, match="batch_size % dp == 0"):
        TM.use_data_parallel(args(16, 0), 3)
    with pytest.raises(ValueError, match=r"\(batch_size / dp\) % window"):
        TM.use_data_parallel(args(16, 8), 4)
    # where the JAX rule takes shard_map the port takes its ranks, and
    # where it falls back to GSPMD the port refuses
    for bs, window, dp in ((16, 8, 2), (16, 0, 3), (16, 8, 4), (12, 3, 2)):
        mesh = JM.make_mesh(dp=dp, tp=1, devices=cpu_devices[:dp])
        if JLP.use_shard_map(args(bs, window), mesh):
            assert TM.use_data_parallel(args(bs, window), dp)
        else:
            with pytest.raises(ValueError):
                TM.use_data_parallel(args(bs, window), dp)
    # make_mesh's arithmetic and its message
    assert TM.mesh_shape(0, 2, 8) == (4, 2) and TM.mesh_shape(0, 1) == (1, 1)
    with pytest.raises(ValueError) as jerr:
        JM.make_mesh(dp=3, tp=1, devices=cpu_devices[:2])
    with pytest.raises(ValueError) as terr:
        TM.mesh_shape(3, 1, 2)
    assert str(terr.value) == str(jerr.value)
    # a tp axis alone is JAX's GSPMD route: refused; dp ranks with tp
    # replicate the step
    ns = types.SimpleNamespace(mesh_dp=1, mesh_tp=2, batch_size=16,
                               contrastive_window=0)
    with pytest.raises(ValueError, match="GSPMD"):
        TM.plan(ns, torch.device("cpu"))
    ns.mesh_dp = 2
    dp, devices, backend = TM.plan(ns, torch.device("cpu"))
    assert (dp, backend) == (2, "gloo") and devices == [torch.device("cpu")] * 2
    ns.mesh_dp = ns.mesh_tp = 1
    assert TM.plan(ns, torch.device("cpu")) is None


def test_split_key_folds_the_rank():
    key = TLP.new_key(3, "rbg")
    nxt, g = TLP.split_key(key)
    nxt0, g0 = TLP.split_key(key, 0)
    nxt1, g1 = TLP.split_key(key, 1)
    assert nxt == nxt0 == nxt1            # every rank walks one key stream
    draws = [torch.rand(4, generator=x) for x in (g, g0, g1)]
    assert not torch.equal(draws[1], draws[2])
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(draws[1], torch.rand(4, generator=TLP.split_key(
        key, 0)[1]))


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="a data-parallel rank failed"):
        TM.launch(divmod, 2, ["cpu", "cpu"], "gloo", args=(0,))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny world written here, before any rank starts, by a process
    with a fixed string-hash seed (``make_world`` draws from lists built
    from sets: ROADMAP hazard "Inputs made from a seed")."""
    code = ("import json, sys\n"
            "from stair_tpu_torch.testing.agqa_world import write_agqa_world\n"
            "print(json.dumps(write_agqa_world(sys.argv[1], num_videos=4, "
            "questions_per_video=6, num_frames=16, seed=4)))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONHASHSEED": "0",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    res = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path_factory.mktemp("dp_world"))],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_and_evaluate_clis_on_two_ranks(world, tmp_path):
    out = tmp_path / "run"
    argv = trainer_argv(world, out, "--mesh-dp", "2", "--dropout", "0",
                        "--contrastive-window", "4",
                        "--report-interval", "1", "--rand-seed", "1",
                        frames=16, batch=8)
    best = TLP.main(argv + ["--num-epochs", "1"], device="cpu")
    for name in ("best_model", "latest"):
        assert sorted(os.listdir(out / name)) == [
            "config.json", "opt_state.msgpack", "params.msgpack",
            "trainer_state.json"]
    first = _metrics(out)
    steps = [m["step"] for m in first if "loss/total" in m]
    assert steps == list(range(1, len(steps) + 1))   # rank 0 alone writes
    # a resume on both ranks continues the step count and the schedule
    TLP.main(argv + ["--num-epochs", "1", "--model-ckpt",
                     str(out / "latest")], device="cpu")
    resumed = [m for m in _metrics(out)[len(first):] if "loss/total" in m]
    n = len(steps)
    assert [m["step"] for m in resumed] == list(range(n + 1, 2 * n + 1))
    sched = TLP.lr_schedule(TLP.parse_cli(argv))
    for m in resumed:
        assert m["lr/lr"] == pytest.approx(sched(m["step"]))
    # evaluate on two ranks == on one device, accuracy and result file
    ev = [*argv, "--model-ckpt", str(out / "best_model"), "--test-filename",
          world["valid"], "--result-filename", "res.json"]
    acc2 = TEV.main(ev + ["--output", str(tmp_path / "e2")], device="cpu")
    ev[ev.index("--mesh-dp") + 1] = "1"
    acc1 = TEV.main(ev + ["--output", str(tmp_path / "e1")], device="cpu")
    assert acc2 == acc1 and 0.0 <= best <= 1.0
    with open(tmp_path / "e1" / "res.json") as f1, \
            open(tmp_path / "e2" / "res.json") as f2:
        assert json.load(f1) == json.load(f2)
