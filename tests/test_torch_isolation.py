"""The port needs neither JAX nor the JAX package, and chip_smoke.py
refuses to run off the card.

A subprocess with ``sys.modules["jax"] = None`` and
``sys.modules["stair_tpu"] = None`` (any import of either then raises)
imports ``stair_tpu_torch`` (the scan executor's modules too:
``models/rev_exec.py``, ``ops/executor_step.py``, ``ops/regslots.py``) and
runs one tiny CPU forward, then ``chip_smoke.py``'s serving path (host
parse/lower, tokenize, gather, forward), one train step (losses, backward,
Adam), one tiny forward on the ``"step"`` executor and one train step on the
``"rev"`` executor, one tiny
``video_chatgpt_infer_batch`` at tiny widths, both LLM trainer CLIs
with their checkpoints, and the NMN trainer and evaluate CLIs on a tiny
world that the port's own ``testing/synthetic.py`` and
``programs/preprocess.py`` write (``--executor rev``), the program parser's CLI (train, predict,
check_valid) on that world; records that the JAX package's
preprocess wrote load with both blocked; ``chip_smoke.py`` imports only
the port, lists 19 phases, and its ``kernels`` line names the thirteen
ported kernels (17 entries, and #1-#3 again on the parser's path), each
with a launch counter. The port's
sources carry no JAX, flax or optax import and no import of
``stair_tpu``. ``python chip_smoke.py`` exits non-zero, quickly
and without its result line, where there is no CUDA device.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_FORWARD = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "stair_tpu"):
    sys.modules[name] = None
import torch
import stair_tpu_torch
import stair_tpu_torch.models.rev_exec
import stair_tpu_torch.ops.executor_step
import stair_tpu_torch.ops.regslots
from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
from stair_tpu_torch.testing import workload as W

cfg = NMNConfig(**{**W.workload_config(
    hidden_size=32, video_size=8, text_size=6,
    max_video_length=12).to_dict()})
model = W.build_model(cfg, seed=0)
out = model(W.to_device(W.make_batch(cfg, batch_size=3, question_len=5)))
assert out["logits"].shape == (3, cfg.answer_vocab_length)
assert torch.isfinite(out["logits"]).all()

# chip_smoke.py's serving path: native parse/lower with span linking,
# tokenization, embedding gather, forward
serving = W.ServingBatches("cpu", batch_size=4, question_len=6,
                           pool_size=12, hidden_size=16, video_size=8,
                           text_size=6, max_video_length=8,
                           compute_dtype="float32")
model = W.build_model(serving.cfg, seed=0)
logits = model(serving.device_batch(serving.host_batch(0)))["logits"]
assert logits.shape == (4, serving.cfg.answer_vocab_length)
assert torch.isfinite(logits).all()

# one train step: training forward with dropout, the supervision losses,
# backward, Adam
from stair_tpu_torch.train.loop import make_train_step, trainer_defaults
cfg = NMNConfig(**{**cfg.to_dict(), "dropout": 0.25})
model = W.build_model(cfg, seed=0)
batch = W.to_device(W.add_fake_supervision(
    W.make_batch(cfg, batch_size=3, question_len=5), cfg))
step = make_train_step(model, trainer_defaults(contrastive_window=2))
m = step(batch, torch.Generator().manual_seed(0), 1.0, 1.0)
assert torch.isfinite(m["loss"])

# the scan executor: one forward through the fused step's plain version,
# one train step through the reversible executor and the slot updates
stepper = VideoNMN(cfg, model.param_tree(), executor="step")
out = stepper({k: v for k, v in batch.items()})
assert torch.isfinite(out["logits"]).all()
rev = VideoNMN(cfg, generator=torch.Generator().manual_seed(0),
               executor="rev")
m = make_train_step(rev, trainer_defaults(contrastive_window=2))(
    batch, torch.Generator().manual_seed(0), 1.0, 1.0)
assert torch.isfinite(m["loss"])

# one tiny Video-ChatGPT inference batch: CLIP tower, pooling, splice,
# prefill through the attention wrapper, KV-cache decode
import argparse
import numpy as np
from stair_tpu_torch.llm import videochat_infer as VI
vmodel, tok = VI.initialize_model(argparse.Namespace(
    model_path=None, vision_path=None, model_ckpt=None, device="cpu"))
frames = [np.random.RandomState(i).randint(0, 255, (4, 60, 70, 3))
          .astype(np.uint8) for i in range(2)]
answers = VI.video_chatgpt_infer_batch(
    vmodel, tok, ["what did they do ?", "question video"], frames,
    max_new_tokens=4, temperature=0.0)
assert len(answers) == 2 and all(isinstance(a, str) for a in answers)

# the LLM training path: both trainer CLIs on seeded tiny data (attention
# forward and backward through the autograd Function), the checkpoint
# codec, and the inference CLI's model on the saved checkpoint
import tempfile
from stair_tpu_torch.llm import videochat_train as VT, with_video_lm as WL
from stair_tpu_torch.testing import videochat as VW
root = tempfile.mkdtemp()
paths = VW.write_tiny_data(root, video_token_len=26, vision_dim=16)
loss = VT.main(["--data-path", paths["conv"], "--features-dir",
                paths["chat_features"], "--output", root + "/sft",
                "--device", "cpu", "--hidden-size", "64", "--lm-layers", "2",
                "--vision-dim", "16", "--vision-image-size", "28",
                "--max-temporal", "22", "--max-len", "96", "--batch-size",
                "8", "--num-epochs", "1", "--tune-mm-projector-only"])
assert loss == loss
vmodel, tok = VI.initialize_model(argparse.Namespace(
    model_path=None, vision_path=None, model_ckpt=root + "/sft",
    device="cpu"))
assert vmodel.config.decoder.d_model == 64
common = ["--rgb-path", paths["rgb"], "--train-filename", paths["train"],
          "--valid-filename", paths["valid"], "--test-filename",
          paths["test"], "--device", "cpu", "--hidden-size", "64",
          "--lm-layers", "1", "--max-video-length", "8",
          "--tokenizer-max-length", "16", "--batch-size", "8"]
best = WL.main([*common, "--num-epochs", "1", "--output", root + "/lm"])
assert WL.main([*common, "--func", "test", "--model-ckpt",
                root + "/lm"]) == best
# the NMN trainer and evaluate CLIs on a tiny world that the port's own
# synthetic world and preprocess copies write
import stair_tpu_torch.data.dataset
import stair_tpu_torch.testing.synthetic
from stair_tpu_torch.programs import preprocess as PP, scene_graph as SG
from stair_tpu_torch.testing import synthetic as SY
from stair_tpu_torch.train import evaluate as TEV, loop as TLP
from stair_tpu_torch.testing.agqa_world import trainer_argv, write_agqa_world
w = write_agqa_world(root + "/nmn", SY, PP, SG, num_videos=4,
                     questions_per_video=5, num_frames=16, seed=2)
argv = trainer_argv(w, root + "/nmn/run", "--executor", "rev", frames=16,
                    batch=8)
best = TLP.main(argv + ["--num-epochs", "1"], device="cpu")
acc = TEV.main(argv + ["--model-ckpt", root + "/nmn/run/best_model",
                       "--test-filename", w["valid"]], device="cpu")
assert acc == best, (acc, best)
# the program parser's CLI on the same world: train, predict, check_valid;
# the parity study's module imports
import stair_tpu_torch.scripts.parity_study
from stair_tpu_torch.seq2seq import train as TS2
pwords = ["--arch", "lstm", "--train-filename", w["train"], "--output",
          root + "/parser", "--embed-dim", "16", "--hidden", "16",
          "--batch-size", "4", "--num-epochs", "1", "--beam-size", "2",
          "--max-tgt-len", "12", "--device", "cpu"]
TS2.main(["--func", "train", *pwords])
TS2.main(["--func", "predict", *pwords, "--test-filename", w["test"],
          "--result-filename", root + "/parser/gen.tsv"])
rates = TS2.main(["--func", "check_valid", *pwords, "--result-filename",
                  root + "/parser/gen.tsv"])
assert len(rates) == 2
# the demo server's backend, data-parallel shards, a weight delta, the
# utilization arithmetic and the copied reformatter
from stair_tpu_torch.serve.demo import ChatBackend, LatencyTracker, make_handler
import stair_tpu_torch.llm.reformat_agqa
from stair_tpu_torch.llm import weight_delta as WD
from stair_tpu_torch.parallel import mesh as PM
from stair_tpu_torch.utils import mfu
chat = ChatBackend(num_frames=4, device="cpu")
sid = chat.open_frames(frames[0])
assert isinstance(chat.chat(sid, "what did they do ?"), str)
assert make_handler(chat, LatencyTracker()) is not None
half = PM.shard_batch({"answer": np.arange(4), "ff_index": np.zeros((2, 2)),
                       "trace": {"opcode": np.ones((4, 3))}}, 1, 2)
assert half["answer"].tolist() == [2, 3] and half["ff_index"].shape == (2, 2)
tree = WD.params_tree(vmodel)
assert WD.apply_delta(tree, WD.make_delta(tree, tree)).keys() == tree.keys()
assert mfu.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "stair_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_and_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_FORWARD], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_import_no_jax():
    # ``stair_tpu\b`` does not match ``stair_tpu_torch`` (``_`` is a word
    # character): any ``import stair_tpu``, ``from stair_tpu import`` or
    # ``from stair_tpu.x import`` is an offence.
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|stair_tpu)\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "stair_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for pkg in ("parallel", "serve"):
        assert any(os.sep + pkg + os.sep in p for p in paths), pkg
    offenders = []
    for path in paths:
        with open(path) as f:
            if pat.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


def test_chip_smoke_imports_only_the_port():
    pat = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        mods = {m.split(".")[0] for m in pat.findall(f.read())}
    assert "stair_tpu_torch" in mods
    assert "stair_tpu" not in mods


def test_chip_smoke_lists_nine_kernels_with_launch_counters():
    from stair_tpu_torch.ops import _build

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        text = f.read()
    names = re.findall(r'\{"name": "(\w+)", "route": "cuda"', text)
    # eighteen since the step kernel's float32 "fma32" route gained its
    # entry (seventeen when the slot sets and zeros gained their many-entry
    # launches beside the adds'; the test keeps the name it had when there
    # were nine)
    assert len(names) == len(set(names)) == 18, names
    assert set(names) <= set(_build.LAUNCHES), names
    assert {"flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
            "executor_step", "executor_step_tc", "executor_step_fma32",
            "slot_set", "slot_zero", "slot_add", "slot_set_many",
            "slot_zero_many", "slot_add_many"} <= set(names)
    for src in set(re.findall(r'"(stair_tpu_torch/ops/csrc/\w+\.cu)"',
                              text)):
        assert os.path.exists(os.path.join(REPO, src)), src
    for site in set(re.findall(r'"replaces": "(stair_tpu/[\w/.]+):(\d+)"',
                               text)):
        with open(os.path.join(REPO, site[0])) as f:
            assert int(site[1]) <= len(f.readlines()), site


def test_chip_smoke_fails_fast_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_serving_inputs_do_not_depend_on_the_hash_salt():
    # the word vectors behind ``ServingBatches`` are seeded by the word, and
    # Python salts ``hash(str)`` per process: two processes with different
    # salts must draw the same table
    code = ("from stair_tpu_torch.testing.workload import HashEmbeddings\n"
            "v = HashEmbeddings(8)._vector('holding')\n"
            "print(v.tobytes().hex())\n")
    seen = set()
    for salt in ("1", "2"):
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO,
            env={**_env(), "PYTHONHASHSEED": salt},
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        seen.add(proc.stdout.strip())
    assert len(seen) == 1, seen


_BLOCKED_RECORDS = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "stair_tpu"):
    sys.modules[name] = None
from stair_tpu_torch.data.dataset import AGQADataset, Batcher, DataPaths
paths = DataPaths(**{k: sys.argv[i + 1] for i, k in enumerate((
    "rgb_path", "glove_filename", "vocab_filename", "video_secs_path",
    "train_filename", "valid_filename", "test_filename",
    "word2id_filename"))})
for split in ("train", "valid", "test"):
    ds = AGQADataset(paths, split, max_video_length=16)
    assert len(ds) and all(t is not None for t in ds.traces)
    T, NV, NF, NA = ds.trace_geometry()
    b = next(Batcher(ds, 4, T, NV, NF, NA, device_tables=True).epoch())
    assert b.question_ids.shape[0] == 4
print("OK")
"""


def test_jax_written_records_load_with_jax_blocked(tmp_path):
    # the .pkl records of the JAX package's preprocess hold no object of a
    # stair_tpu class: the port reads them with stair_tpu unimportable
    from stair_tpu.programs import preprocess, scene_graph
    from stair_tpu.testing import synthetic
    from stair_tpu_torch.testing.agqa_world import write_agqa_world

    w = write_agqa_world(tmp_path, synthetic, preprocess, scene_graph,
                         num_videos=4, questions_per_video=5, num_frames=16,
                         seed=2)
    argv = [w["features"], w["glove"], w["vocab"], w["video_secs"],
            w["train"], w["valid"], w["test"], w["word2id"]]
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RECORDS, *argv], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_has_eighteen_phases_and_seventeen_kernel_entries():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        text = f.read()
    doc = ast.get_docstring(ast.parse(text))
    # twenty-one phases since the demo server's and data parallel's (the
    # test keeps the name it had at eighteen phases and seventeen entries;
    # eighteen entries since phase 16's float32 "fma32" step entry);
    # phase 19's three entries are #1-#3 on the parser's path, built in one
    # comprehension; phases 20 and 21 add no kernel entry; phase 22's
    # three entries are #4-#6 at the NMN CLIs' default F 150, built by one
    # helper, and phase 23's the same in bf16 on phase 22's world (one
    # directory for both); phase 24's two are #10 at F 150 in float32 and
    # bf16 on the evaluate CLI's --executor step, built in one
    # comprehension
    numbers = [int(n) for n in re.findall(r"^(\d+)\. ", doc, re.M)]
    assert numbers == list(range(1, 25)), numbers
    assert "phase_clis(dev, card)" in text
    assert "kernels += phase_parser(dev, card, clis)" in text
    assert "phase_demo(dev, card, model)" in text
    assert "phase_data_parallel(dev, card, clis)" in text
    assert "kernels += phase_default_clis(dev, card, root)" in text
    assert "kernels += phase_bf16_clis(dev, card, root)" in text
    assert "kernels += phase_step_clis(dev, card)" in text
    names = re.findall(r'\{"name": "(\w+)", "route": "cuda"', text)
    assert len(names) == 18, names
    assert re.search(r'\{"name": name, "route": "cuda", \*\*rec\} for name, '
                     r'rec in \(\s+\("executor_step_fma32", f32\), '
                     r'\("executor_step_tc", bf16\)\)', text)
    assert re.search(r'\{"name": k, "route": "cuda", "path": "parser"',
                     text)
