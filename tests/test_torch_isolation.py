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
``video_chatgpt_infer_batch`` at tiny widths and both LLM trainer CLIs
with their checkpoints; ``chip_smoke.py`` imports only the port and its
``kernels`` line names the thirteen ported kernels, each with a launch
counter. The port's sources carry no JAX/flax/optax import and no
import of ``stair_tpu``. ``python chip_smoke.py`` exits non-zero, quickly
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
    # fifteen since the scan executor's step kernel gained its tensor-core
    # route and the slot adds their many-entry launch (the test keeps the
    # name it had when there were nine)
    assert len(names) == len(set(names)) == 15, names
    assert set(names) <= set(_build.LAUNCHES), names
    assert {"flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
            "executor_step", "executor_step_tc", "slot_set", "slot_zero",
            "slot_add", "slot_add_many"} <= set(names)
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
