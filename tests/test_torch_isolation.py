"""The port needs neither JAX nor the JAX package, and chip_smoke.py
refuses to run off the card.

A subprocess with ``sys.modules["jax"] = None`` and
``sys.modules["stair_tpu"] = None`` (any import of either then raises)
imports ``stair_tpu_torch`` and runs one tiny CPU forward, then
``chip_smoke.py``'s serving path (host parse/lower, tokenize, gather,
forward), one train step (losses, backward, Adam) and one tiny
``video_chatgpt_infer_batch`` at tiny widths; ``chip_smoke.py`` imports
only the port. The port's sources carry no JAX/flax/optax import and no
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
from stair_tpu_torch.models.nmn import NMNConfig
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


def test_chip_smoke_fails_fast_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
