"""The card's identity, the entry points' device choice, exact-f32
settings, and a CUDA-event timer."""

from __future__ import annotations

import subprocess

import torch


def card_identity() -> str:
    """``name, power.limit`` of every visible card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def pick_device(name=None) -> torch.device:
    """The device an entry point runs on: ``name`` when given (``--device
    cpu`` in the tests), else the first CUDA device; without one it exits
    instead of falling back to the CPU."""
    if name:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device("cuda", 0)


def exact_f32():
    """Make float32 matmuls and convolutions on the card true float32
    (no TF32), so a plain version is a float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cuda_time_ms(fn, iters=10, warmup=2) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls,
    between two CUDA events on the current stream, after ``warmup``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
