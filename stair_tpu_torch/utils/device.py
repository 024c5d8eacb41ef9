"""The card's identity, the entry points' device choice, exact-f32
settings, and two CUDA-event timers."""

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


def pick_device(name=None, rank: int = 0) -> torch.device:
    """The device an entry point (or its data-parallel rank ``rank``) runs
    on: ``name`` when given (``--device cpu`` in the tests; ``cuda``
    without an index is the rank's card), else the rank's CUDA device;
    without one it exits instead of falling back to the CPU."""
    if name:
        dev = torch.device(name)
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", rank)
        return dev
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device("cuda", rank)


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


def graph_ms(fn, iters=20) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph and replayed, so that no host time sits between the
    launches (at the main path's shapes the attention wrappers' Python
    takes longer than their kernels, and back-to-back calls time the
    host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    return cuda_time_ms(graph.replay, iters=5, warmup=2) / iters
