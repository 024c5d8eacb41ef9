"""Time the BiLSTM forward's cluster kernels (``csrc/bilstm.cu``, TPU
kernels #1 and #2) at every batch tile they are compiled for (the multiples
of 8 up to 40 in bf16, up to 24 in float32), on one NVIDIA GPU.

    python -m stair_tpu_torch.scripts.bilstm_fwd_tiles [--batches 1024,128]
    python -m stair_tpu_torch.scripts.bilstm_fwd_tiles --dtype float32

Builds ``csrc/bilstm.cu`` alone with the port's nvcc flags (seconds, not
the whole library's minutes) under ``build/bilstm_fwd_tiles/``. Prints the
card, how many clusters of each tile the card holds at once, and the tile
the route's helper picks for each shape.

``--dtype bfloat16`` (the default): ``bilstm_fwd_tc_kernel`` at the main
paths' shapes (h 256; the video encoder L 64 / D 1024 and the question
encoder L 16 / D 300) for every B of ``--batches`` (serving's 1024, the
train step's 128), ``lstm.fwd_tile``'s pick; each tile is held against
``bilstm_reference`` (2e-2).

``--dtype float32``: ``bilstm_fwd_f32_kernel`` at the program parser's
shapes (h 128, L 32, D 256: its training batch of 64 and decode chunk of
256) and the float32 NMN's (h 256: B 128 training and B 1024 eval, the
video and question encoders), ``lstm.fwd_tile``'s pick (``--batches`` is
not read); each tile must equal the general route's outputs bit for bit
and lie within 1e-4 of ``bilstm_reference``.

Both modes, eval and training (with state stacks) as each shape runs: one
JSON line per shape and round with each tile's time (CUDA events, mean of
20 launches, the tiles in turns, reversed in the second round), the general
route's and ``torch.nn.LSTM``'s (bidirectional, full length, with its input
projection, in the same dtype; float32 with TF32 off; a yardstick only),
and the bound of ``chip_smoke.py`` at that shape.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import lstm as TL
from stair_tpu_torch.utils.device import card_identity, cuda_time_ms, exact_f32

#: bf16: encoder -> (L, D) at h 256
ENCODERS = {"video": (64, 1024), "question": (16, 300)}
#: float32: (path, encoder, B, L, D, h, train)
F32_SHAPES = (
    ("parser", "train", 64, 32, 256, 128, True),
    ("parser", "decode", 256, 32, 256, 128, False),
    ("nmn", "video", 128, 64, 1024, 256, True),
    ("nmn", "question", 128, 16, 300, 256, True),
    ("nmn", "video", 1024, 64, 1024, 256, False),
    ("nmn", "question", 1024, 16, 300, 256, False),
)


def build_alone(out_dir):
    """Compile ``csrc/bilstm.cu`` alone; returns the bound CDLL and the
    compiler's ``-Xptxas -v`` report."""
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "bilstm.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", _build._CSRC, "-o", so,
                          os.path.join(_build._CSRC, "bilstm.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    _build.bind_bilstm(lib)
    return lib, res.stdout + res.stderr


def tiles(dtype=torch.bfloat16):
    return TL.fwd_tiles("cluster32" if dtype == torch.float32 else "cluster")


@contextlib.contextmanager
def forced(route=None, tile=None):
    """Launch on ``route`` / batch ``tile`` whatever ``lstm`` picks."""
    saved = TL.fwd_route, TL.fwd_tile
    if route is not None:
        TL.fwd_route = lambda dtype, h: route
    if tile is not None:
        TL.fwd_tile = lambda B, clusters, route="cluster": tile
    try:
        yield
    finally:
        TL.fwd_route, TL.fwd_tile = saved


def inputs(dev, B, L, D, h, seed, dtype):
    gen = torch.Generator().manual_seed(seed)
    p = TL.init_lstm_params(gen, D, h, device=dev)
    x = torch.randn(B, L, D, generator=gen).to(dev)
    lens = torch.randint(1, L + 1, (B,), generator=gen)
    mask = (torch.arange(L)[None] < lens[:, None]).float()
    mm = None if dtype == torch.float32 else dtype
    return TL._prep(p, x, mask.to(dev), mm)


def flat(out):
    return (*out[:3], *out[3]) if len(out) == 4 else tuple(out)


def bound_ms(args, out, dtype):
    """The least time the card could take (H100 SXM peaks, as
    ``chip_smoke.py`` bounds): ``16 h^2`` operations a live (row, step)
    over 67 TFLOP/s (float32) or 989 (bf16), against every argument read
    and every output (stacks included) written once at 3.35 TB/s."""
    h = args[0].shape[-1] // 4
    ops = 16.0 * h * h * float(args[2].sum())
    peak = 67e12 if dtype == torch.float32 else 989e12
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *flat(out)))
    return max(ops / peak, nbytes / 3.35e12) * 1e3


def time_shape(dev, dtype, args, B, L, D, h, train, picked, label):
    """Check every tile on ``args``, then print two rounds of times."""
    fn = TL.bilstm_train_call if train else TL.bilstm
    ref = TL.bilstm_reference(*args, token_dtype=dtype, return_stacks=train)
    with forced(route="general"):
        general = fn(*args, token_dtype=dtype)
    for bt in tiles(dtype):
        with forced(tile=bt):
            out = fn(*args, token_dtype=dtype)
        err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(flat(out), flat(ref)))
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        if err > tol:
            raise AssertionError(f"tile {bt} at {label}: {err}")
        if dtype == torch.float32 and not all(
                torch.equal(a, b) for a, b in zip(flat(out), flat(general))):
            raise AssertionError(f"tile {bt} at {label}: not the general "
                                 "route's bits")
    with forced(route="general"):
        general_ms = cuda_time_ms(lambda: fn(*args, token_dtype=dtype),
                                  iters=3)
    lstm = torch.nn.LSTM(D, h, batch_first=True, bidirectional=True).to(
        dev, dtype)
    x = torch.randn(B, L, D, device=dev, dtype=dtype)
    with torch.no_grad():
        library = cuda_time_ms(lambda: lstm(x), iters=5)
    for turn in range(2):
        order = tiles(dtype) if turn == 0 else tiles(dtype)[::-1]
        ms = {}
        for bt in order:
            with forced(tile=bt):
                ms[bt] = cuda_time_ms(lambda: fn(*args, token_dtype=dtype),
                                      iters=20)
        print(json.dumps({
            **label, "train": train, "dtype": str(dtype)[6:], "turn": turn,
            "picked": picked, "ms_by_tile": {bt: ms[bt] for bt in tiles(
                dtype)}, "general_ms": general_ms, "nn_lstm_ms": library,
            "bound_ms": bound_ms(args, general, dtype)}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1024,128",
                    help="bf16: comma-separated batch sizes (1024: serving, "
                         "128: the train step)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    opts = ap.parse_args()
    dev = torch.device("cuda")
    exact_f32()
    print(f"card {card_identity()}", flush=True)
    lib, log = build_alone(os.path.join(_build.BUILD_ROOT, os.pardir,
                                        "bilstm_fwd_tiles"))
    _build._lib = lib            # the wrappers launch from this library
    kern = ("bilstm_fwd_f32_kernel" if opts.dtype == "float32"
            else "bilstm_fwd_tc_kernel")
    for r in _build.ptxas_report(log):
        if r["kernel"].startswith(kern):
            print(json.dumps({"ptxas": r}), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if opts.dtype == "float32":
        dt = torch.float32
        for h in sorted({s[5] for s in F32_SHAPES}):
            held = {}
            for bt in tiles(dt):
                n = ctypes.c_int(0)
                _build.check(lib.stair_bilstm_fwd_f32c_clusters(
                    h, bt, ctypes.byref(n)), "bilstm_fwd_f32c_clusters")
                held[bt] = n.value
            print(json.dumps({"sms": sms, "h": h,
                              "clusters_held_by_tile": held}), flush=True)
        for path, name, B, L, D, h, train in F32_SHAPES:
            picked = TL.fwd_tile(B, TL._clusters_held(dev, h, "cluster32"),
                                 "cluster32")
            args = inputs(dev, B, L, D, h, B + L, dt)
            time_shape(dev, dt, args, B, L, D, h, train, picked,
                       {"path": path, "encoder": name, "B": B, "L": L,
                        "h": h})
        return
    n = ctypes.c_int(0)
    held = {}
    for bt in tiles():
        _build.check(lib.stair_bilstm_fwd_tc_clusters(256, bt,
                                                      ctypes.byref(n)),
                     "bilstm_fwd_tc_clusters")
        held[bt] = n.value
    clusters = TL._clusters_held(dev, 256)
    batches = [int(b) for b in opts.batches.split(",")]
    print(json.dumps({"sms": sms, "clusters_held_by_tile": held,
                      "fwd_tile": {B: TL.fwd_tile(B, clusters)
                                   for B in batches}}), flush=True)
    dt = torch.bfloat16
    for B in batches:
        for train in (False, True):
            for name, (L, D) in ENCODERS.items():
                args = inputs(dev, B, L, D, 256, B + L, dt)
                time_shape(dev, dt, args, B, L, D, 256, train,
                           TL.fwd_tile(B, clusters),
                           {"B": B, "encoder": name})


if __name__ == "__main__":
    main()
