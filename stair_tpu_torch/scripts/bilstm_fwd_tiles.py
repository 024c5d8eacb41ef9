"""Time the BiLSTM forward's cluster kernel (``csrc/bilstm.cu
bilstm_fwd_tc_kernel``, TPU kernels #1 and #2) at every batch tile it is
compiled for (the multiples of 8 up to 40), on one NVIDIA GPU.

    python -m stair_tpu_torch.scripts.bilstm_fwd_tiles [--batches 1024,128]

Builds ``csrc/bilstm.cu`` alone with the port's nvcc flags (seconds, not
the whole library's minutes) under ``build/bilstm_fwd_tiles/``. Prints the
card, how many clusters of each tile the card holds at once, and the tile
``lstm.fwd_tile`` picks for each B. Then, at the main paths' shapes (h
256, bf16; the video encoder L 64 / D 1024 and the question encoder L 16 /
D 300) for every B of ``--batches`` (serving's 1024, the train step's
128), in eval and in training with state stacks, it checks each tile
against ``bilstm_reference`` (2e-2) and prints one JSON line per shape and
round: each tile's time (CUDA events, mean of 20 launches, the tiles in
turns, reversed in the second round), the general route's and
``torch.nn.LSTM``'s (bidirectional, full length, with its input
projection; a yardstick only).
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
from stair_tpu_torch.utils.device import card_identity, cuda_time_ms

H = 256
#: encoder -> (L, D)
ENCODERS = {"video": (64, 1024), "question": (16, 300)}


def build_alone(out_dir):
    """Compile ``csrc/bilstm.cu`` alone; returns the bound CDLL."""
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "bilstm.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    _build._CSRC, "-o", so,
                    os.path.join(_build._CSRC, "bilstm.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    _build.bind_bilstm(lib)
    return lib


def tiles():
    c = TL._consts()
    return list(range(c["FWD_BT_MIN"], c["FWD_BT_MAX"] + 1, c["FWD_BT_MIN"]))


@contextlib.contextmanager
def forced(route=None, tile=None):
    """Launch on ``route`` / batch ``tile`` whatever ``lstm`` picks."""
    saved = TL.fwd_route, TL.fwd_tile
    if route is not None:
        TL.fwd_route = lambda dtype, h: route
    if tile is not None:
        TL.fwd_tile = lambda B, clusters: tile
    try:
        yield
    finally:
        TL.fwd_route, TL.fwd_tile = saved


def inputs(dev, B, L, D, seed):
    gen = torch.Generator().manual_seed(seed)
    p = TL.init_lstm_params(gen, D, H, device=dev)
    x = torch.randn(B, L, D, generator=gen).to(dev)
    lens = torch.randint(1, L + 1, (B,), generator=gen)
    mask = (torch.arange(L)[None] < lens[:, None]).float()
    return TL._prep(p, x, mask.to(dev), torch.bfloat16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1024,128",
                    help="comma-separated batch sizes (1024: serving, "
                         "128: the train step)")
    opts = ap.parse_args()
    dev = torch.device("cuda")
    print(f"card {card_identity()}", flush=True)
    lib = build_alone(os.path.join(_build.BUILD_ROOT, os.pardir,
                                   "bilstm_fwd_tiles"))
    _build._lib = lib            # the wrappers launch from this library
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = ctypes.c_int(0)
    held = {}
    for bt in tiles():
        _build.check(lib.stair_bilstm_fwd_tc_clusters(H, bt, ctypes.byref(n)),
                     "bilstm_fwd_tc_clusters")
        held[bt] = n.value
    clusters = TL._clusters_held(dev, H)
    batches = [int(b) for b in opts.batches.split(",")]
    print(json.dumps({"sms": sms, "clusters_held_by_tile": held,
                      "fwd_tile": {B: TL.fwd_tile(B, clusters)
                                   for B in batches}}), flush=True)
    dt = torch.bfloat16
    for B in batches:
        for train in (False, True):
            fn = TL.bilstm_train_call if train else TL.bilstm
            for name, (L, D) in ENCODERS.items():
                args = inputs(dev, B, L, D, seed=B + L)
                ref = TL.bilstm_reference(*args, token_dtype=dt)
                for bt in tiles():
                    with forced(tile=bt):
                        out = fn(*args, token_dtype=dt)
                    err = max(float((o.float() - r.float()).abs().max())
                              for o, r in zip(out[:3], ref))
                    if err > 2e-2:
                        raise AssertionError(f"tile {bt} at B {B} {name}: "
                                             f"{err}")
                with forced(route="general"):
                    general = cuda_time_ms(lambda: fn(*args, token_dtype=dt),
                                           iters=3)
                lstm = torch.nn.LSTM(D, H, batch_first=True,
                                     bidirectional=True).to(dev, dt)
                x = torch.randn(B, L, D, device=dev, dtype=dt)
                with torch.no_grad():
                    library = cuda_time_ms(lambda: lstm(x), iters=5)
                for turn in range(2):
                    order = tiles() if turn == 0 else tiles()[::-1]
                    ms = {}
                    for bt in order:
                        with forced(tile=bt):
                            ms[bt] = cuda_time_ms(
                                lambda: fn(*args, token_dtype=dt), iters=20)
                    print(json.dumps({
                        "B": B, "encoder": name, "train": train,
                        "turn": turn, "picked": TL.fwd_tile(B, clusters),
                        "ms_by_tile": {bt: ms[bt] for bt in tiles()},
                        "general_ms": general, "nn_lstm_ms": library}),
                        flush=True)


if __name__ == "__main__":
    main()
