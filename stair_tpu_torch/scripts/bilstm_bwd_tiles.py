"""Time the BiLSTM backward's float32 cluster route (``csrc/bilstm.cu``
``bilstm_bwd_f32_kernel`` and ``bilstm_dwh_f32_kernel``, TPU kernel #3 in
float32) at every batch tile the walk is compiled for (the multiples of 8
up to 24), on one NVIDIA GPU.

    python -m stair_tpu_torch.scripts.bilstm_bwd_tiles

Builds ``csrc/bilstm.cu`` alone with the port's nvcc flags under
``build/bilstm_bwd_tiles/`` (``bilstm_fwd_tiles.build_alone``). Prints the
card, the new kernels' ptxas lines, how many clusters of each tile the card
holds at once and the tile ``lstm.bwd_tile`` picks, at the training shapes
of ``bilstm_fwd_tiles.F32_SHAPES``: the program parser's batch (h 128, L
32, B 64) and the float32 NMN's two encoders (h 256, B 128, L 64 and 16).

At each shape, on stacks of the training forward, with holes in the masks
and an all-padding row, every tile must give the same bits on two
launches, lie within 1e-4 (``max|a - b| / max|b|``, each output) of
``bilstm_bwd_reference`` and of the general route, and give dxp at each
row's first valid step of the walk equal to the general route's bit for
bit. Then one JSON line per shape and round: the walk's time at each tile
alone (CUDA events, mean of 20 launches, the tiles in turns, reversed in
the second round), the dwh slices' and their sum's, the whole backward on
the picked tile, the general route's, ``torch.nn.LSTM``'s backward
(bidirectional, full length, with its input projection, float32 with TF32
off; a yardstick only) and the bound of ``chip_smoke.py`` at that shape.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import lstm as TL
from stair_tpu_torch.scripts.bilstm_fwd_tiles import F32_SHAPES, build_alone
from stair_tpu_torch.utils.device import card_identity, cuda_time_ms, exact_f32

KERNELS = ("bilstm_bwd_f32_kernel", "bilstm_dwh_f32_kernel")


def first_walk_steps(mask):
    """Each row's first valid step of the backward walk, for the rows with
    a valid step: ``(rows, t_f, t_b)``, the last valid position (the
    forward direction walks back from L - 1) and the first (the backward
    direction walks from 0)."""
    valid = mask > 0
    rows = valid.any(1).nonzero().squeeze(1)
    pos = torch.arange(mask.shape[1], device=mask.device).expand_as(mask)
    t_f = torch.where(valid, pos, -1).amax(1)[rows]
    t_b = torch.where(valid, pos, mask.shape[1]).amin(1)[rows]
    return rows, t_f, t_b


def first_steps_equal(out, general, mask) -> bool:
    """dxp_f and dxp_b of two backwards equal bit for bit at each row's
    first valid step of the walk, where no adjoint partial has entered."""
    rows, t_f, t_b = first_walk_steps(mask)
    return (torch.equal(out[0][rows, t_f], general[0][rows, t_f])
            and torch.equal(out[1][rows, t_b], general[1][rows, t_b]))


def rel_err(a, b) -> float:
    """max |a - b| over max |b| (float32)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


@contextlib.contextmanager
def forced(route=None, tile=None):
    """Launch the backward on ``route`` / walk ``tile`` whatever ``lstm``
    picks."""
    saved = TL.bwd_route, TL.bwd_tile
    if route is not None:
        TL.bwd_route = lambda dtype, h: route
    if tile is not None:
        TL.bwd_tile = lambda B, clusters: tile
    try:
        yield
    finally:
        TL.bwd_route, TL.bwd_tile = saved


def inputs(dev, B, L, D, h, seed):
    """float32 ``_prep`` outputs with ragged lengths, holes and an
    all-padding row (row 3), the training forward's stacks and seeded
    cotangents."""
    gen = torch.Generator().manual_seed(seed)
    p = TL.init_lstm_params(gen, D, h, device=dev)
    x = torch.randn(B, L, D, generator=gen).to(dev)
    lens = torch.randint(1, L + 1, (B,), generator=gen)
    mask = (torch.arange(L)[None] < lens[:, None]).float()
    mask *= (torch.rand(B, L, generator=gen) > 0.2).float()
    mask[:, 0] = 1.0
    mask[3] = 0.0
    args = TL._prep(p, x, mask.to(dev))
    stacks = TL.bilstm_train_call(*args)[3]
    cots = [torch.randn(B, L, h, generator=gen).to(dev) for _ in range(2)]
    cots.append(torch.randn(B, 2 * h, generator=gen).to(dev))
    return args, stacks, cots


def bound_ms(args, stacks, cots, out):
    """``chip_smoke.lstm_bound`` for the backward: three ``16 h^2``
    operations a live (row, step) over 67 TFLOP/s, against every argument,
    stack, cotangent and output once at 3.35 TB/s."""
    h = args[0].shape[-1] // 4
    ops = 3 * 16.0 * h * h * float(args[2].sum())
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*args, *stacks, *cots, *out))
    return max(ops / 67e12, nbytes / 3.35e12) * 1e3


def check_shape(args, stacks, cots, label):
    """Every tile against the plain version and the general route; returns
    the general route's outputs."""
    ref = TL.bilstm_bwd_reference(*args, stacks, *cots)
    with forced(route="general"):
        general = TL.bilstm_bwd_call(*args, stacks, *cots)
    for bt in TL.bwd_tiles():
        with forced(tile=bt):
            _build.reset_launches()
            k1 = TL.bilstm_bwd_call(*args, stacks, *cots)
            k2 = TL.bilstm_bwd_call(*args, stacks, *cots)
            torch.cuda.synchronize()
        want = {"bilstm_bwd_f32c": 2, "bilstm_dwh_f32c": 2,
                "bilstm_dwh_sum": 2}
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        if got != want:
            raise AssertionError(f"tile {bt} at {label}: launches {got}")
        if not all(torch.equal(a, b) for a, b in zip(k1, k2)):
            raise AssertionError(f"tile {bt} at {label}: two launches differ")
        errs = {w: max(rel_err(a, b) for a, b in zip(k1, other))
                for w, other in (("plain", ref), ("general", general))}
        if max(errs.values()) > 1e-4:
            raise AssertionError(f"tile {bt} at {label}: {errs}")
        if not first_steps_equal(k1, general, args[2]):
            raise AssertionError(f"tile {bt} at {label}: dxp at the first "
                                 "valid steps differs from the general route")
        print(json.dumps({**label, "tile": bt, "rel_err": errs,
                          "first_steps_equal": True}), flush=True)
    return general


def time_shape(dev, args, stacks, cots, general, picked, label):
    """Two rounds of times at one shape."""
    lib = _build.build()
    B, L, G = args[0].shape
    h = G // 4
    D = label["D"]
    stream = _build.stream_ptr(dev)
    dxp = [torch.zeros(B, L, G, device=dev) for _ in range(2)]
    slices = torch.empty(2, TL._consts()["DW_SPLIT"], h, G, device=dev)
    with forced(route="general"):
        general_ms = cuda_time_ms(
            lambda: TL.bilstm_bwd_call(*args, stacks, *cots), iters=5)
    whole_ms = cuda_time_ms(lambda: TL.bilstm_bwd_call(*args, stacks, *cots),
                            iters=20)
    lstm = torch.nn.LSTM(D, h, batch_first=True, bidirectional=True).to(dev)
    x = torch.randn(B, L, D, device=dev, requires_grad=True)
    g = torch.randn(B, L, 2 * h, device=dev)
    fwd = cuda_time_ms(lambda: lstm(x), iters=5)
    library = max(cuda_time_ms(lambda: lstm(x)[0].backward(g), iters=5)
                  - fwd, 0.0)
    dwh_ptrs = _build.pointers((stacks[0], stacks[2], *dxp, slices))

    def dwh():
        _build.check(lib.stair_bilstm_dwh_f32c(dwh_ptrs, B, L, h, stream),
                     "bilstm_dwh_f32c")

    parts = {bt: torch.empty(-(-B // bt), 2, G, device=dev)
             for bt in TL.bwd_tiles()}
    ptrs = {bt: _build.pointers((*args, *stacks, *cots, *dxp, parts[bt]))
            for bt in TL.bwd_tiles()}
    sums = [torch.empty(h, G, device=dev) for _ in range(2)] + [
        torch.empty(G, device=dev) for _ in range(2)]
    sum_ptrs = _build.pointers((slices, parts[picked], *sums))

    def walk(bt):
        _build.check(lib.stair_bilstm_bwd_f32c(ptrs[bt], B, L, h, bt,
                                               stream), "bilstm_bwd_f32c")

    def dwh_sum():
        _build.check(lib.stair_bilstm_dwh_sum(sum_ptrs, -(-B // picked), h,
                                              stream), "bilstm_dwh_sum")

    bound = bound_ms(args, stacks, cots, general)
    for turn in range(2):
        order = TL.bwd_tiles() if turn == 0 else TL.bwd_tiles()[::-1]
        ms = {}
        for bt in order:
            ms[bt] = cuda_time_ms(lambda: walk(bt), iters=20)
        print(json.dumps({
            **label, "turn": turn, "picked": picked,
            "walk_ms_by_tile": {bt: ms[bt] for bt in TL.bwd_tiles()},
            "dwh_ms": cuda_time_ms(dwh, iters=20),
            "dwh_sum_ms": cuda_time_ms(dwh_sum, iters=20),
            "whole_ms": whole_ms, "general_ms": general_ms,
            "nn_lstm_backward_ms": library, "bound_ms": bound}), flush=True)


def main():
    dev = torch.device("cuda")
    exact_f32()
    print(f"card {card_identity()}", flush=True)
    lib, log = build_alone(os.path.join(_build.BUILD_ROOT, os.pardir,
                                        "bilstm_bwd_tiles"))
    _build._lib = lib            # the wrappers launch from this library
    for r in _build.ptxas_report(log):
        if r["kernel"].startswith(KERNELS):
            print(json.dumps({"ptxas": r}), flush=True)
    shapes = [s for s in F32_SHAPES if s[6]]
    for h in sorted({s[5] for s in shapes}):
        held = {}
        for bt in TL.bwd_tiles():
            n = ctypes.c_int(0)
            _build.check(lib.stair_bilstm_bwd_f32c_clusters(
                h, bt, ctypes.byref(n)), "bilstm_bwd_f32c_clusters")
            held[bt] = n.value
        print(json.dumps({"h": h, "clusters_held_by_tile": held}),
              flush=True)
    for path, name, B, L, D, h, _ in shapes:
        picked = TL.bwd_tile(B, TL._bwd_clusters_held(dev, h))
        label = {"path": path, "encoder": name, "B": B, "L": L, "D": D,
                 "h": h}
        args, stacks, cots = inputs(dev, B, L, D, h, B + L)
        general = check_shape(args, stacks, cots, label)
        time_shape(dev, args, stacks, cots, general, picked, label)


if __name__ == "__main__":
    main()
