"""Where the serving forward's or the train step's device time goes, on
one NVIDIA GPU.

    python -m stair_tpu_torch.scripts.profile_slice [--train] [--steps 3]
        [--trace PATH]

Serving (the default): builds the bench configuration
(``testing.workload.ServingBatches`` defaults: H = 512, video 1024, text
300, F = 64, 172 answers, bf16, B = 1024, the 128-program pool), times the
host parse/lower/tokenize of a batch, then runs ``--steps`` steady serving
steps (H2D, embedding gather, ``VideoNMN.forward``, logits fetch).

``--train``: the train step at ``scripts/bench_train_step.py``'s
configuration (``workload_config``: H = 512, video 1024, text 300, F = 64,
172 answers, 64 object types; bf16, dropout 0.25, B = 128, fake
supervision, Adam with the trainer's schedule), ``--steps`` steady steps
of ``train.loop.make_train_step`` on one device-resident batch.

Either way the steps run under ``torch.profiler``; it prints the device
time per step of the heaviest operators and the device's busy share of the
wall time. ``--trace`` writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from stair_tpu_torch.ops import _build
from stair_tpu_torch.testing import workload as W
from stair_tpu_torch.utils.device import card_identity, exact_f32


def busy_ms(prof) -> float:
    """Union of the device kernel intervals, in milliseconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for s, t in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e3


def serving_step(dev):
    """The serving forward of one batch of the bench configuration."""
    serving = W.ServingBatches(dev)
    model = W.build_model(serving.cfg, seed=0, device=dev)

    host_ms = []
    for i in range(5):
        t0 = time.perf_counter()
        hb = serving.host_batch(i)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    print("host parse+lower+tokenize ms per batch of "
          f"{serving.batch_size}: {[round(x, 3) for x in host_ms]}")

    def step():
        return model(serving.device_batch(hb))["logits"].float().cpu()

    return step


def train_step(dev):
    """One train step of ``scripts/bench_train_step.py``'s configuration."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.train.loop import make_train_step, trainer_defaults

    cfg = NMNConfig(**{**W.workload_config().to_dict(),
                       "compute_dtype": "bfloat16", "dropout": 0.25})
    batch = W.to_device(W.add_fake_supervision(
        W.make_batch(cfg, batch_size=128), cfg), dev)
    model = W.build_model(cfg, seed=0, device=dev)
    update = make_train_step(model, trainer_defaults())
    gen = torch.Generator().manual_seed(0)
    print(f"train step: {cfg.to_dict()}, B = 128")

    def step():
        return update(batch, gen, 1.0, 1.0)["loss"].item()

    return step


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of serving")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    dev = torch.device("cuda", 0)
    print(card_identity().splitlines()[0])
    exact_f32()
    _build.build()
    step = train_step(dev) if args.train else serving_step(dev)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n = args.steps
    rows = sorted(prof.key_averages(),
                  key=lambda e: e.self_device_time_total, reverse=True)
    print(f"{'operator':70s} {'device ms/step':>14s} {'calls/step':>10s}")
    for e in rows[:20]:
        if e.self_device_time_total <= 0:
            break
        print(f"{e.key[:70]:70s} {e.self_device_time_total / n / 1e3:14.3f} "
              f"{e.count / n:10.1f}")
    busy = busy_ms(prof)
    print(f"device busy {busy:.3f} ms of {wall:.3f} ms wall for {n} steps: "
          f"busy share {busy / wall:.3f}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
