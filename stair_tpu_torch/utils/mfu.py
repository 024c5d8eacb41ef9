"""Model-FLOPs-utilization reporting (port of ``stair_tpu/utils/mfu.py``).

MFU = model FLOPs per step / step wall time / the card's peak FLOP/s: the
hardware-normalized form of a throughput claim. The JAX package reads its
FLOPs from XLA's cost analysis of the compiled step; the port counts them
with ``torch.utils.flop_counter.FlopCounterMode`` while the step runs
(``flops_of``), which counts the matrix products and convolutions (forward
and, when the step calls ``backward``, backward) and nothing elementwise.
The peaks come from a table keyed by ``torch.cuda.get_device_name``: dense
bf16 tensor-core FLOP/s and device-memory bytes/s from NVIDIA's data
sheets. An unknown card gives ``None``, as the JAX package's unknown chip
does.
"""

from __future__ import annotations

import torch

#: Dense bf16 peak FLOP/s per card (no sparsity). Public data-sheet numbers.
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,    # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H200": 989e12,
    "NVIDIA A100-SXM4-80GB": 312e12,
    "NVIDIA A100-SXM4-40GB": 312e12,
    "NVIDIA A100 80GB PCIe": 312e12,
}

#: Peak device-memory bandwidth per card, bytes/s. Public data-sheet
#: numbers. Decode reads every live parameter once per token, so its
#: utilization metric is bandwidth (MBU), not FLOPs.
_PEAK_HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
    "NVIDIA H200": 4.8e12,
    "NVIDIA A100-SXM4-80GB": 2.039e12,
    "NVIDIA A100-SXM4-40GB": 1.555e12,
    "NVIDIA A100 80GB PCIe": 1.935e12,
}


def _device_name(device) -> str:
    """``device`` as a card name: a name string passes through; a torch
    device (or None: the first card) is asked; no card gives ''."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    if device is None:
        if not torch.cuda.is_available():
            return ""
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


def _lookup(table, device):
    kind = _device_name(device)
    if kind in table:
        return table[kind]
    for name, value in table.items():
        if kind.startswith(name):
            return value
    return None


def chip_peak_hbm_bw(device=None) -> float | None:
    """Peak device-memory bandwidth (bytes/s) of ``device`` (a torch device
    or a card name; default the first card)."""
    return _lookup(_PEAK_HBM_BW, device)


def chip_peak_flops(device=None) -> float | None:
    """Dense bf16 peak FLOP/s of ``device`` (default: the first card)."""
    return _lookup(_PEAK_BF16, device)


def flops_of(fn, *args, **kwargs) -> float | None:
    """FLOPs of one call of ``fn(*args, **kwargs)``, counted while it runs
    (``FlopCounterMode``: matrix products and convolutions, 2 per
    multiply-add); None when nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def mfu(flops_per_step: float | None, step_seconds: float,
        device=None) -> float | None:
    """Fraction of the card's peak achieved; None when either input is
    unknown."""
    peak = chip_peak_flops(device)
    if not flops_per_step or not peak or step_seconds <= 0:
        return None
    return flops_per_step / step_seconds / peak


def format_mfu(flops_per_step: float | None, step_seconds: float,
               device=None) -> str:
    """Human line: achieved TFLOP/s and % of peak."""
    if not flops_per_step or step_seconds <= 0:
        return "mfu: n/a (no flop count)"
    achieved = flops_per_step / step_seconds
    util = mfu(flops_per_step, step_seconds, device)
    if util is None:
        return f"achieved {achieved / 1e12:.1f} TFLOP/s (peak unknown)"
    return (f"achieved {achieved / 1e12:.1f} TFLOP/s = "
            f"{util * 100:.1f}% of chip peak "
            f"({chip_peak_flops(device) / 1e12:.0f} TFLOP/s bf16)")
