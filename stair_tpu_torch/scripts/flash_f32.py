"""Time the float32 attention backward (``csrc/flash_attn_bwd.cu``: TPU
kernels #8, #9) beside ``scaled_dot_product_attention``'s in float32 on one
NVIDIA GPU, and name the device kernels SDPA launches.

    python -m stair_tpu_torch.scripts.flash_f32

Run from the repo root (it reads the shapes and bounds of
``chip_smoke.py``). At each of ``chip_smoke.F32_ATTENTION_SHAPES`` (the
float32 forwards of the LLM trainer CLIs at full lengths, and phase 9's
L 640, D 128 case) it prints one JSON line with the card's name and power
limit:

* the backward on the out and lse of the forward's own route (``"mma32"``):
  the dQ launch (which writes ``di``), the dK/dV launch, and both as
  training calls them, by CUDA-graph replay, and the plain version's
  (``flash_backward_reference``) by CUDA events;
* SDPA's autograd backward of dQ, dK and dV with the boolean mask (forward
  + backward less forward, graph replay), as the yardstick;
* the names of the device kernels SDPA's forward and its backward launch
  (``torch.profiler``);
* the bounds of ``chip_smoke.attention_bwd_bounds`` (67 TFLOP/s float32,
  3.35 TB/s).

The forward's float32 times (``"mma32"``, ``"simple"``, SDPA, the plain
version) are ``chip_smoke.py`` phase 9's, at the same shapes.
"""

from __future__ import annotations

import json

import torch

from stair_tpu_torch.ops import attention as TA
from stair_tpu_torch.utils.device import (
    card_identity, cuda_time_ms, exact_f32, graph_ms,
)


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def time_shape(dev, gen, shape):
    """One shape of ``chip_smoke.F32_ATTENTION_SHAPES`` as a JSON record."""
    import chip_smoke

    name, B, H, L, D, prefix, valid = shape
    q, k, v, dout = (torch.randn(B, L, H, D, generator=gen, device=dev)
                     .transpose(1, 2) for _ in range(4))
    pl = torch.full((B,), prefix, dtype=torch.int32, device=dev)
    vl = torch.tensor(valid or [L] * B, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    out, lse = TA._launch(q, k, v, pl, vl, True, scale, True)
    rec = {"shape": name, "B": B, "H": H, "L": L, "D": D, "prefix": prefix,
           "fwd_route": TA.fwd_route(q.dtype, D, True),
           "bwd_route": TA.route(q.dtype, D, True)}

    args, _, keep = TA._backward_args(q, k, v, out, lse, dout, pl, vl, True,
                                      scale)
    TA._launch_dq(args, dev)
    rec["dq_ms"] = graph_ms(lambda: TA._launch_dq(args, dev))
    rec["dkv_ms"] = graph_ms(lambda: TA._launch_dkv(args, dev))
    rec["bwd_ms"] = graph_ms(lambda: TA._launch_backward(
        q, k, v, out, lse, dout, pl, vl, True, scale))
    rec["plain_bwd_ms"] = cuda_time_ms(
        lambda: TA.flash_backward_reference(q, k, v, out, lse, dout, pl, vl,
                                            True, scale), iters=3, warmup=1)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = TA.attention_mask(pl, vl, L, L)[:, None]

    def library_forward():
        with torch.no_grad():
            sdpa(q, k, v, attn_mask=mask)

    def library():
        a, b, c = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa(a, b, c, attn_mask=mask).backward(dout)

    sdpa_fwd_ms = graph_ms(library_forward)
    rec["sdpa_bwd_ms"] = max(graph_ms(library) - sdpa_fwd_ms, 0.0)
    rec["sdpa_fwd_kernels"] = device_kernels(library_forward)
    rec["sdpa_bwd_kernels"] = device_kernels(library)
    b_dq, b_dkv = chip_smoke.attention_bwd_bounds(q, k, v, vl, pl)
    rec.update({"dq_bound_ms": b_dq["bound_ms"],
                "dq_bound_by": b_dq["bound_by"],
                "dkv_bound_ms": b_dkv["bound_ms"],
                "dkv_bound_by": b_dkv["bound_by"]})
    del keep
    return rec


def main():
    import chip_smoke

    dev = torch.device("cuda", 0)
    exact_f32()
    card = card_identity().splitlines()[0]
    print(f"card {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(19)
    for shape in chip_smoke.F32_ATTENTION_SHAPES:
        rec = time_shape(dev, gen, shape)
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
