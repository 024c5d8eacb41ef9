"""Port parity: the whole serving forward (stair_tpu_torch VideoNMN).

The JAX ``testing.workload.make_batch`` at a small config (H = 64, video
24, text 20, F = 16, B = 12) with ragged masks, JAX weights carried over
by ``params_from_numpy``: float32 logits, question feature, root and the
three register files at rtol/atol 1e-4; bf16 answers agree on >= 0.9 of
questions (the contract tests/test_mega_exec.py holds the TPU kernels
to). Also the weight bridge round trip, the config round trip, and the
port's JAX-free workload twin. On the card, the kernel route against the
plain route.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.models.nmn import NMNConfig
from stair_tpu_torch.testing import workload as TW
from stair_tpu_torch.weights import params_from_numpy, params_to_numpy
from torch_port_util import (  # noqa: F401
    assert_close, cuda_device, port_model, to_numpy_tree, torch_batch,
)

try:
    import jax

    from stair_tpu.testing import workload as JW
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")

B = 12


def _jax_setup(compute_dtype="float32", seed=1):
    cfg = JW.workload_config(hidden_size=64, video_size=24, text_size=20,
                             max_video_length=16)
    cfg = type(cfg)(**{**cfg.to_dict(), "compute_dtype": compute_dtype})
    model, params = JW.build_model(cfg)
    batch = JW.make_batch(cfg, batch_size=B, seed=seed)
    rng = np.random.RandomState(seed)
    L = batch["question"].shape[1]
    batch["video_mask"] = (np.arange(16)[None]
                           < rng.randint(3, 17, (B, 1))).astype(np.float32)
    batch["question_mask"] = (np.arange(L)[None]
                              < rng.randint(4, L + 1, (B, 1))
                              ).astype(np.float32)
    return cfg, model, params, batch


@needs_jax
def test_forward_f32_parity():
    cfg, model, params, batch = _jax_setup()
    ref = model.forward(params, batch, deterministic=True)
    out = port_model(cfg, params)(torch_batch(batch))
    assert_close(ref, out, ("logits", "question_feature", "root",
                            "token_features", "regs_vec", "regs_frames",
                            "regs_attn"), rtol=1e-4, atol=1e-4)
    for k, v in ref.items():
        assert tuple(np.shape(v)) == tuple(out[k].shape), k


@needs_jax
def test_forward_bf16_argmax_agreement():
    cfg, model, params, batch = _jax_setup("bfloat16", seed=2)
    ref = model.forward(params, batch, deterministic=True)
    out = port_model(cfg, params)(torch_batch(batch))
    agree = (np.asarray(ref["logits"]).argmax(-1)
             == out["logits"].numpy().argmax(-1)).mean()
    assert agree >= 0.9
    assert out["regs_frames"].dtype == torch.float32


@needs_jax
def test_weight_bridge_round_trip_is_bit_identical():
    cfg, model, params, _ = _jax_setup()
    tree = to_numpy_tree(params)
    back = params_to_numpy(params_from_numpy(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])
        assert leaf.dtype == flat_b[path].dtype
    # and through the model's own parameter store
    again = params_to_numpy(port_model(cfg, params))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, dict(
            jax.tree_util.tree_leaves_with_path(again))[path])


@needs_jax
def test_config_round_trips_to_dict():
    cfg = JW.workload_config(hidden_size=64, video_size=24,
                             max_video_length=16)
    port = NMNConfig(**cfg.to_dict())
    assert port.to_dict() == cfg.to_dict()
    assert port.conv_temporal == cfg.conv_temporal
    assert type(cfg)(**port.to_dict()) == cfg
    assert TW.workload_config(hidden_size=64, video_size=24,
                              max_video_length=16).to_dict() == cfg.to_dict()


@needs_jax
def test_port_workload_twin_matches_jax():
    cfg = JW.workload_config(hidden_size=64, video_size=24,
                             max_video_length=16)
    j = JW.make_batch(cfg, batch_size=B, seed=3)
    t = TW.make_batch(NMNConfig(**cfg.to_dict()), batch_size=B, seed=3)
    assert j["trace"].keys() == t["trace"].keys()
    for k in j["trace"]:
        np.testing.assert_array_equal(j["trace"][k], t["trace"][k])
    for k in ("question", "video", "root_reg", "root_is_vec", "answer"):
        np.testing.assert_array_equal(j[k], t[k])
    assert TW.PROGRAM_TEMPLATES == JW.PROGRAM_TEMPLATES
    assert TW.program_pool(32) == JW.program_pool(32)


def test_native_parse_lower_matches_python_link_lower():
    """The serving path's C++ parse/lower with span linking gives the
    traces of the Python parse + link + lower, padded alike."""
    from stair_tpu_torch.ir.lowering import pad_traces

    pool = TW.program_pool(24)
    traces = [TW.link_lower(p, q) for p, q in pool]
    cfg = TW.workload_config(hidden_size=16, video_size=8,
                             max_video_length=8, traces=traces)
    got = TW.parse_lower_batch(cfg, [p for p, _ in pool],
                               [q for _, q in pool])
    want = pad_traces(traces, cfg.max_steps, cfg.num_vec, cfg.num_frames,
                      cfg.num_attn)
    assert got.fields.keys() == want.fields.keys()
    for k in want.fields:
        np.testing.assert_array_equal(got.fields[k], want.fields[k], k)
    np.testing.assert_array_equal(got.root_reg, want.root_reg)
    np.testing.assert_array_equal(got.root_is_vec, want.root_is_vec)


def test_init_draws_from_generator_and_is_reproducible():
    cfg = NMNConfig(hidden_size=16, video_size=8, text_size=6,
                    max_video_length=8, max_steps=4, num_vec=3,
                    num_frames=2, num_attn=2)
    a = params_to_numpy(TW.build_model(cfg, seed=5))
    b = params_to_numpy(TW.build_model(cfg, seed=5))
    c = params_to_numpy(TW.build_model(cfg, seed=6))
    assert np.array_equal(a["decoder"]["l1"]["w"], b["decoder"]["l1"]["w"])
    assert not np.array_equal(a["decoder"]["l1"]["w"],
                              c["decoder"]["l1"]["w"])


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_kernel_route_vs_plain_route_on_card(cuda_device,
                                                     compute_dtype):
    """The same forward on CUDA tensors (both kernels) and on CPU tensors
    (both plain versions): float32 at 1e-4, bf16 argmax >= 0.9."""
    cfg = TW.workload_config(hidden_size=64, video_size=24, text_size=20,
                             max_video_length=48)
    cfg = NMNConfig(**{**cfg.to_dict(), "compute_dtype": compute_dtype})
    batch = TW.make_batch(cfg, batch_size=B, seed=4)
    model = TW.build_model(cfg, seed=2)
    ref = model(TW.to_device(batch))
    out = model.to(cuda_device)(TW.to_device(batch, cuda_device))
    torch.cuda.synchronize()
    if compute_dtype == "float32":
        assert_close({k: v.numpy() for k, v in ref.items()}, out,
                     ("logits", "regs_vec", "regs_frames", "regs_attn"),
                     rtol=1e-4, atol=1e-4)
    else:
        agree = (ref["logits"].argmax(-1)
                 == out["logits"].cpu().argmax(-1)).float().mean().item()
        assert agree >= 0.9
