"""Shared helpers for the PyTorch-port tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both frameworks;
JAX stays on the CPU (tests/conftest.py). ``cuda_device`` skips a test
when no NVIDIA GPU is present — decided inside the fixture, never while a
module is imported.
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from stair_tpu_torch.utils.device import exact_f32

    exact_f32()
    return torch.device("cuda")


def to_numpy_tree(tree):
    """JAX pytree of arrays (dicts, lists) -> the same tree of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def tree_shapes(tree):
    """The same tree with every leaf replaced by its shape."""
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_shapes(v) for v in tree]
    return tuple(tree.shape)


def assert_trees_equal(want, got, prefix=""):
    """Two params trees (dicts, lists, arrays) have the same keys and equal
    leaves, bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), prefix
        for k in want:
            assert_trees_equal(want[k], got[k], f"{prefix}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(want) == len(got), prefix
        for i, (a, b) in enumerate(zip(want, got)):
            assert_trees_equal(a, b, f"{prefix}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(want), got, prefix)
        assert np.asarray(want).dtype == got.dtype, prefix


def port_model(jax_cfg, jax_params, device=None, executor="mega"):
    """The port's VideoNMN with the JAX model's config and weights."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
    from stair_tpu_torch.weights import params_from_numpy

    cfg = NMNConfig(**jax_cfg.to_dict())
    return VideoNMN(cfg, params_from_numpy(to_numpy_tree(jax_params)),
                    device=device, executor=executor)


def torch_batch(batch, device=None):
    from stair_tpu_torch.testing.workload import to_device

    return to_device(batch, device)


def assert_close(ref, out, keys, rtol, atol):
    for key in keys:
        np.testing.assert_allclose(
            np.asarray(ref[key], np.float32),
            out[key].detach().float().cpu().numpy(),
            rtol=rtol, atol=atol, err_msg=key,
        )


def assert_grad_trees_close(want, got, rel=1e-4, prefix=""):
    """Every gradient leaf within ``rel`` of the wanted leaf's scale
    (``max|a - b| <= rel * max|b|``, plus 1e-6 for leaves that are 0 but
    for rounding, such as the gradient of a key bias)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), prefix
        for k in want:
            assert_grad_trees_close(want[k], got[k], rel, f"{prefix}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), prefix
        for i, (a, b) in enumerate(zip(want, got)):
            assert_grad_trees_close(a, b, rel, f"{prefix}/{i}")
    else:
        want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
        assert want.shape == got.shape, prefix
        err = float(np.abs(want - got).max()) if want.size else 0.0
        assert err <= rel * float(np.abs(want).max()) + 1e-6, (prefix, err)


def write_star_world(root):
    """The STAR world of ``tests/test_datasets.py star_world``: 9
    multiple-choice records over 3 videos (48 rows of 32 features), clips
    0.5-6.0 s of 8 s, a 16-wide GloVe file. Returns the ``DataPaths``
    fields as a dict, for either package's ``DataPaths``."""
    import json
    import os
    import pickle

    root = str(root)
    vids = ["S0", "S1", "S2"]
    feats = os.path.join(root, "feats")
    os.makedirs(feats, exist_ok=True)
    rng = np.random.RandomState(0)
    for vid in vids:
        np.save(os.path.join(feats, vid + ".npy"),
                rng.randn(48, 32).astype(np.float32))
    program = ["Exists", "dish", "Filter", "video", "objects"]
    records = []
    for i in range(9):
        records.append({
            "qa_id": "Interaction_T1_%d" % i,
            "question_id": "Interaction_T1_%d" % i,
            "question": "what did they do ?",
            "nmn_program": list(program),
            "nmn_program_idx": [None] * len(program),
            "nmn_program_span_by_word": {},
            "sg_res_by_step": {},
            "video_id": vids[i % 3],
            "choices": [{"choice_id": j, "choice": "answer %d" % j}
                        for j in range(4)],
            "answer": "answer %d" % (i % 4),
            "start": 0.5, "end": 6.0,
        })
    pkl = os.path.join(root, "star.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(records, f)
    with open(os.path.join(root, "secs.json"), "w") as f:
        json.dump({v: 8.0 for v in vids}, f)
    glove = os.path.join(root, "glove.txt")
    rng = np.random.RandomState(1)
    words = ["what", "did", "they", "do", "?", "answer", "0", "1", "2", "3"]
    with open(glove, "w") as f:
        f.write("%d 16\n" % len(words))
        for w in words:
            f.write(w + " " + " ".join(
                "%.4f" % x for x in rng.randn(16)) + "\n")
    return dict(rgb_path=feats, glove_filename=glove,
                vocab_filename=os.path.join(root, "vocab.json"),
                video_secs_path=os.path.join(root, "secs.json"),
                train_filename=pkl, valid_filename=pkl, test_filename=pkl)


def executor_case(dev, H, F, attention, B, seed=8, dtype=torch.float32):
    """Executor inputs in ``dtype`` on ``dev`` at width ``H``, ``F`` frames
    and ``B`` examples (the all-opcode programs, repeated as often as ``B``
    needs and cut to ``B``), with a seeded model and seeded BiLSTM-sized
    direction stacks: ``(meta, args)`` as ``prepare_args`` gives them."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.testing import workload as TW

    cfg = NMNConfig(
        hidden_size=H, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8, filter_attention=attention,
        compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    model = TW.build_model(cfg, seed=1, device=dev)
    n = len(TW.OPCODE_PROGRAMS)
    programs = (TW.OPCODE_PROGRAMS * -(-B // n))[:B]
    batch = TW.to_device(TW.opcode_batch(cfg, programs, seed=seed), dev)
    gen = torch.Generator().manual_seed(F + H)
    L = batch["question"].shape[1]
    halves = [torch.randn(B, m, H // 2, generator=gen).to(dev, dtype)
              for m in (F, F, L, L)]
    mods = tree_map(lambda x: x.detach().to(dtype),
                    model.param_tree()["modules"])
    return TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], halves[:2],
        batch["video_mask"], halves[2:], batch["question_mask"])


def fma32_case(dev, H, F, attention, B, seed=8):
    """Float32 executor inputs (``executor_case``), the "fma32" route's."""
    return executor_case(dev, H, F, attention, B, seed)


def tc_case(dev, H, F, attention, B, seed=8):
    """bf16 executor inputs (``executor_case``), the tensor-core route's."""
    return executor_case(dev, H, F, attention, B, seed, torch.bfloat16)
