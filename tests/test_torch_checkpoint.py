"""The port's msgpack codec and parameter checkpoints
(stair_tpu_torch/train/checkpoint.py) against ``flax.serialization``.

Bytes written by the port are read by ``msgpack_restore`` and bytes written
by ``flax.serialization.to_bytes`` are read by the port, leaf for leaf and
bit for bit, for float32 / bfloat16 / int32 / int64 / bool leaves, numpy
and python scalars, trees with lists, and arrays above the chunking limit;
``save_params`` / ``load_params`` round-trip a module, report missing and
extra leaves, and refuse a shape that does not match.
"""

import os

import numpy as np
import pytest
import torch

from stair_tpu_torch.llm.decoder import Decoder, DecoderConfig
from stair_tpu_torch.train import checkpoint as C
from stair_tpu_torch.weights import params_to_numpy
from torch_port_util import assert_trees_equal

try:
    import jax
    import jax.numpy as jnp
    from flax import serialization
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "embed": rng.randn(7, 5).astype(np.float32),
        "layers": [
            {"q": {"w": rng.randn(300, 70).astype(np.float32),
                   "b": np.zeros((70,), np.float32)}},
            {"q": {"w": rng.randn(2, 3).astype(np.float32),
                   "b": np.arange(3, dtype=np.float32)}},
        ],
        "ids": np.arange(-3, 40000, 977, dtype=np.int32),
        "big": np.arange(2 ** 33, 2 ** 33 + 4, dtype=np.int64),
        "flags": np.array([True, False]),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.float32(2.5),
        "count": 17, "neg": -70000, "rate": 0.25, "none": None,
        "name": "x" * 40,
    }


def _as_restored(tree):
    """What ``msgpack_restore`` gives for ``tree``: lists as dicts keyed by
    their decimal index."""
    if isinstance(tree, dict):
        return {k: _as_restored(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _as_restored(v) for i, v in enumerate(tree)}
    return tree


def _assert_same(want, got, prefix=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), prefix
        for k in want:
            _assert_same(want[k], got[k], f"{prefix}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(want).dtype == np.asarray(got).dtype, prefix
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got),
                                      prefix)
    else:
        assert want == got and type(want) is type(got), prefix


@needs_jax
def test_flax_reads_what_the_port_writes():
    tree = _tree()
    restored = serialization.msgpack_restore(C.to_bytes(tree))
    _assert_same(_as_restored(tree), restored)


@needs_jax
def test_port_reads_what_flax_writes():
    tree = _tree(seed=1)
    data = serialization.to_bytes(tree)
    _assert_same(_as_restored(tree), C.from_bytes(data))
    # and the two writers agree byte for byte on the same tree
    assert C.to_bytes(tree) == data


@needs_jax
def test_bfloat16_both_ways():
    x = jnp.asarray(np.random.RandomState(2).randn(5, 6), jnp.bfloat16)
    bits = np.asarray(x).view(np.uint16)
    got = C.from_bytes(serialization.to_bytes({"w": x}))["w"]
    assert isinstance(got, C.Bfloat16Array)
    np.testing.assert_array_equal(got.bits, bits)
    np.testing.assert_array_equal(got.to_float32(),
                                  np.asarray(x.astype(jnp.float32)))
    back = serialization.msgpack_restore(
        C.to_bytes({"w": C.Bfloat16Array(bits)}))["w"]
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back).view(np.uint16), bits)
    t = C._tensor_from_leaf(got)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(C._leaf_from_tensor(t).bits, bits)


@needs_jax
def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays above the chunk limit travel as flat chunks (the limit is
    lowered here on both sides so that a small array crosses it)."""
    monkeypatch.setattr(C, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    tree = {"w": np.random.RandomState(3).randn(33, 9).astype(np.float32),
            "small": np.arange(4, dtype=np.int32)}
    data = C.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same(tree, serialization.msgpack_restore(data))
    _assert_same(tree, C.from_bytes(serialization.to_bytes(tree)))


@pytest.mark.parametrize("data", [b"", b"\x81\xa1a", b"\xc1", b"\x01\x02"],
                         ids=["empty", "truncated", "reserved", "trailing"])
def test_decoder_refuses_bad_bytes(data):
    with pytest.raises(ValueError):
        C.from_bytes(data)


def _decoder(seed, **kw):
    cfg = DecoderConfig.llama(vocab_size=30, d_model=16, num_heads=2,
                              num_layers=2, d_ff=32, max_len=16, **kw)
    return Decoder(cfg, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_save_and_load_round_trip(tmp_path, dtype):
    a, b = _decoder(0).to(dtype), _decoder(1).to(dtype)
    C.save_params(str(tmp_path), a.param_tree())
    assert os.path.exists(tmp_path / "params.msgpack")
    missing, extra = C.load_params(str(tmp_path), b)
    assert missing == [] and extra == []
    for (ka, pa), (kb, pb) in zip(a.weights.items(), b.weights.items()):
        assert ka == kb and pb.dtype == dtype and torch.equal(pa, pb)


def test_load_is_tolerant_and_reports(tmp_path, capsys):
    a = _decoder(0)
    tree = a.param_tree()
    kept = tree["layers"][1].pop("q")             # a leaf the file lacks
    tree["unused"] = {"w": torch.zeros(2)}        # a leaf the model lacks
    C.save_params(str(tmp_path), tree)
    b = _decoder(1)
    before = b.weights["layers/1/q/w"].detach().clone()
    missing, extra = C.load_params(str(tmp_path), b)
    assert missing == ["layers/1/q/w"] and extra == ["unused/w"]
    out = capsys.readouterr().out
    assert "missing 1 leaves" in out and "1 unused leaves" in out
    assert torch.equal(b.weights["layers/1/q/w"], before)
    assert not torch.equal(before, kept["w"])
    assert torch.equal(b.weights["embed"], a.weights["embed"])


def test_load_refuses_a_wrong_shape_and_casts_dtype(tmp_path):
    a = _decoder(0)
    C.save_params(str(tmp_path), a.param_tree())
    b = _decoder(1).to(torch.bfloat16)
    C.load_params(str(tmp_path), b)
    assert torch.equal(b.weights["embed"],
                       a.weights["embed"].to(torch.bfloat16))
    tree = a.param_tree()
    tree["embed"] = torch.zeros(3, 3)
    C.save_params(str(tmp_path), tree)
    with pytest.raises(ValueError, match="embed"):
        C.load_params(str(tmp_path), _decoder(1))


@needs_jax
def test_jax_loads_a_port_checkpoint_and_the_port_a_jax_one(tmp_path):
    from stair_tpu.llm import decoder as JD
    from stair_tpu.train import checkpoint as JC

    port = _decoder(0)
    C.save_params(str(tmp_path / "p"), port.param_tree())
    jmodel = JD.Decoder(JD.DecoderConfig(**port.config.to_dict()))
    template = jmodel.init(jax.random.PRNGKey(5))
    loaded = JC.load_params(str(tmp_path / "p"), template)
    assert_trees_equal(params_to_numpy(port),
                       jax.tree_util.tree_map(np.asarray, loaded))
    JC.save_checkpoint(str(tmp_path / "j"), template, {})
    other = _decoder(1)
    assert C.load_params(str(tmp_path / "j"), other) == ([], [])
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, template),
                       params_to_numpy(other))
