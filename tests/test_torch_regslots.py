"""Port parity: the in-place register-slot updates
(stair_tpu_torch/ops/regslots.py, TPU kernels #11-#13).

``slot_set`` / ``slot_zero`` / ``slot_add`` on CPU tensors (the plain
versions) against the JAX package's Pallas kernels under the interpreter
(``_pallas_set`` / ``_pallas_zero`` / ``_pallas_add`` with ``_INTERPRET``)
and against its XLA scatters (``_xla_*``), on the executor's three file
shapes, float32 and bf16: equal bit for bit (a set and a zero move bits;
the add is one rounding in the file's dtype on both sides). The port
updates the file it is given in place and returns it. On the card, each
kernel against its plain version.
"""

import numpy as np
import pytest
import torch

from stair_tpu_torch.ops import regslots as TR
from torch_port_util import cuda_device  # noqa: F401

try:
    import jax.numpy as jnp

    from stair_tpu.ops import regslots as JR
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jnp = None
needs_jax = pytest.mark.skipif(jnp is None, reason="JAX not installed")

FILES = [
    ("rv", (8, 5, 128)),
    ("rf", (8, 4, 16, 128)),
    ("ra", (8, 6, 16)),
]
DTYPES = ["float32", "bfloat16"]


def _data(shape, seed):
    rng = np.random.RandomState(seed)
    file = rng.randn(*shape).astype(np.float32)
    val = rng.randn(shape[0], *shape[2:]).astype(np.float32)
    idx = rng.randint(0, shape[1], (shape[0],)).astype(np.int32)
    idx[0] = shape[1] - 1                          # the scratch slot
    return file, val, idx


def _both(file, val, idx, dtype):
    """The same data for both frameworks. The torch side gets copies: the
    port updates its file in place, and on the CPU a JAX array may share
    the numpy array's memory."""
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    return ((jnp.asarray(file, jdt), jnp.asarray(val, jdt), jnp.asarray(idx)),
            (torch.tensor(file, dtype=tdt), torch.tensor(val, dtype=tdt),
             torch.tensor(idx)))


def _equal(j, t):
    np.testing.assert_array_equal(np.asarray(j, np.float32),
                                  t.float().numpy())


@pytest.fixture()
def interpret(monkeypatch):
    if jnp is not None:
        monkeypatch.setattr(JR, "_INTERPRET", True)


@needs_jax
@pytest.mark.parametrize("name,shape", FILES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_set_matches_jax(interpret, name, shape, dtype):
    (jf, jv, ji), (tf, tv, ti) = _both(*_data(shape, 0), dtype)
    got = TR.slot_set(tf, ti, tv)
    assert got is tf                               # in place
    _equal(JR._pallas_set(jf, ji, jv), got)
    _equal(JR._xla_set(jf, ji, jv), got)


@needs_jax
@pytest.mark.parametrize("name,shape", FILES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_zero_matches_jax(interpret, name, shape, dtype):
    (jf, _, ji), (tf, _, ti) = _both(*_data(shape, 1), dtype)
    got = TR.slot_zero(tf, ti)
    assert got is tf
    _equal(JR._pallas_zero(jf, ji), got)
    _equal(JR._xla_zero(jf, ji), got)


@needs_jax
@pytest.mark.parametrize("name,shape", FILES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_add_matches_jax(interpret, name, shape, dtype):
    (jf, jv, ji), (tf, tv, ti) = _both(*_data(shape, 2), dtype)
    got = TR.slot_add(tf, ti, tv)
    assert got is tf
    _equal(JR._pallas_add(jf, ji, jv), got)
    _equal(JR._xla_add(jf, ji, jv), got)


@pytest.mark.parametrize("name,shape", FILES)
def test_only_the_indexed_slots_change(name, shape):
    file, val, idx = _data(shape, 3)
    before = torch.from_numpy(file)
    rows = torch.arange(shape[0])
    for fn, args in ((TR.slot_set, (torch.from_numpy(val),)),
                     (TR.slot_zero, ()), (TR.slot_add,
                                          (torch.from_numpy(val),))):
        got = fn(before.clone(), torch.from_numpy(idx), *args)
        keep = torch.ones(shape[:2], dtype=torch.bool)
        keep[rows, torch.from_numpy(idx).long()] = False
        assert torch.equal(got[keep], before[keep]), fn.__name__
        assert not torch.equal(got[~keep], before[~keep]), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(128, 25, 512), (64, 9, 64, 512),
                                   (128, 11, 64), (5, 3, 7), (3, 4, 5, 6)])
def test_slot_kernels_vs_plain_versions_on_card(cuda_device, shape, dtype):
    """Each kernel against its plain version, bit for bit, on the training
    shapes and on slots that are no multiple of 16 bytes (the scalar
    path)."""
    from stair_tpu_torch.ops import _build

    tdt = getattr(torch, dtype)
    file, val, idx = _data(shape, 4)
    file = torch.from_numpy(file).to(cuda_device, tdt)
    val = torch.from_numpy(val).to(cuda_device, tdt)
    idx = torch.from_numpy(idx).to(cuda_device)
    _build.reset_launches()
    for key, kern, plain, args in (
            ("slot_set", TR.slot_set, TR.slot_set_reference, (val,)),
            ("slot_zero", TR.slot_zero, TR.slot_zero_reference, ()),
            ("slot_add", TR.slot_add, TR.slot_add_reference, (val,))):
        got = kern(file.clone(), idx, *args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[key] == 1
        assert torch.equal(got, plain(file.clone(), idx, *args)), key
