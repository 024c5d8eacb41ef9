"""Port parity: the in-place register-slot updates
(stair_tpu_torch/ops/regslots.py, TPU kernels #11-#13).

``slot_set`` / ``slot_zero`` / ``slot_add`` on CPU tensors (the plain
versions) against the JAX package's Pallas kernels under the interpreter
(``_pallas_set`` / ``_pallas_zero`` / ``_pallas_add`` with ``_INTERPRET``)
and against its XLA scatters (``_xla_*``), on the executor's three file
shapes, float32 and bf16: equal bit for bit (a set and a zero move bits;
the add is one rounding in the file's dtype on both sides). The port
updates the file it is given in place and returns it. ``slot_add_many``
(the reversible executor's seven adds of a step in one call) against the
JAX package's add called on each entry in turn, with entries that repeat a
slot of one file. On the card, each kernel against its plain version.
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


#: the seven adds of one step of the reversible executor, by file (three
#: vec reads, two frames reads, two attn reads)
STEP_ADDS = ("rv", "rv", "rv", "rf", "rf", "ra", "ra")


def _step_adds(shapes, seed):
    """Files, and the seven ``(file name, idx, val)`` entries of one step,
    where vb == va on half the examples, vc == va on a quarter, fb == fa
    and ab == aa on half: an instruction that reads one register twice
    adds twice to its slot."""
    rng = np.random.RandomState(seed)
    files = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    entries = []
    for n in STEP_ADDS:
        shape = shapes[n]
        idx = rng.randint(0, shape[1], (shape[0],)).astype(np.int32)
        idx[0] = shape[1] - 1                      # the scratch slot
        entries.append([n, idx, rng.randn(shape[0], *shape[2:]).astype(
            np.float32)])
    B = shapes["rv"][0]
    for first, later, share in ((0, 1, 2), (0, 2, 4), (3, 4, 2), (5, 6, 2)):
        entries[later][1][:B // share] = entries[first][1][:B // share]
    return files, entries


@needs_jax
@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_add_many_matches_jax_slot_add_in_turn(interpret, dtype):
    shapes = dict(FILES)
    files, entries = _step_adds(shapes, 5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tfiles = {n: torch.tensor(f, dtype=tdt) for n, f in files.items()}
    got = TR.slot_add_many(
        (tfiles[n], torch.tensor(i), torch.tensor(v, dtype=tdt))
        for n, i, v in entries)
    assert [id(g) for g in got] == [id(tfiles[n]) for n in STEP_ADDS]
    for add in (JR._pallas_add, JR._xla_add):
        jfiles = {n: jnp.asarray(f, jdt) for n, f in files.items()}
        for n, i, v in entries:
            jfiles[n] = add(jfiles[n], jnp.asarray(i), jnp.asarray(v, jdt))
        for n in shapes:
            _equal(jfiles[n], tfiles[n])
    # the repeated slots took both adds: one add each differs
    once = {n: torch.tensor(f, dtype=tdt) for n, f in files.items()}
    for n, i, v in entries[::2]:
        TR.slot_add(once[n], torch.tensor(i), torch.tensor(v, dtype=tdt))
    assert not torch.equal(once["rv"], tfiles["rv"])


def test_slot_add_many_plain_version_is_slot_add_in_turn():
    """On CPU tensors ``slot_add_many`` is ``slot_add`` on each entry in the
    order given (bf16: two roundings where a slot repeats), and an empty
    list changes nothing."""
    shapes = dict(FILES)
    files, entries = _step_adds(shapes, 6)
    many = {n: torch.tensor(f, dtype=torch.bfloat16)
            for n, f in files.items()}
    seq = {n: t.clone() for n, t in many.items()}
    TR.slot_add_many((many[n], torch.tensor(i),
                      torch.tensor(v, dtype=torch.bfloat16))
                     for n, i, v in entries)
    for n, i, v in entries:
        TR.slot_add(seq[n], torch.tensor(i),
                    torch.tensor(v, dtype=torch.bfloat16))
    for n in shapes:
        assert torch.equal(many[n], seq[n]), n
    assert TR.slot_add_many([]) == ()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shapes", [
    {"rv": (128, 25, 512), "rf": (128, 9, 64, 512), "ra": (128, 11, 64)},
    {"rv": (5, 3, 7), "rf": (5, 4, 3, 5), "ra": (5, 6, 3)}],
    ids=["train", "scalar"])
def test_slot_add_many_kernel_vs_plain_on_card(cuda_device, shapes, dtype):
    """One launch of the kernel on the step's seven-entry list (repeated
    slots included) against the plain version, bit for bit, at the
    training shapes and on slots that are no multiple of 16 bytes; every
    slot no entry names keeps its value."""
    from stair_tpu_torch.ops import _build

    tdt = getattr(torch, dtype)
    files, entries = _step_adds(shapes, 7)
    before = {n: torch.from_numpy(f).to(cuda_device, tdt)
              for n, f in files.items()}
    ents = [(n, torch.from_numpy(i).to(cuda_device),
             torch.from_numpy(v).to(cuda_device, tdt)) for n, i, v in entries]
    got = {n: t.clone() for n, t in before.items()}
    want = {n: t.clone() for n, t in before.items()}
    _build.reset_launches()
    TR.slot_add_many((got[n], i, v) for n, i, v in ents)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["slot_add_many"] == 1
    assert sum(_build.LAUNCHES.values()) == 1
    TR.slot_add_many_reference([(want[n], i, v) for n, i, v in ents])
    for n, f in before.items():
        assert torch.equal(got[n], want[n]), n
        keep = torch.ones(f.shape[:2], dtype=torch.bool, device=cuda_device)
        for m, i, _ in ents:
            if m == n:
                keep[torch.arange(f.shape[0], device=cuda_device),
                     i.long()] = False
        assert torch.equal(got[n][keep], f[keep]), n


@pytest.mark.cuda
def test_slot_add_many_refuses_what_the_kernel_does_not_take_on_card(
        cuda_device):
    """On CUDA tensors ``slot_add_many`` launches its kernel or raises:
    more than ``MAX_ADDS`` entries, files of two dtypes or two batches."""
    from stair_tpu_torch.ops import _build

    def entry(dtype, B=4):
        f = torch.zeros(B, 3, 8, dtype=dtype, device=cuda_device)
        return (f, torch.zeros(B, dtype=torch.int32, device=cuda_device),
                torch.ones(B, 8, dtype=dtype, device=cuda_device))

    _build.reset_launches()
    for bad in ([entry(torch.float32)] * (TR.MAX_ADDS + 1),
                [entry(torch.float32), entry(torch.bfloat16)],
                [entry(torch.float32), entry(torch.float32, B=5)]):
        with pytest.raises(ValueError):
            TR.slot_add_many(bad)
    assert _build.LAUNCHES["slot_add_many"] == 0
    got = TR.slot_add_many([entry(torch.float32)] * TR.MAX_ADDS)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["slot_add_many"] == 1
    assert float(got[0][:, 0].min()) == TR.MAX_ADDS
