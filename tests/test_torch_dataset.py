"""Port parity: the batcher (``stair_tpu_torch/data/dataset.py``, a copy)
and the device tables (``stair_tpu_torch/train/loop.py``).

On one tiny AGQA world (the JAX package's ``make_world`` and
``preprocess.convert_split``: the ``.pkl`` files a user of the JAX
preprocess has) and on the STAR world of ``tests/test_datasets.py``, both
packages' datasets read the same files and their ``Batcher``s pack every
batch of a shuffled epoch, with device tables on and off: every array
equal (values and dtypes), ``meta`` and ``qa_ids`` equal. The port's
``materialize_batch`` on its device tables equals the JAX function's bit
for bit in float32, and both equal the host-packed batch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stair_tpu_torch.data import dataset as TDS
from stair_tpu_torch.testing.agqa_world import write_agqa_world
from stair_tpu_torch.train import loop as TLP
from torch_port_util import write_star_world

jax = pytest.importorskip("jax")

from stair_tpu.data import dataset as JDS  # noqa: E402
from stair_tpu.programs import preprocess as JPP  # noqa: E402
from stair_tpu.programs import scene_graph as JSG  # noqa: E402
from stair_tpu.testing import synthetic as JSY  # noqa: E402
from stair_tpu.train import loop as JLP  # noqa: E402

F = 24


@pytest.fixture(scope="module")
def agqa(tmp_path_factory):
    w = write_agqa_world(tmp_path_factory.mktemp("agqa"), JSY, JPP, JSG,
                         num_videos=6, questions_per_video=6, num_frames=F,
                         seed=5)
    kw = dict(rgb_path=w["features"], glove_filename=w["glove"],
              vocab_filename=w["vocab"], video_secs_path=w["video_secs"],
              train_filename=w["train"], valid_filename=w["valid"],
              test_filename=w["test"], word2id_filename=w["word2id"])
    return kw


@pytest.fixture(scope="module")
def star(tmp_path_factory):
    return write_star_world(tmp_path_factory.mktemp("star"))


def _datasets(kind, paths, split="train"):
    if kind == "AGQA":
        return (JDS.AGQADataset(JDS.DataPaths(**paths), split,
                                max_video_length=F),
                TDS.AGQADataset(TDS.DataPaths(**paths), split,
                                max_video_length=F))
    return (JDS.STARDataset(JDS.DataPaths(**paths), split, max_video_length=F),
            TDS.STARDataset(TDS.DataPaths(**paths), split, max_video_length=F))


def _batchers(jds, tds, device_tables, batch_size=8):
    T, NV, NF, NA = jds.trace_geometry()
    assert (T, NV, NF, NA) == tds.trace_geometry()
    kw = dict(batch_size=batch_size, max_steps=T, num_vec=NV, num_frames=NF,
              num_attn=NA, seed=3, device_tables=device_tables)
    return JDS.Batcher(jds, **kw), TDS.Batcher(tds, **kw)


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, path)
    else:
        assert a == b, path


@pytest.mark.parametrize("device_tables", [False, True],
                         ids=["host-packed", "device-tables"])
@pytest.mark.parametrize("kind", ["AGQA", "STAR"])
def test_batches_equal_the_jax_batcher(kind, device_tables, agqa, star):
    jds, tds = _datasets(kind, agqa if kind == "AGQA" else star)
    assert len(jds) == len(tds) and jds.records == tds.records
    assert jds.answer_vocab == tds.answer_vocab
    jb, tb = _batchers(jds, tds, device_tables)
    assert jb.indices == tb.indices
    n = 0
    for epoch in range(2):
        for a, b in zip(jb.epoch(shuffle=True), tb.epoch(shuffle=True),
                        strict=True):
            for field in dataclasses.fields(a):
                _assert_same(getattr(a, field.name), getattr(b, field.name),
                             field.name)
            n += 1
    assert n >= 4
    if device_tables:
        assert b.video_idx is not None and b.question is None
        jt = JLP.make_device_tables(jds)
        tt = TLP.make_device_tables(tds, "cpu")
        for k in jt:
            np.testing.assert_array_equal(np.asarray(jt[k]), tt[k].numpy(), k)


@pytest.mark.parametrize("kind", ["AGQA", "STAR"])
def test_materialize_batch_is_bit_equal_to_jax(kind, agqa, star):
    jds, tds = _datasets(kind, agqa if kind == "AGQA" else star)
    jt, tt = JLP.make_device_tables(jds), TLP.make_device_tables(tds, "cpu")
    _, host = _batchers(jds, tds, False)
    jb, tb = _batchers(jds, tds, True)
    keys = ["video", "video_mask", "question", "question_mask", "sup_attn",
            "class_emb", "class_emb_mask"]
    if kind == "STAR":
        keys += ["cand_emb", "cand_mask"]
    seen_gold = False
    for hb, a, b in zip(host.epoch(shuffle=False), jb.epoch(shuffle=False),
                        tb.epoch(shuffle=False), strict=True):
        want = jax.jit(lambda d: JLP.materialize_batch(d, jt))(
            JLP.batch_to_device_dict(a))
        got = TLP.materialize_batch(
            jax.tree_util.tree_map(torch.from_numpy,
                                   TLP.batch_to_device_dict(b)), tt)
        host_dict = TLP.batch_to_device_dict(hb)
        for k in keys:
            w = np.asarray(want[k])
            g = got[k].numpy()
            assert g.dtype == w.dtype == np.float32, k
            np.testing.assert_array_equal(g, w, k)
            np.testing.assert_array_equal(g, host_dict[k], k)
        seen_gold |= bool(np.any(hb.sup_attn_rows > 0))
    assert seen_gold or kind == "STAR"


def test_device_batches_carry_every_array_to_the_device(agqa):
    _, tds = _datasets("AGQA", agqa)
    _, tb = _batchers(tds, tds, True)
    for batch, d in TLP._device_batches(tb, torch.device("cpu"),
                                        shuffle=False):
        want = TLP.batch_to_device_dict(batch)
        assert d.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(d[k][kk].numpy(), vv)
            else:
                assert torch.is_tensor(d[k]), k
                np.testing.assert_array_equal(d[k].numpy(), v, k)
