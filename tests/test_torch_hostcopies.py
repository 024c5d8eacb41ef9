"""The port's own copies of the host-side modules give what the JAX
package's originals give on the same inputs.

``programs/{parser,text,spans}.py``, ``ir/lowering.py``,
``runtime/loader.py`` (with its own ``_native.so`` / ``_parser.so`` built
from the port's own C++ sources), ``train/args.py`` and the constants of
``data/dataset.py``: every program of the workload pool parsed,
span-linked, lowered and padded by both; the native batch path of both;
the argument parsers option by option; the constants value by value;
``load_video_features`` on a seeded feature directory and
``splice_filter_outputs`` string for string; the parsers'
``seq2seq/{vocab,export}.py``: encodings, decodings, saved JSON and the
exported fairseq files byte for byte; ``serve/logutil.py`` and
``llm/reformat_agqa.py``: their sources byte for byte, the moderation
constants, ``StreamToLogger``'s lines, ``reformat`` and its CLI's JSON on
seeded questions with sharded Filter outputs.
"""

import os

import numpy as np
import pytest

from stair_tpu.data import dataset as JDS
from stair_tpu.ir import lowering as JL
from stair_tpu.programs import parser as JPa
from stair_tpu.programs import spans as JSp
from stair_tpu.programs import text as JTx
from stair_tpu.runtime import loader as JLo
from stair_tpu.train import args as JAr
from stair_tpu_torch.data import dataset as TDS
from stair_tpu_torch.ir import lowering as TL
from stair_tpu_torch.programs import parser as TPa
from stair_tpu_torch.programs import spans as TSp
from stair_tpu_torch.programs import text as TTx
from stair_tpu_torch.runtime import loader as TLo
from stair_tpu_torch.testing import workload as TW
from stair_tpu_torch.train import args as TAr

POOL = TW.program_pool(128)
SENTENCES = [q for _, q in POOL[:12]] + [
    "She wasn't holding the children's dishes, they're washing windows!",
    "The men were running quickly and had eaten the sandwiches.",
]


def _lower_all(P, S, L, aux=False):
    traces = []
    for prog, question in POOL + [(p, "what happened ?")
                                  for p in TW.PROGRAM_TEMPLATES]:
        parsed = P.parse_nmn_program(prog)
        by_word, extra = S.link_program_spans(parsed.tokens, question)
        traces.append((parsed, by_word, extra, L.lower_program(
            parsed.tokens, parsed.source_index, by_word or {},
            aux_text_for_missing_spans=aux)))
    return traces


def test_parse_and_span_link_agree_on_the_pool():
    for (a, aw, ax, _), (b, bw, bx, _) in zip(
            _lower_all(JPa, JSp, JL), _lower_all(TPa, TSp, TL)):
        assert a.tokens == b.tokens
        assert list(a.source_index) == list(b.source_index)
        assert aw == bw and ax == bx


@pytest.mark.parametrize("aux", [False, True], ids=["mean", "aux-text"])
def test_lower_and_pad_agree_on_the_pool(aux):
    ja = [t for *_, t in _lower_all(JPa, JSp, JL, aux)]
    ta = [t for *_, t in _lower_all(TPa, TSp, TL, aux)]
    caps = (max(len(t.instrs) for t in ja), max(t.num_vec for t in ja),
            max(t.num_frames for t in ja), max(t.num_attn for t in ja))
    jb, tb = JL.pad_traces(ja, *caps), TL.pad_traces(ta, *caps)
    assert jb.fields.keys() == tb.fields.keys()
    for k in jb.fields:
        np.testing.assert_array_equal(jb.fields[k], tb.fields[k], k)
    for name in ("step_mask", "supervised", "root_is_vec", "root_reg",
                 "num_steps"):
        np.testing.assert_array_equal(getattr(jb, name), getattr(tb, name),
                                      name)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a.field_matrix(), b.field_matrix())


@pytest.mark.parametrize("with_questions", [True, False],
                         ids=["span-linked", "no-questions"])
def test_native_parse_lower_batch_agrees(with_questions):
    assert TLo.parser_lib() is not None, "the port's _parser.so did not build"
    progs = [p for p, _ in POOL]
    qs = [q for _, q in POOL] if with_questions else None
    a = JLo.native_parse_lower_batch(progs, 16, 10, 6, 8, questions=qs)
    b = TLo.native_parse_lower_batch(progs, 16, 10, 6, 8, questions=qs)
    if a is None:
        pytest.skip("the JAX package's native parser is unavailable")
    for k in a.fields:
        np.testing.assert_array_equal(a.fields[k], b.fields[k], k)
    for name in ("step_mask", "supervised", "root_is_vec", "root_reg",
                 "num_steps"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      name)


def test_port_builds_and_loads_its_own_libraries():
    here = os.path.dirname(os.path.abspath(TLo.__file__))
    for lib in (TLo.native_lib(), TLo.parser_lib()):
        assert lib is not None
        assert os.path.dirname(os.path.abspath(lib._name)) == here
    assert "stair_tpu_torch" in TLo._SRC and "stair_tpu_torch" in TLo._PARSER_SRC
    for name in ("native.cpp", "parser.cpp"):
        assert os.path.exists(os.path.join(here, name))


def test_native_gather_tokenize_and_span_attention_agree():
    rng = np.random.RandomState(0)
    feats = {f"v{i}": rng.randn(3 + i, 5).astype(np.float32)
             for i in range(4)}
    ja, ta = JLo.FeatureArena(feats), TLo.FeatureArena(feats)
    for a, b in zip(ja.gather(["v2", "v0", "v3"], 5),
                    ta.gather(["v2", "v0", "v3"], 5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ja.padded_table(6), ta.padded_table(6)):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    iv = np.array([[0.2, 3.7], [2.5, 2.9], [0.0, 8.0], [5.1, 5.1]], np.float32)
    want = JLo.span_to_attention_batch(iv, 8)
    np.testing.assert_array_equal(TLo.span_to_attention_batch(iv, 8), want)
    for i, row in enumerate(iv):     # the numpy fallback's function too
        np.testing.assert_allclose(TDS.span_to_attention(tuple(row), 8),
                                   JDS.span_to_attention(tuple(row), 8))
        np.testing.assert_allclose(TDS.span_to_attention(tuple(row), 8),
                                   want[i], atol=1e-6)
    assert TLo._pack_strings(["ab", "c"])[0] == JLo._pack_strings(["ab", "c"])[0]
    assert list(TLo.windowed(range(7), 2)) == list(JLo.windowed(range(7), 2))
    assert list(TLo.PrefetchIterator(iter(range(5)))) == list(range(5))


def test_text_primitives_agree():
    assert TTx.HAVE_NLTK == JTx.HAVE_NLTK
    for s in SENTENCES:
        words = TTx.tokenize(s)
        assert words == JTx.tokenize(s)
        assert TTx.pos_tag(words) == JTx.pos_tag(words)
        for w in words:
            for pos in ("n", "v"):
                assert TTx.lemmatize(w, pos) == JTx.lemmatize(w, pos)
    assert TTx.stopword_set() == JTx.stopword_set()


def test_parser_tables_and_helpers_agree():
    assert TPa.NMN_ARITY == JPa.NMN_ARITY
    assert TPa.PARSE_ARITY == JPa.PARSE_ARITY
    assert TPa.KEYWORDS == JPa.KEYWORDS
    assert TPa.ALL_RESERVED == JPa.ALL_RESERVED
    for prog in TW.PROGRAM_TEMPLATES:
        assert TPa.tokenize_annotation(prog) == JPa.tokenize_annotation(prog)
        toks = TPa.parse_nmn_program(prog).tokens
        assert TPa.program_is_valid(toks) == JPa.program_is_valid(toks)
        assert TPa.module_levels(toks) == JPa.module_levels(toks)
        assert TPa.visualize(toks) == JPa.visualize(toks)


def test_opcode_family_and_supervision_constants_agree():
    assert [(o.name, int(o)) for o in TL.Opcode] == [
        (o.name, int(o)) for o in JL.Opcode]
    assert ({int(k): v for k, v in TL.OP_FAMILY.items()}
            == {int(k): v for k, v in JL.OP_FAMILY.items()})
    assert TL._INT_FIELDS == JL._INT_FIELDS
    assert TL.SUPERVISED_FAMILIES == JL.SUPERVISED_FAMILIES
    for name in ("SUP_NONE", "SUP_BOOL", "SUP_EQUALS", "SUP_ATTN1",
                 "SUP_ATTN2", "SUP_CONTRAST", "SUP_FRAME"):
        assert getattr(TDS, name) == getattr(JDS, name), name


def test_build_parser_has_the_same_options_and_defaults():
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.choices if a.choices is None else tuple(a.choices),
                         a.nargs, a.required, type(a).__name__)
                for a in parser._actions}

    assert table(TAr.build_parser()) == table(JAr.build_parser())
    argv = ["--rgb-path", "feats", "--batch-size", "8", "--lr", "0.001"]
    assert vars(TAr.get_args(argv)) == vars(JAr.get_args(argv))


def test_load_video_features_agrees(tmp_path):
    rng = np.random.RandomState(0)
    for i, shape in enumerate([(24, 8), (7, 8), (30, 1, 8)]):
        np.save(tmp_path / f"V{i}.npy", rng.randn(*shape).astype(np.float64))
    np.save(tmp_path / "other.npy", rng.randn(4, 8))
    used = {"V0", "V1", "V2", "missing"}
    want = JDS.load_video_features(str(tmp_path), None, used, 10)
    got = TDS.load_video_features(str(tmp_path), None, used, 10)
    assert want.keys() == got.keys() == {"V0", "V1", "V2"}
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])
        assert got[k].dtype == np.float32 and got[k].shape[0] <= 10
    with pytest.raises(ValueError, match="not found"):
        TDS.load_video_features(str(tmp_path / "nope"), None, used, 10)


FILTER_OUTPUTS = {
    0: (1, "holding", ["cup", "dish", "phone"]),
    1: (3, "before", ["opening the door"]),
    2: (2, "after", ["sitting", "standing"]),
    3: (2, "object", []),
}


@pytest.mark.parametrize("kw", [
    {}, {"max_per_module": 2}, {"max_per_module": 3, "max_total": 2},
    {"by_level": 2}, {"by_level": 1, "max_per_module": 5, "max_total": 1},
    {"by_level": 9, "max_total": 0},
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()) or "defaults")
def test_splice_filter_outputs_agrees(kw):
    from stair_tpu.llm import video_prefix as JP
    from stair_tpu_torch.llm import video_prefix as TP

    q = "Question: what did they hold ? Answer:"
    for outputs in (FILTER_OUTPUTS, None, {}, {0: (1, "holding", [])}):
        assert (TP.splice_filter_outputs(q, outputs, **kw)
                == JP.splice_filter_outputs(q, outputs, **kw))
    assert TP.splice_filter_outputs(q, FILTER_OUTPUTS, **kw) != q


def test_make_world_writes_the_same_files(tmp_path):
    from stair_tpu.testing import synthetic as JSY
    from stair_tpu_torch.testing import synthetic as TSY

    a = JSY.make_world(str(tmp_path / "jax"), num_videos=3,
                       questions_per_video=4, num_frames=16, feature_dim=12,
                       glove_dim=8, seed=11)
    b = TSY.make_world(str(tmp_path / "port"), num_videos=3,
                       questions_per_video=4, num_frames=16, feature_dim=12,
                       glove_dim=8, seed=11)
    files = []
    for root, _, names in os.walk(a["root"]):
        files += [os.path.relpath(os.path.join(root, n), a["root"])
                  for n in names]
    assert len(files) == 6 + 3, files
    for rel in files:
        with open(os.path.join(a["root"], rel), "rb") as f:
            want = f.read()
        with open(os.path.join(b["root"], rel), "rb") as f:
            assert f.read() == want, rel


def test_convert_split_and_the_symbolic_executor_agree(tmp_path):
    import json

    from stair_tpu.programs import preprocess as JPP
    from stair_tpu.programs import scene_graph as JSG
    from stair_tpu.testing import synthetic as JSY
    from stair_tpu_torch.programs import preprocess as TPP
    from stair_tpu_torch.programs import scene_graph as TSG

    w = JSY.make_world(str(tmp_path), num_videos=4, questions_per_video=5,
                       num_frames=20, seed=3)
    with open(w["questions"]) as f:
        qs = json.load(f)
    args = (w["scene_graphs"], w["id2word"], w["word2id"])
    jx, tx = JSG.SceneGraphExecutor(*args), TSG.SceneGraphExecutor(*args)
    for rec in qs.values():
        a = jx.run(video_id=rec["video_id"], program=rec["program"])
        b = tx.run(video_id=rec["video_id"], program=rec["program"])
        assert a[0] == b[0] == rec["answer"]
        assert ({k: v for k, v in a[1].items() if not callable(v)}
                == {k: v for k, v in b[1].items() if not callable(v)})
        assert (JSG.parse_sg_program(rec["program"])
                == TSG.parse_sg_program(rec["program"]))
    raw = [dict(r, qa_id=k) for k, r in qs.items()]
    JPP.set_executor(jx)
    TPP.set_executor(tx)
    want, got = JPP.convert_split(raw), TPP.convert_split(raw)
    assert len(got) == len(raw) and got == want
    assert any(r["sg_res_by_step"] for r in got)


def test_port_preprocess_imports_without_pandas():
    import subprocess
    import sys

    code = ("import sys\nsys.modules['pandas'] = None\n"
            "from stair_tpu_torch.programs import preprocess\n"
            "print(preprocess.convert_split([]))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr


def test_backup_code_copies_the_port(tmp_path):
    from stair_tpu_torch.utils.snapshot import backup_code

    dest = backup_code(str(tmp_path))
    pkg = os.path.join(dest, "stair_tpu_torch")
    assert os.path.exists(os.path.join(pkg, "train", "loop.py"))
    assert os.path.exists(os.path.join(pkg, "ops", "csrc", "bilstm.cu"))
    for root, dirs, names in os.walk(pkg):
        assert "__pycache__" not in dirs and "build" not in dirs, root
        assert not [n for n in names if n.endswith((".so", ".pyc"))], root


def test_parser_vocab_and_export_agree(tmp_path):
    # seq2seq/vocab.py and seq2seq/export.py: the same encodings,
    # decodings, saved JSON and exported fairseq files on a converted split
    import pickle

    from stair_tpu.seq2seq import export as JEx
    from stair_tpu.seq2seq import vocab as JVo
    from stair_tpu_torch.seq2seq import export as TEx
    from stair_tpu_torch.seq2seq import vocab as TVo
    from stair_tpu_torch.testing.agqa_world import write_agqa_world

    w = write_agqa_world(str(tmp_path / "world"), num_videos=4,
                         questions_per_video=5, num_frames=16, seed=2)
    with open(w["train"], "rb") as f:
        records = pickle.load(f)
    assert (JVo.PAD, JVo.BOS, JVo.EOS, JVo.UNK, JVo.SPECIALS) == (
        TVo.PAD, TVo.BOS, TVo.EOS, TVo.UNK, TVo.SPECIALS)
    questions = [r["question"] for r in records] + SENTENCES
    qtoks = [JVo.question_tokens(q) for q in questions]
    assert [TVo.question_tokens(q) for q in questions] == qtoks
    progs = [list(r["nmn_program"]) for r in records if r.get("nmn_program")]
    for toks, min_count in ((qtoks, 1), (progs, 1), (progs, 2)):
        jv, tv = (V.Vocab.build(toks, min_count) for V in (JVo, TVo))
        assert (tv.id2word, tv.word2id) == (jv.id2word, jv.word2id)
        for seq in toks + [["never", "seen"], []]:
            for max_len, eos in ((6, True), (6, False), (40, True)):
                ids = jv.encode(seq, max_len, add_eos=eos)
                assert tv.encode(seq, max_len, add_eos=eos) == ids
                assert tv.decode(ids) == jv.decode(ids)
        jv.save(tmp_path / "jax.json")
        tv.save(tmp_path / "port.json")
        assert ((tmp_path / "port.json").read_bytes()
                == (tmp_path / "jax.json").read_bytes())
        loaded = TVo.Vocab.load(tmp_path / "jax.json")
        assert (loaded.id2word, loaded.word2id) == (jv.id2word, jv.word2id)
    for split in ("train", "test"):
        n = [E.export_split(w[split], str(tmp_path / f"{name}_{split}"))
             for E, name in ((JEx, "jax"), (TEx, "port"))]
        assert n[0] == n[1] > 0
        for ext in ("question", "program"):
            assert ((tmp_path / f"port_{split}.{ext}").read_bytes()
                    == (tmp_path / f"jax_{split}.{ext}").read_bytes())
    TEx.main(["--records", w["valid"], "--out-prefixes",
              str(tmp_path / "cli")])
    JEx.export_split(w["valid"], str(tmp_path / "jcli"))
    assert ((tmp_path / "cli.program").read_bytes()
            == (tmp_path / "jcli.program").read_bytes())


def test_logutil_and_reformat_agqa_are_copies(tmp_path):
    import json
    import logging
    import pickle

    from stair_tpu.llm import reformat_agqa as JRf
    from stair_tpu.serve import logutil as JLu
    from stair_tpu_torch.llm import reformat_agqa as TRf
    from stair_tpu_torch.serve import logutil as TLu

    for j, t in ((JLu, TLu), (JRf, TRf)):
        with open(j.__file__, "rb") as fj, open(t.__file__, "rb") as ft:
            assert ft.read() == fj.read(), t.__file__
    assert (TLu.server_error_msg, TLu.moderation_msg) == (
        JLu.server_error_msg, JLu.moderation_msg)
    lines = {}
    for name, mod in (("jax", JLu), ("port", TLu)):
        seen = []

        class Keep(logging.Handler):
            def emit(self, record):
                seen.append(record.getMessage())

        log = logging.getLogger(f"copies.{name}")
        log.addHandler(Keep())
        log.setLevel(logging.INFO)
        stream = mod.StreamToLogger(log)
        stream.write("one\ntwo")
        stream.write(" halves\nthree\n")
        stream.write("tail")
        stream.flush()
        lines[name] = seen
    assert lines["port"] == lines["jax"] == ["one", "two halves", "three",
                                            "tail"]
    rng = np.random.RandomState(0)
    src = {f"q{i}": {"question": f"what happened {i} ?", "answer": "yes",
                     "video_id": f"V{i % 3}"} for i in range(40)}
    for shard in range(2):
        with open(tmp_path / f"filter_{shard}.pkl", "wb") as f:
            pickle.dump({f"q{i}": {
                0: (int(rng.randint(1, 4)), "holding", ["cup", "dish"]),
                1: (int(rng.randint(1, 4)), "before", ["opening the door"])}
                for i in range(shard, 40, 2)}, f)
    template = str(tmp_path / "filter_%d.pkl")
    filt = JRf.load_filter_data(template)
    assert TRf.load_filter_data(template) == filt and len(filt) == 40
    for ratio, seed in ((0.25, 0), (0.5, 3)):
        assert (TRf.reformat(src, filt, ratio, seed)
                == JRf.reformat(src, filt, ratio, seed))
    with open(tmp_path / "src.json", "w") as f:
        json.dump(src, f)
    for R, name in ((JRf, "jax"), (TRf, "port")):
        R.main(["--input_fname", str(tmp_path / "src.json"),
                "--filter_fname", template, "--sample_ratio", "0.3",
                "--output_fname", str(tmp_path / f"{name}.json")])
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
