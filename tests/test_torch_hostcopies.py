"""The port's own copies of the host-side modules give what the JAX
package's originals give on the same inputs.

``programs/{parser,text,spans}.py``, ``ir/lowering.py``,
``runtime/loader.py`` (with its own ``_native.so`` / ``_parser.so`` built
from the port's own C++ sources), ``train/args.py`` and the constants of
``data/dataset.py``: every program of the workload pool parsed,
span-linked, lowered and padded by both; the native batch path of both;
the argument parsers option by option; the constants value by value;
``load_video_features`` on a seeded feature directory and
``splice_filter_outputs`` string for string.
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
