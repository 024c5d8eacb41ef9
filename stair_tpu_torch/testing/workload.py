"""Canned workloads for the port: realistic program mix, random tensors.

A JAX-free twin of ``stair_tpu/testing/workload.py``. That module imports
``stair_tpu.models.nmn`` (and with it JAX) at its top, so its numpy-only
host code — the program templates and pool, the hash embeddings, the
embedding arena, ``workload_config`` and ``make_batch`` — is copied here;
only ``workload_config`` and ``build_model`` return the port's types.
Parsing, lowering and native tokenization are the port's own copies of
the host layers (``programs/``, ``ir/``, ``runtime/``).
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np
import torch

from stair_tpu_torch.ir.lowering import Opcode, lower_program, pad_traces
from stair_tpu_torch.models.modules import cosine
from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
from stair_tpu_torch.programs.parser import parse_nmn_program
from stair_tpu_torch.programs.spans import link_program_spans
from stair_tpu_torch.runtime.loader import (
    _pack_strings, native_lib, native_parse_lower_batch,
)

#: Annotation-level program templates (the parser rewrites them exactly as it
#: would real AGQA annotations).
PROGRAM_TEMPLATES = [
    "Exists(food, Iterate(video, Filter(frame, [objects])))",
    "Exists(dish, Iterate(Localize(while, holding a dish), Filter(frame, [objects])))",
    "Exists(cup, Iterate(Localize(after, taking a cup), Filter(frame, [objects])))",
    "Exists(food, Iterate(Localize(between, [grasping onto a doorknob, drinking from a cup]), Filter(frame, [relations, holding, objects])))",
    "Choose(dish, blanket, Iterate(video, Filter(frame, [objects])))",
    "Query(class, Superlative(max, Filter(video, [actions]), Subtract(Query(end, action), Query(start, action))))",
    "Query(class, OnlyItem(IterateUntil(forward, video, Exists(touching, Filter(frame, [relations])), Filter(frame, [relations, touching, objects]))))",
    "Compare(Array2(before, after), Exists(dish, Iterate(Localize(temporal_tag, washing a window), Filter(frame, [objects]))))",
    "AND(Exists(food, Iterate(video, Filter(frame, [objects]))), Exists(cup, Iterate(video, Filter(frame, [objects]))))",
    "XOR(Exists(food, Iterate(video, Filter(frame, [objects]))), Exists(cup, Iterate(Localize(before, taking a cup), Filter(frame, [objects]))))",
]


def parse_pool():
    """Parse the template pool once; returns (parsed, traces)."""
    parsed = [parse_nmn_program(p) for p in PROGRAM_TEMPLATES]
    traces = [
        lower_program(p.tokens, p.source_index, {}) for p in parsed
    ]
    return parsed, traces


def link_lower(program: str, question: str):
    """Parse one annotation string, link its free-text arguments to spans
    of ``question`` and lower it: the Python path of the host pipeline."""
    parsed = parse_nmn_program(program)
    by_word, _ = link_program_spans(parsed.tokens, question)
    return lower_program(parsed.tokens, parsed.source_index, by_word or {})


def parse_lower_batch(cfg: NMNConfig, programs: list[str],
                      questions: list[str]):
    """Parse, span-link and lower a batch in the C++ parser
    (``runtime.loader.native_parse_lower_batch``), padded to the
    config's capacities; raises if the native library cannot be built."""
    tb = native_parse_lower_batch(
        programs, cfg.max_steps, cfg.num_vec, cfg.num_frames, cfg.num_attn,
        questions=questions)
    if tb is None:
        raise RuntimeError("the native parser library is unavailable")
    return tb


# Argument vocabularies for instantiating the structural templates into a
# large varied pool (objects/relations/activities in AGQA's register).
_OBJECTS = [
    "food", "cup", "dish", "blanket", "phone", "towel", "shoe", "box",
    "book", "laptop", "pillow", "broom", "mirror", "picture", "sandwich",
    "bottle",
]
_ACTIVITIES = [
    "holding a dish", "taking a cup", "washing a window",
    "drinking from a cup", "opening a door", "closing a book",
    "throwing a pillow", "watching television", "carrying a box",
    "touching a mirror", "eating a sandwich", "grasping onto a doorknob",
]
_RELATIONS = ["touching", "holding", "carrying", "wiping"]
_MODES = ["while", "before", "after"]


def program_pool(n: int = 128, seed: int = 0):
    """>=100 distinct (program, question) pairs over the template grammar,
    with the free-text arguments in the questions so span linking has real
    work to do."""
    rng = np.random.RandomState(seed)
    pairs = []
    while len(pairs) < n:
        obj = _OBJECTS[rng.randint(len(_OBJECTS))]
        obj2 = _OBJECTS[rng.randint(len(_OBJECTS))]
        act = _ACTIVITIES[rng.randint(len(_ACTIVITIES))]
        rel = _RELATIONS[rng.randint(len(_RELATIONS))]
        mode = _MODES[rng.randint(len(_MODES))]
        kind = len(pairs) % 6
        if kind == 0:
            prog = f"Exists({obj}, Iterate(video, Filter(frame, [objects])))"
            q = f"were they near the {obj} ?"
        elif kind == 1:
            prog = (f"Exists({obj}, Iterate(Localize({mode}, {act}), "
                    "Filter(frame, [objects])))")
            q = f"was there a {obj} {mode} {act} ?"
        elif kind == 2:
            prog = (f"Choose({obj}, {obj2}, Iterate(video, "
                    "Filter(frame, [objects])))")
            q = f"did they touch the {obj} or the {obj2} ?"
        elif kind == 3:
            prog = ("Query(class, Superlative(max, Filter(video, [actions]), "
                    "Subtract(Query(end, action), Query(start, action))))")
            q = "which activity took the longest time ?"
        elif kind == 4:
            prog = (f"AND(Exists({obj}, Iterate(video, Filter(frame, "
                    f"[objects]))), Exists({obj2}, Iterate(video, "
                    "Filter(frame, [objects]))))")
            q = f"did they have both the {obj} and the {obj2} ?"
        else:
            prog = ("Query(class, OnlyItem(IterateUntil(forward, video, "
                    f"Exists({rel}, Filter(frame, [relations])), "
                    f"Filter(frame, [relations, {rel}, objects]))))")
            q = f"what were they {rel} first ?"
        pairs.append((prog, q))
    return pairs


class HashEmbeddings:
    """Deterministic word->vector table standing in for GloVe in benches
    (same per-question lookup/stack host cost, no 2GB file)."""

    #: appended to every word before it seeds its vector: another salt,
    #: another table
    salt = ""

    def __init__(self, dim: int = 300):
        self.dim = dim
        self._cache: dict[str, np.ndarray] = {}

    def _vector(self, word: str) -> np.ndarray:
        vec = self._cache.get(word)
        if vec is None:
            # not hash(): Python salts it per process
            seed = zlib.crc32((word + self.salt).encode("utf-8")) % (
                2 ** 31)
            vec = np.random.RandomState(seed).randn(self.dim).astype(
                np.float32
            )
            self._cache[word] = vec
        return vec


#: The arena whose ids currently populate the process-global C++ vocab
#: (stair_tokenize_ids); any other arena must reset + reseed before use.
_native_vocab_owner = None


class EmbeddingArena:
    """Word-embedding table as one contiguous block + native row gather —
    the production shape of per-question GloVe lookup (tokenize -> ids ->
    device-side row gather)."""

    def __init__(self, dim: int = 300):
        self.dim = dim
        self.word2id: dict[str, int] = {}
        self._rows: list[np.ndarray] = []
        self._source = HashEmbeddings(dim)
        self._arena: np.ndarray | None = None
        self._native_synced = 0  # words mirrored into the C++ vocab

    def _id(self, word: str) -> int:
        idx = self.word2id.get(word)
        if idx is None:
            idx = len(self._rows)
            self.word2id[word] = idx
            self._rows.append(self._source._vector(word))
            self._arena = None
        return idx

    def token_ids(self, sentence: str, max_len: int) -> np.ndarray:
        ids = np.full((max_len,), -1, np.int64)
        for i, w in enumerate(sentence.lower().split()[:max_len]):
            ids[i] = self._id(w)
        return ids

    def token_id_batch(self, questions: list[str], max_len: int):
        """-> ids [B, L] int32 (-1 = pad), tokenized in C++
        (``stair_tokenize_ids``) when the native library is available,
        mirroring this arena's first-seen id assignment; new words the
        tokenizer meets are synced back as embedding rows."""
        lib = native_lib()
        if lib is None or not all(q.isascii() for q in questions):
            return np.stack(
                [self.token_ids(q, max_len) for q in questions]
            ).astype(np.int32)
        global _native_vocab_owner
        if (_native_vocab_owner is not self
                or lib.stair_vocab_size() != self._native_synced):
            lib.stair_vocab_reset()
            self._native_synced = 0
            _native_vocab_owner = self
        if self._native_synced < len(self._rows):
            words = [None] * len(self.word2id)
            for w, i in self.word2id.items():
                words[i] = w
            blob, offs = _pack_strings(words[self._native_synced:])
            self._native_synced = lib.stair_vocab_add_words(
                blob, offs, len(words) - self._native_synced
            )
        blob, offs = _pack_strings(questions)
        ids = np.empty((len(questions), max_len), np.int32)
        lib.stair_tokenize_ids(blob, offs, len(questions), max_len, ids, 1)
        new_size = lib.stair_vocab_size()
        if new_size != self._native_synced:
            buf = ctypes.create_string_buffer(4096)
            for i in range(self._native_synced, new_size):
                assert lib.stair_vocab_word(i, buf, 4096) >= 0
                got = self._id(buf.value.decode())
                assert got == i, (got, i)
            self._native_synced = new_size
        return ids

    def table(self) -> np.ndarray:
        """The embedding table as one [V, dim] f32 block (device-uploadable)."""
        if self._arena is None:
            self._arena = np.ascontiguousarray(np.stack(self._rows))
        return self._arena


def workload_config(
    hidden_size=512,
    video_size=1024,
    text_size=300,
    max_video_length=64,
    answer_vocab_length=172,
    traces=None,
) -> NMNConfig:
    if traces is None:
        _, traces = parse_pool()
    return NMNConfig(
        hidden_size=hidden_size,
        video_size=video_size,
        text_size=text_size,
        answer_vocab_length=answer_vocab_length,
        max_video_length=max_video_length,
        object_types=64,
        have_pretrain_head=True,
        max_steps=max(len(t.instrs) for t in traces),
        num_vec=max(t.num_vec for t in traces),
        num_frames=max(t.num_frames for t in traces),
        num_attn=max(t.num_attn for t in traces),
    )


def make_batch(cfg: NMNConfig, batch_size: int, question_len=16, seed=0):
    """One padded batch over the template pool with random tensors
    (numpy arrays; ``to_device`` moves it to torch)."""
    rng = np.random.RandomState(seed)
    _, traces = parse_pool()
    picked = [traces[i % len(traces)] for i in range(batch_size)]
    tb = pad_traces(
        picked, cfg.max_steps, cfg.num_vec, cfg.num_frames, cfg.num_attn
    )
    F, L = cfg.max_video_length, question_len
    batch = {
        "question": rng.randn(batch_size, L, cfg.text_size).astype(np.float32),
        "question_mask": np.ones((batch_size, L), np.float32),
        "video": rng.randn(batch_size, F, cfg.video_size).astype(np.float32),
        "video_mask": np.ones((batch_size, F), np.float32),
        "answer": rng.randint(
            0, cfg.answer_vocab_length, (batch_size,)
        ).astype(np.int32),
        "trace": tb.fields,
        "root_reg": tb.root_reg,
        "root_is_vec": tb.root_is_vec,
    }
    return batch


#: Prefix programs (tokens, span_by_word) that together cover every live
#: opcode, heterogeneous kinds mixed in one batch — the executor's coverage
#: set (the same list as tests/test_mega_exec.py PROGRAMS).
OPCODE_PROGRAMS = [
    (["And", "cup", "dish"], {}),                              # AND_VEC
    (["Compare", "cup", "dish"], {1: (0, 3)}),                 # + real span
    (["Equals", "cup", "dish"], {}),
    (["Choose", "cup", "dish", "phone"], {}),
    (["Xor", "cup", "dish"], {}),
    (["Query", "cup"], {}),
    (["ToAction", "cup", "dish"], {}),
    (["Exists", "cup", "Filter", "video", "objects"], {}),
    (["ExistsFrame", "cup", "video"], {}),
    (["HasItem", "video"], {}),
    (["And", "HasItem", "video", "ExistsFrame", "cup", "video"], {}),
    (["Xor", "HasItem", "video", "ExistsFrame", "cup", "video"], {}),
    (["Localize", "video", "cup"], {}),
    (["Localize", "video", "Array2", "cup", "dish"], {}),
    (["Superlative", "max", "cup", "video"], {}),
    (["Superlative", "min", "Array2", "cup", "dish", "video"], {}),
    (["Superlative", "max", "FilterFrame", "video", "actions", "video"],
     {}),                                                      # SUP_F
    (["Filter", "Temporal", "while", "video", "HasItem", "video",
      "actions"], {}),
    (["Filter", "Temporal", "before", "video", "Array2", "HasItem",
      "video", "ExistsFrame", "cup", "video", "actions"], {}),
    (["Filter", "Temporal", "after", "AttnVideo", "video", "HasItem",
      "video", "HasItem", "video", "relations"], {}),
    (["Filter", "video", "cup"], {2: (2, 5)}),                 # FILTER_V
    (["Filter", "video", "actions"], {}),
    (["Filter", "video", "relations"], {}),
    (["FilterFrame", "video", "cup"], {}),
    (["FilterFrame", "video", "objects"], {}),
    (["Filter", "AttnVideo", "video", "Relate", "forward", "HasItem",
      "video", "actions"], {}),
    (["Filter", "AttnVideo", "video", "Relate", "backward", "HasItem",
      "video", "objects"], {}),
]


def add_fake_supervision(batch, cfg: NMNConfig, text_size=None, seed=0):
    """Dense supervision arrays so the full train step can run (the twin of
    ``stair_tpu/testing/workload.py add_fake_supervision``: the same numpy
    arrays from the same seed)."""
    rng = np.random.RandomState(seed)
    B, T = batch["trace"]["opcode"].shape
    F = cfg.max_video_length
    text = text_size or cfg.text_size
    C, P, Lc = 16, 2, 4
    batch.update({
        "sup_channel": rng.randint(0, 6, (B, T)).astype(np.int32),
        "sup_bool": rng.randint(0, 2, (B, T)).astype(np.float32),
        "sup_attn": rng.rand(B, T, 2, F).astype(np.float32),
        "sup_attn_rows": rng.randint(1, 3, (B, T)).astype(np.int32),
        "class_emb": rng.randn(C, Lc, text).astype(np.float32),
        "class_emb_mask": np.ones((C, Lc), np.float32),
        "class_valid": np.ones((C,), np.float32),
        "sup_class": rng.randint(-1, C, (B, T, P)).astype(np.int32),
        "ff_index": np.zeros((2, 2), np.int32),
        "ff_gold": np.zeros((2, F, cfg.object_types), np.float32),
        "ff_valid": np.zeros((2,), np.float32),
    })
    return batch


def opcode_batch(cfg: NMNConfig, programs, seed=0, question_len=10,
                 aux=False):
    """A numpy batch over token-level ``programs`` with ragged masks
    (tests/test_mega_exec.py ``_batch`` at the config's widths)."""
    rng = np.random.RandomState(seed)
    traces = [
        lower_program(toks, None, spans, aux_text_for_missing_spans=aux)
        for toks, spans in programs
    ]
    tb = pad_traces(traces, cfg.max_steps, cfg.num_vec, cfg.num_frames,
                    cfg.num_attn)
    B, L, Fv = len(traces), question_len, cfg.max_video_length
    batch = {
        "question": rng.randn(B, L, cfg.text_size).astype(np.float32),
        "question_mask": (np.arange(L)[None, :]
                          < rng.randint(4, L + 1, size=(B, 1))
                          ).astype(np.float32),
        "video": rng.randn(B, Fv, cfg.video_size).astype(np.float32),
        "video_mask": (np.arange(Fv)[None, :]
                       < rng.randint(3, Fv + 1, size=(B, 1))
                       ).astype(np.float32),
        "trace": tb.fields,
        "root_reg": tb.root_reg,
        "root_is_vec": tb.root_is_vec,
    }
    if aux:
        batch["aux_emb"] = rng.randn(
            B, cfg.max_steps, 4, cfg.text_size).astype(np.float32)
        batch["aux_mask"] = np.ones((B, cfg.max_steps, 4), np.float32)
    return batch


def to_device(batch, device=None, pin=False):
    """numpy batch (nested dicts) -> torch tensors on ``device``; with
    ``pin`` host arrays are staged in pinned memory and copied async."""
    if isinstance(batch, dict):
        return {k: to_device(v, device, pin) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if pin:
        t = t.pin_memory()
    return t.to(device, non_blocking=pin)


def build_model(cfg: NMNConfig, seed=0, device=None, executor="mega"):
    """A ``VideoNMN`` with random weights drawn from ``seed``."""
    return VideoNMN(cfg, generator=torch.Generator().manual_seed(seed),
                    device=device, executor=executor)


class ServingBatches:
    """The serving path's inputs over the program pool, as ``bench.py``
    feeds the JAX model: the config sized to the pool's traces, then per
    batch native parse/lower with span linking and tokenization to ids on
    the host (``host_batch``), and H2D (pinned on CUDA) plus the device
    embedding-row gather (``device_batch``). Video features are random on
    the device, made from ``seed``. The defaults are the bench
    configuration (``bench.py:125-129``)."""

    def __init__(self, device, batch_size=1024, question_len=16,
                 pool_size=128, hidden_size=512, video_size=1024,
                 text_size=300, max_video_length=64,
                 compute_dtype="bfloat16", seed=0):
        self.device = torch.device(device)
        self.batch_size, self.question_len = batch_size, question_len
        self.pool = program_pool(pool_size)
        _, tmpl = parse_pool()
        cfg = workload_config(
            hidden_size=hidden_size, video_size=video_size,
            text_size=text_size, max_video_length=max_video_length,
            traces=tmpl + [link_lower(*p) for p in self.pool])
        self.cfg = NMNConfig(**{**cfg.to_dict(),
                                "compute_dtype": compute_dtype})
        self.arena = EmbeddingArena(text_size)
        self.arena.token_id_batch([q for _, q in self.pool], question_len)
        self.table = torch.from_numpy(self.arena.table()).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.video = torch.randn(batch_size, max_video_length, video_size,
                                 generator=gen, device=self.device)
        self.video_mask = torch.ones(batch_size, max_video_length,
                                     device=self.device)
        self.order = np.random.RandomState(seed + 1).permutation(
            len(self.pool))

    def host_batch(self, i: int) -> dict:
        """Batch ``i`` (a rotation through the pool) parsed, lowered and
        tokenized on the host, as numpy arrays."""
        n = len(self.pool)
        sel = [self.pool[self.order[(i * 31 + q) % n]]
               for q in range(self.batch_size)]
        questions = [q for _, q in sel]
        tb = parse_lower_batch(self.cfg, [p for p, _ in sel], questions)
        ids = self.arena.token_id_batch(questions, self.question_len)
        return {"ids": ids, "trace": tb.fields, "root_reg": tb.root_reg,
                "root_is_vec": tb.root_is_vec}

    def device_batch(self, hb: dict) -> dict:
        """``host_batch``'s output on the device, questions gathered from
        the embedding table; the model's input dict."""
        d = to_device(hb, self.device, pin=self.device.type == "cuda")
        ids = d.pop("ids")
        valid = (ids >= 0) & (ids < self.table.shape[0])
        q = torch.where(valid[:, :, None],
                        self.table[ids.clamp(min=0).long()], 0.0)
        return dict(d, question=q, question_mask=valid.float(),
                    video=self.video, video_mask=self.video_mask)


def choose_flips(trace, rv_a, rv_b):
    """Per example of two routes' vec files: whether a Choose step kept
    another operand in ``rv_a`` than in ``rv_b``, and the least
    ``|cos(kw1, q) - cos(kw2, q)|`` over the example's Choose steps
    (float32, from ``rv_b``; inf without one). The files are SSA, so they
    still hold every step's operands beside its result."""
    B, T = trace["opcode"].shape
    ar = torch.arange(B, device=rv_b.device)
    flipped = torch.zeros(B, dtype=torch.bool, device=rv_b.device)
    margin = torch.full((B,), float("inf"), device=rv_b.device)
    for t in range(T):
        is_choose = trace["opcode"][:, t] == int(Opcode.CHOOSE)
        if not bool(is_choose.any()):
            continue
        va, vb, vc, dst = (trace[k][:, t].long()
                           for k in ("va", "vb", "vc", "out_vec"))
        first = [(rv[ar, dst] == rv[ar, va]).all(-1) for rv in (rv_a, rv_b)]
        flipped |= is_choose & (first[0] != first[1])
        q = rv_b[ar, vc].float()
        gap = (cosine(rv_b[ar, va].float(), q)
               - cosine(rv_b[ar, vb].float(), q)).abs()
        margin = torch.where(is_choose, torch.minimum(margin, gap), margin)
    return flipped, margin
