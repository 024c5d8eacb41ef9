"""Datasets and fixed-shape batch packing.

Mirrors the reference data layer (yellow-binary-tree/STAIR
``video_nmn/dataset.py``) on the host side — GloVe word embeddings, npy/h5
video-feature preloading with the same subsampling/truncation rules, answer
vocabulary with the pinned ``yes/no/before/after`` head — but replaces the
batch-size-1 collate (``dataset.py:463-464``) with a packer that lowers every
program to its instruction trace and pads questions/videos/traces into fixed
[B, ...] arrays, so a whole batch executes as one XLA program.

Supervision targets from the symbolic executor are packed here too, as dense
per-step arrays (see ``SupervisionPack``): attention golds are rasterized
from fractional frame intervals with the reference's exact
``span_to_attention`` semantics (``train_module.py:67-81``), and contrastive
golds become per-batch class tables.

The port's own copy of ``stair_tpu/data/dataset.py``. Device-table batches
(``Batcher(device_tables=True)``) are materialized on the card by the
port's ``train/loop.py materialize_batch``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
import random
from dataclasses import dataclass

import numpy as np

from stair_tpu_torch.ir.lowering import (
    OP_FAMILY,
    Opcode,
    Trace,
    lower_program,
    pad_traces,
)
from stair_tpu_torch.programs.text import tokenize


# ---------------------------------------------------------------------------
# GloVe
# ---------------------------------------------------------------------------

class WordEmbeddings:
    """GloVe-style embeddings; deterministic hash-seeded vectors for OOV.

    (The reference draws a fresh ``np.random.rand`` vector per OOV occurrence
    — dataset.py:254 — which is nondeterministic; hashing the word keeps runs
    reproducible without changing in-vocabulary behavior.)
    """

    def __init__(self, filename: str):
        if filename.endswith(".pkl"):
            with open(filename, "rb") as f:
                self.table = pickle.load(f)
            self.dim = len(next(iter(self.table.values())))
        else:
            self.table = {}
            with open(filename) as f:
                first = f.readline().split(" ")
                has_header = len(first) == 2
                if not has_header:
                    word, vec = first[0], first[1:]
                    self.table[word] = np.asarray(vec, dtype=np.float64)
                for line in f:
                    parts = line.rstrip("\n").split(" ")
                    self.table[parts[0]] = np.asarray(parts[1:], dtype=np.float64)
            self.dim = len(next(iter(self.table.values())))

    def _ensure_matrix(self):
        if getattr(self, "_matrix", None) is None:
            self._index = {w: i for i, w in enumerate(self.table)}
            self._matrix = np.stack(
                [np.asarray(v, np.float32) for v in self.table.values()]
            ) if self.table else np.zeros((0, self.dim), np.float32)

    def _oov(self, word: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256(word.encode()).digest()[:4], "little"
        )
        return np.random.RandomState(seed).rand(self.dim).astype(np.float32)

    def embed_words(self, words: list[str]) -> np.ndarray:
        self._ensure_matrix()
        ids = np.array(
            [self._index.get(w, -1) for w in words], np.int64
        )
        out = self._matrix[np.maximum(ids, 0)] if len(words) else np.zeros(
            (0, self.dim), np.float32
        )
        for i in np.nonzero(ids < 0)[0]:
            out[i] = self._oov(words[i])
        return out

    def embed_sentence(self, sent) -> np.ndarray:
        return self.embed_words(self._words(sent))

    def _words(self, sent) -> list[str]:
        if isinstance(sent, str):
            return [w.lower() for w in tokenize(sent)]
        return [w.lower() for w in sent]

    # -- device-table mode ---------------------------------------------------
    # For hosts with a slow device link, batches can ship [B, L] int32 token
    # ids instead of [B, L, dim] f32 embeddings; the embedding table (GloVe
    # matrix + minted OOV rows, bit-identical to embed_words) lives on
    # device and the gather happens inside the jitted step.

    def sentence_ids(self, sent) -> np.ndarray:
        """Token ids into :meth:`embedding_table` (OOV rows minted)."""
        self._ensure_matrix()
        if getattr(self, "_ext_index", None) is None:
            self._ext_index: dict[str, int] = {}
            self._ext_rows: list[np.ndarray] = []
        base = self._matrix.shape[0]
        out = []
        for w in self._words(sent):
            i = self._index.get(w)
            if i is None:
                i = self._ext_index.get(w)
                if i is None:
                    i = base + len(self._ext_rows)
                    self._ext_index[w] = i
                    self._ext_rows.append(self._oov(w))
            out.append(i)
        return np.asarray(out, np.int32)

    def embedding_table(self) -> np.ndarray:
        """[V + OOV, dim] f32: row ``sentence_ids(s)[i]`` equals
        ``embed_sentence(s)[i]`` exactly."""
        self._ensure_matrix()
        ext = getattr(self, "_ext_rows", None) or []
        if not ext:
            return self._matrix
        return np.concatenate(
            [self._matrix, np.stack(ext).astype(np.float32)]
        )


# ---------------------------------------------------------------------------
# Video features
# ---------------------------------------------------------------------------

def load_video_features(
    appearance_path: str,
    motion_path: str | None,
    video_ids: set[str],
    max_video_length: int,
    str2num: dict | None = None,
) -> dict[str, np.ndarray]:
    """Preload per-video features, matching the reference's regimes:

    * npy directory (I3D): stride-2 temporal subsample then truncate
      (ref dataset.py:134-143);
    * h5 file: ``resnet_features`` mean over the clip axis, optional
      ``resnext_features`` motion concat (ref dataset.py:145-172).
    """
    feats: dict[str, np.ndarray] = {}
    if os.path.isdir(appearance_path):
        for fname in os.listdir(appearance_path):
            vid = fname.split(".")[0]
            if vid not in video_ids:
                continue
            arr = np.load(os.path.join(appearance_path, fname))
            arr = arr[::2][:max_video_length]
            feats[vid] = np.squeeze(np.asarray(arr, dtype=np.float32))
    elif os.path.isfile(appearance_path):
        import h5py

        with h5py.File(appearance_path, "r") as f:
            ids = {id_: i for i, id_ in enumerate(f["ids"][()])}
            for vid, num in (str2num or {}).items():
                if vid not in video_ids:
                    continue
                arr = f["resnet_features"][ids[num]][:max_video_length]
                feats[vid] = np.asarray(arr, dtype=np.float32).mean(axis=1)
    else:
        raise ValueError("appearance feature path not found: %s" % appearance_path)

    if motion_path is not None and os.path.isfile(motion_path):
        import h5py

        with h5py.File(motion_path, "r") as f:
            ids = {id_: i for i, id_ in enumerate(f["ids"][()])}
            for vid, num in (str2num or {}).items():
                if vid in feats:
                    arr = f["resnext_features"][ids[num]][:max_video_length]
                    feats[vid] = np.concatenate(
                        [feats[vid], np.asarray(arr, dtype=np.float32)], axis=-1
                    )
    return feats


# ---------------------------------------------------------------------------
# Answer vocabulary
# ---------------------------------------------------------------------------

def build_or_load_answer_vocab(vocab_filename: str, answers: list[str]) -> dict:
    """yes/no/before/after pinned first, then by frequency, <UNK> last.
    ref: dataset.py:71-95"""
    if os.path.exists(vocab_filename):
        with open(vocab_filename) as f:
            vocab = json.load(f)
        vocab["id2word"] = {int(k): v for k, v in vocab["id2word"].items()}
        head = [vocab["id2word"][i] for i in range(4)]
        if head != ["yes", "no", "before", "after"]:
            raise ValueError("answer vocab head must be yes/no/before/after")
        return vocab
    from collections import Counter

    ordered = ["yes", "no", "before", "after"]
    seen = set(ordered)
    for ans, _ in sorted(Counter(answers).items(), key=lambda x: -x[1]):
        if ans not in seen:
            ordered.append(ans)
            seen.add(ans)
    ordered.append("<UNK>")
    vocab = {
        "word2id": {w: i for i, w in enumerate(ordered)},
        "id2word": {i: w for i, w in enumerate(ordered)},
    }
    with open(vocab_filename, "w") as f:
        json.dump(
            {"word2id": vocab["word2id"],
             "id2word": {str(k): v for k, v in vocab["id2word"].items()}},
            f,
        )
    return vocab


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

@dataclass
class DataPaths:
    rgb_path: str
    glove_filename: str
    vocab_filename: str
    video_secs_path: str
    train_filename: str = ""
    valid_filename: str = ""
    test_filename: str = ""
    flow_path: str | None = None
    str2num_path: str | None = None
    word2id_filename: str | None = None


class AGQADataset:
    """Loads converted records + features; lowers every program once."""

    def __init__(
        self,
        paths: DataPaths,
        split: str,
        max_video_length: int = 150,
        novel_comp: int | None = None,
        more_steps: int | None = None,
        debug: bool = False,
        seed: int = 0,
        shuffle_video: bool = False,
        use_prog_word_embeddings: bool = False,
    ):
        self.split = split
        self.max_video_length = max_video_length
        self.use_prog_word_embeddings = use_prog_word_embeddings
        filename = {
            "train": paths.train_filename,
            "valid": paths.valid_filename,
            "test": paths.test_filename,
        }[split]
        with open(filename, "rb") as f:
            records = pickle.load(f)

        if split in ("train", "valid"):
            kept = []
            for rec in records:
                if rec.get("sg_res_by_step") is None:
                    rec["sg_res_by_step"] = {}
                spans = rec.get("nmn_program_span_by_word") or {}
                if (None, None) in spans.values():
                    continue  # ref dataset.py:52-54
                kept.append(rec)
            records = kept
        if novel_comp is not None:
            records = [r for r in records if r.get("novel_comp") == novel_comp]
        if more_steps is not None:
            records = [r for r in records if r.get("more_steps") == more_steps]
        if debug and len(records) > 256:
            records = random.Random(seed).sample(records, 256)
        self.records = records

        with open(paths.video_secs_path) as f:
            self.video_secs = json.load(f)
        self.embeddings = WordEmbeddings(paths.glove_filename)

        answers = [r["answer"] for r in records]
        self.answer_vocab = build_or_load_answer_vocab(
            paths.vocab_filename, answers
        )

        str2num = None
        if paths.str2num_path and os.path.exists(paths.str2num_path):
            with open(paths.str2num_path) as f:
                str2num = json.load(f)
        used = {r["video_id"] for r in records}
        self.video_feats = load_video_features(
            paths.rgb_path, paths.flow_path, used, max_video_length, str2num
        )
        if shuffle_video:
            # Ablation: permute which video each question sees
            # (ref dataset.py:103-110).
            ids = sorted(used)
            perm = list(ids)
            random.Random(seed).shuffle(perm)
            mapping = dict(zip(ids, perm))
            for rec in records:
                rec["video_id"] = mapping[rec["video_id"]]
        self.video_size = next(iter(self.video_feats.values())).shape[-1]
        from stair_tpu_torch.runtime.loader import FeatureArena

        self.feature_arena = FeatureArena(self.video_feats)

        # Object-type vocabulary for pretrain heads / FilterFrame supervision.
        self.word2id, self.id2index = {}, {}
        if paths.word2id_filename:
            with open(paths.word2id_filename) as f:
                word2id = json.load(f)
            ids = sorted(set(word2id.values()))
            self.id2index = {id_: i for i, id_ in enumerate(ids)}
            self.word2id = {
                w.replace("_", " "): self.id2index[id_]
                for w, id_ in word2id.items()
            }

        # Lower all programs once (host-side compilation of the corpus).
        self.traces: list[Trace | None] = []
        self.drop_reasons: dict[str, int] = {}
        for rec in records:
            try:
                tr = lower_program(
                    rec["nmn_program"],
                    rec.get("nmn_program_idx"),
                    rec.get("nmn_program_span_by_word") or {},
                    aux_text_for_missing_spans=use_prog_word_embeddings,
                )
            except Exception as err:  # unloadable program: keep but mark
                self.drop_reasons[type(err).__name__] = (
                    self.drop_reasons.get(type(err).__name__, 0) + 1
                )
                tr = None
            self.traces.append(tr)

    def __len__(self):
        return len(self.records)

    @property
    def answer_vocab_length(self):
        return len(self.answer_vocab["word2id"])

    def trace_geometry(self):
        """(max_steps, num_vec, num_frames, num_attn) over the corpus."""
        steps = vec = fr = at = 1
        for tr in self.traces:
            if tr is None:
                continue
            steps = max(steps, len(tr.instrs))
            vec = max(vec, tr.num_vec)
            fr = max(fr, tr.num_frames)
            at = max(at, tr.num_attn)
        return steps, vec, fr, at

    def question_embedding(self, rec) -> np.ndarray:
        return self.embeddings.embed_sentence(rec["question"])

    def text_embedding_cached(self, text: str) -> np.ndarray:
        """Cached ``embeddings.embed_sentence`` for recurring short strings
        (gold class names re-embed every batch otherwise)."""
        cache = getattr(self, "_text_emb_cache", None)
        if cache is None:
            cache = self._text_emb_cache = {}
        e = cache.get(text)
        if e is None:
            e = cache[text] = self.embeddings.embed_sentence(text)
        return e

    def text_token_ids_cached(self, text: str) -> np.ndarray:
        """Cached ``embeddings.sentence_ids`` for recurring short strings."""
        cache = getattr(self, "_text_ids_cache", None)
        if cache is None:
            cache = self._text_ids_cache = {}
        ids = cache.get(text)
        if ids is None:
            ids = cache[text] = self.embeddings.sentence_ids(text)
        return ids

    def question_token_ids(self, idx: int) -> np.ndarray:
        """Cached ``embeddings.sentence_ids`` for record ``idx`` (questions
        are static; re-tokenizing every epoch cost ~6 ms/batch)."""
        cache = getattr(self, "_q_ids_cache", None)
        if cache is None:
            cache = self._q_ids_cache = {}
        ids = cache.get(idx)
        if ids is None:
            ids = self.embeddings.sentence_ids(self.records[idx]["question"])
            cache[idx] = ids
        return ids

    def device_video_table(self):
        """Padded export of the feature arena for device residency:
        (table [n, F, D] f32, lengths [n] int32, video_id -> row).

        The padded table is built transiently (the caller uploads it and
        drops the host copy — caching it would duplicate the arena in
        RAM); only the cheap id->row index is cached."""
        return self.feature_arena.padded_table(self.max_video_length)

    @property
    def feature_arena_index(self) -> dict:
        if getattr(self, "_arena_index", None) is None:
            self._arena_index = {
                vid: i for i, vid in enumerate(self.feature_arena.offsets)
            }
        return self._arena_index

    def video_feature(self, rec) -> np.ndarray:
        return self.video_feats[rec["video_id"]]

    def answer_id(self, rec) -> int:
        w2i = self.answer_vocab["word2id"]
        return w2i.get(rec["answer"], w2i.get("<UNK>"))


class STARDataset(AGQADataset):
    """STAR multiple-choice QA (ref dataset.py:267-369).

    Records come from the ``merge_json_data_program`` path (parser-generated
    programs merged onto STAR questions). Train/valid keep only examples
    with a program; the answer id indexes the choices list. Candidate texts
    are embedded per example and scored by the model's choice head.
    """

    def __init__(self, paths, split, max_video_length=150,
                 num_candidates=4, extra_negatives=0, debug=False, seed=0,
                 use_prog_word_embeddings=False, **_):
        self.split = split
        self.max_video_length = max_video_length
        self.num_candidates = num_candidates + (
            extra_negatives if split == "train" else 0
        )
        self.use_prog_word_embeddings = use_prog_word_embeddings
        filename = {"train": paths.train_filename,
                    "valid": paths.valid_filename,
                    "test": paths.test_filename}[split]
        with open(filename, "rb") as f:
            records = pickle.load(f)
        kept = []
        for rec in records:
            rec = dict(rec)
            rec["question"] = rec["question"].replace("/", " ")
            if split in ("train", "valid"):
                if not rec.get("nmn_program"):
                    continue
                if isinstance(rec.get("answer"), str):
                    rec["answer_id"] = next(
                        (i for i, c in enumerate(rec["choices"])
                         if c["choice"] == rec["answer"]), 0,
                    )
                else:
                    rec["answer_id"] = rec.get("answer", 0)
            rec.setdefault("qa_id", rec.get("question_id"))
            rec["sg_res_by_step"] = rec.get("sg_res_by_step") or {}
            kept.append(rec)
        self.records = kept
        if split == "train" and extra_negatives:
            # Sample in-type negatives into each question's candidate list
            # (ref dataset.py:315-328).
            by_type: dict[str, set] = {}
            for rec in kept:
                qtype = str(rec.get("qa_id", "")).split("_")[0]
                by_type.setdefault(qtype, set()).add(rec.get("answer"))
            rng = random.Random(seed)
            for rec in kept:
                qtype = str(rec.get("qa_id", "")).split("_")[0]
                pool = sorted(
                    a for a in by_type.get(qtype, set())
                    if a is not None and a != rec.get("answer")
                )
                base = len(rec.get("choices", []))
                for i, neg in enumerate(
                    rng.sample(pool, min(extra_negatives, len(pool)))
                ):
                    rec["choices"].append(
                        {"choice_id": base + i, "choice": neg}
                    )

        with open(paths.video_secs_path) as f:
            self.video_secs = json.load(f)
        self.embeddings = WordEmbeddings(paths.glove_filename)
        self.answer_vocab = {"word2id": {}, "id2word": {}}
        self.word2id, self.id2index = {}, {}
        used = {r["video_id"] for r in self.records}
        self.video_feats = load_video_features(
            paths.rgb_path, paths.flow_path, used, max_video_length, None
        )
        self.video_size = next(iter(self.video_feats.values())).shape[-1]
        from stair_tpu_torch.runtime.loader import FeatureArena

        self.feature_arena = FeatureArena(self.video_feats)
        self.traces = []
        self.drop_reasons = {}
        for rec in self.records:
            try:
                tr = lower_program(
                    rec["nmn_program"], rec.get("nmn_program_idx"),
                    rec.get("nmn_program_span_by_word") or {},
                    aux_text_for_missing_spans=use_prog_word_embeddings,
                )
            except Exception as err:
                self.drop_reasons[type(err).__name__] = (
                    self.drop_reasons.get(type(err).__name__, 0) + 1
                )
                tr = None
            self.traces.append(tr)

    def video_feature(self, rec):
        """Clip by the question's [start, end] seconds when given
        (ref dataset.py:330-337)."""
        feats = self.video_feats[rec["video_id"]]
        lo, hi = self.video_clip(rec)
        return feats[lo:hi]

    def video_clip(self, rec) -> tuple[int, int]:
        """[lo, hi) frame range of the question's clip in the raw video."""
        n = len(self.video_feats[rec["video_id"]])
        start, end = rec.get("start"), rec.get("end")
        if start is None or end is None:
            return 0, n
        secs = self.video_secs.get(rec["video_id"], 0) or 1
        # Clamp to [0, n]: malformed negative timestamps would otherwise make
        # the host path's feats[lo:hi] slice from the end (Python negative
        # indexing) while the device gather clamps to frame 0 — the two paths
        # must agree on every record.
        if n == 0:
            return 0, 0
        lo = min(max(0, int(start / secs * n)), n - 1)
        hi = min(max(lo + 1, int(end / secs * n)), n)
        return lo, hi

    def candidate_token_ids(self, idx: int) -> list:
        """Cached per-record candidate token ids (device-table mode)."""
        cache = getattr(self, "_cand_ids_cache", None)
        if cache is None:
            cache = self._cand_ids_cache = {}
        ids = cache.get(idx)
        if ids is None:
            ids = [
                self.embeddings.sentence_ids(text)
                for text in self.candidates(self.records[idx])
            ]
            cache[idx] = ids
        return ids

    def answer_id(self, rec):
        return rec.get("answer_id", 0)

    def candidates(self, rec):
        return [
            c["choice"].replace("/", " ") for c in rec.get("choices", [])
        ][: self.num_candidates]


class MSRVTTDataset(AGQADataset):
    """MSR-VTT open-ended QA (ref dataset.py:372-460): records carry a
    'video' field; answers map to a frequency-capped vocabulary."""

    def __init__(self, paths, split, max_video_length=150,
                 max_vocab_length=1000, debug=False, seed=0,
                 use_prog_word_embeddings=False, **_):
        self.split = split
        self.max_video_length = max_video_length
        self.use_prog_word_embeddings = use_prog_word_embeddings
        filename = {"train": paths.train_filename,
                    "valid": paths.valid_filename,
                    "test": paths.test_filename}[split]
        with open(filename, "rb") as f:
            records = pickle.load(f)
        kept = []
        for rec in records:
            rec = dict(rec)
            rec["video_id"] = rec.get(
                "video_id", rec.get("video", "")
            ).replace(".mp4", "")
            rec.setdefault("qa_id", rec.get("question_id"))
            rec["sg_res_by_step"] = rec.get("sg_res_by_step") or {}
            if split in ("train", "valid") and not rec.get("nmn_program"):
                continue
            kept.append(rec)
        self.records = kept

        with open(paths.video_secs_path) as f:
            self.video_secs = json.load(f)
        self.embeddings = WordEmbeddings(paths.glove_filename)
        if os.path.exists(paths.vocab_filename):
            self.answer_vocab = build_or_load_answer_vocab_open(
                paths.vocab_filename
            )
        else:
            from collections import Counter

            counts = Counter(r["answer"] for r in kept)
            ordered = [w for w, _ in counts.most_common(max_vocab_length)]
            ordered.append("<UNK>")
            self.answer_vocab = {
                "word2id": {w: i for i, w in enumerate(ordered)},
                "id2word": {i: w for i, w in enumerate(ordered)},
            }
            with open(paths.vocab_filename, "w") as f:
                json.dump(
                    {"word2id": self.answer_vocab["word2id"],
                     "id2word": {str(k): v for k, v in
                                 self.answer_vocab["id2word"].items()}}, f,
                )
        self.word2id, self.id2index = {}, {}
        used = {r["video_id"] for r in self.records}
        str2num = None
        if paths.str2num_path and os.path.exists(paths.str2num_path):
            with open(paths.str2num_path) as f:
                str2num = json.load(f)
        self.video_feats = load_video_features(
            paths.rgb_path, paths.flow_path, used, max_video_length, str2num
        )
        self.video_size = next(iter(self.video_feats.values())).shape[-1]
        self.traces = []
        self.drop_reasons = {}
        for rec in self.records:
            try:
                tr = lower_program(
                    rec["nmn_program"], rec.get("nmn_program_idx"),
                    rec.get("nmn_program_span_by_word") or {},
                )
            except Exception as err:
                self.drop_reasons[type(err).__name__] = (
                    self.drop_reasons.get(type(err).__name__, 0) + 1
                )
                tr = None
            self.traces.append(tr)


def build_or_load_answer_vocab_open(vocab_filename: str) -> dict:
    with open(vocab_filename) as f:
        vocab = json.load(f)
    vocab["id2word"] = {int(k): v for k, v in vocab["id2word"].items()}
    return vocab


# ---------------------------------------------------------------------------
# Supervision packing
# ---------------------------------------------------------------------------

def span_to_attention(gold: tuple, num_frames: int) -> np.ndarray:
    """Fractional frame interval -> per-frame weight vector.
    Exact port of the reference semantics (train_module.py:67-81)."""
    out = np.zeros((num_frames,), dtype=np.float32)
    start = min(num_frames - 0.002, max(0.001, gold[0]))
    end = min(num_frames - 0.001, gold[1])
    s_int, e_int = math.ceil(start), math.floor(end)
    if s_int < e_int:
        out[s_int:e_int] += 1.0
    if s_int <= e_int:
        out[s_int - 1] += s_int - start
        out[e_int] += end - e_int
    else:
        out[e_int] += end - start
    return out


def encode_span(gold: tuple, num_frames: int):
    """``span_to_attention`` pre-resolved to integer writes.

    -> ((lo, hi, i0, i1), (w0, w1)): interior frames [lo, hi) get 1.0 and
    the two fractional writes land at i0/i1 (-1 = unused). Device-table
    batches ship these six numbers per gold row and the jitted step
    rasterizes; the host does all the float boundary math, so the result
    is bit-identical to the host-packed [F] vector."""
    start = min(num_frames - 0.002, max(0.001, gold[0]))
    end = min(num_frames - 0.001, gold[1])
    s_int, e_int = math.ceil(start), math.floor(end)
    lo, hi = (s_int, e_int) if s_int < e_int else (0, 0)
    if s_int <= e_int:
        return (lo, hi, s_int - 1, e_int), (s_int - start, end - e_int)
    return (lo, hi, e_int, -1), (end - start, 0.0)


# Supervision channel codes (routing inside the jitted loss).
(SUP_NONE, SUP_BOOL, SUP_EQUALS, SUP_ATTN1, SUP_ATTN2, SUP_CONTRAST,
 SUP_FRAME) = range(7)

#: module family -> supervision channel for scalar/bool targets
_FAMILY_CHANNEL = {
    "Exists": SUP_BOOL, "Xor": SUP_BOOL, "Equals": SUP_EQUALS,
    "ExistsFrame": SUP_ATTN1, "Temporal": SUP_ATTN1, "Localize": SUP_ATTN2,
    "Filter": SUP_CONTRAST, "ToAction": SUP_CONTRAST,
    "Superlative": SUP_CONTRAST,
}


@dataclass
class Batch:
    """All device-ready arrays for one batch."""

    question: np.ndarray          # [B, L, text]
    question_mask: np.ndarray     # [B, L] float32
    video: np.ndarray             # [B, F, video]
    video_mask: np.ndarray        # [B, F] float32
    answer: np.ndarray            # [B] int32
    trace: dict                   # field name -> [B, T] int32
    root_reg: np.ndarray          # [B]
    root_is_vec: np.ndarray       # [B]
    # --- supervision ---
    sup_channel: np.ndarray       # [B, T] int32 (SUP_*)
    sup_bool: np.ndarray          # [B, T] float32 (bool/equals target)
    sup_attn: np.ndarray          # [B, T, 2, F] float32 gold attentions
    sup_attn_rows: np.ndarray     # [B, T] int32 valid gold rows
    # contrastive: gold class table for the whole batch
    class_emb: np.ndarray         # [C, Lc, text] gold class token embeddings
    class_emb_mask: np.ndarray    # [C, Lc]
    class_valid: np.ndarray       # [C] float32
    sup_class: np.ndarray         # [B, T, Pmax] int32 class ids (-1 pad)
    qa_ids: list = None
    meta: dict = None
    # multiple-choice candidates (STAR): None for open-ended datasets
    cand_emb: np.ndarray = None   # [B, C, Lc, text]
    cand_mask: np.ndarray = None  # [B, C, Lc]
    cand_valid: np.ndarray = None  # [B, C]
    # FilterFrame supervision (sparse; off by default like the reference)
    ff_index: np.ndarray = None   # [Sff, 2] (example, step)
    ff_gold: np.ndarray = None    # [Sff, F, object_types]
    ff_valid: np.ndarray = None   # [Sff]
    # --use-prog-word-embeddings: program-token text for spanless args
    aux_emb: np.ndarray = None    # [B, T, La, text]
    aux_mask: np.ndarray = None   # [B, T, La]
    # device-table mode: indices into device-resident tables; when set,
    # question/question_mask/video/video_mask above are None and the step
    # function materializes them on device (train/loop.py).
    video_idx: np.ndarray = None      # [B] int32 rows of the video table
    video_clip: np.ndarray = None     # [B, 2] int32 [lo, hi) frame range
    question_ids: np.ndarray = None   # [B, L] int32 (-1 pad) embed rows
    cand_ids: np.ndarray = None       # [B, C, Lc] int32 (-1 pad) embed rows
    # device-table mode replaces sup_attn with its encoded form
    # (``encode_span``): [B, T, 2, 4] int32 (lo, hi, i0, i1) +
    # [B, T, 2, 2] f32 fractional weights, rasterized inside the step.
    sup_attn_enc: np.ndarray = None
    sup_attn_w: np.ndarray = None
    # device-table mode replaces class_emb/class_emb_mask with token ids
    class_token_ids: np.ndarray = None  # [C, Lc] int32 (-1 pad)


def device_table_support(ds) -> str | None:
    """How a dataset can use device-resident tables: 'plain' (whole-video
    rows), 'clip' (per-question [start, end] frame ranges, STAR-style), or
    None (no feature arena / custom video_feature override)."""
    if getattr(ds, "feature_arena", None) is None:
        return None
    if hasattr(ds, "video_clip"):
        return "clip"
    if type(ds).video_feature is AGQADataset.video_feature:
        return "plain"
    return None


class Batcher:
    """Packs dataset examples into fixed-shape batches."""

    def __init__(
        self,
        dataset: AGQADataset,
        batch_size: int,
        max_steps: int,
        num_vec: int,
        num_frames: int,
        num_attn: int,
        max_question_len: int = 32,
        max_positives: int = 4,
        max_classes: int = 64,
        max_class_len: int = 8,
        max_filterframe: int = 4,
        seed: int = 0,
        drop_remainder: bool = False,
        device_tables: bool = False,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.device_tables = device_tables
        self.geom = (max_steps, num_vec, num_frames, num_attn)
        self.max_question_len = max_question_len
        self.max_positives = max_positives
        self.max_classes = max_classes
        self.max_class_len = max_class_len
        self.max_filterframe = max_filterframe
        self.rng = random.Random(seed)
        self.drop_remainder = drop_remainder
        self.indices = [
            i for i, tr in enumerate(dataset.traces) if tr is not None
        ]
        self._sup_cache = None

    def epoch(self, shuffle: bool = True):
        order = list(self.indices)
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            real = len(chunk)
            if real < self.batch_size:
                if self.drop_remainder:
                    continue
                # pad to a fixed shape by cycling (meta['real'] marks truth)
                while len(chunk) < self.batch_size:
                    chunk = chunk + chunk[: self.batch_size - len(chunk)]
            yield self.pack(chunk, real=real)

    def pack(self, indices: list[int], real: int | None = None) -> Batch:
        ds = self.ds
        B = len(indices)
        T, NV, NF, NA = self.geom
        L = self.max_question_len
        F = ds.max_video_length
        text_dim = ds.embeddings.dim

        answer = np.zeros((B,), dtype=np.int32)

        traces = []
        recs = []
        arena = getattr(ds, "feature_arena", None)
        use_arena = arena is not None and type(ds).video_feature is AGQADataset.video_feature
        support = device_table_support(ds)
        clip_mode = support == "clip"
        dev = self.device_tables and support is not None
        question = question_mask = video = video_mask = None
        video_idx = video_clip = question_ids = None
        if dev:
            # Device-table mode: ship int32 indices; the step materializes
            # features/embeddings from device-resident tables.
            video_idx = np.zeros((B,), np.int32)
            video_clip = np.zeros((B, 2), np.int32)
            question_ids = np.full((B, L), -1, np.int32)
            vindex = ds.feature_arena_index
        else:
            question = np.zeros((B, L, text_dim), dtype=np.float32)
            question_mask = np.zeros((B, L), dtype=np.float32)
            video_dim = ds.video_size
            video = np.zeros((B, F, video_dim), dtype=np.float32)
            video_mask = np.zeros((B, F), dtype=np.float32)
        for b, idx in enumerate(indices):
            rec = ds.records[idx]
            recs.append(rec)
            traces.append(ds.traces[idx])
            if dev:
                ids = ds.question_token_ids(idx)[:L]
                question_ids[b, : len(ids)] = ids
                video_idx[b] = vindex[rec["video_id"]]
                n = min(arena.lengths[rec["video_id"]], F)
                lo, hi = ds.video_clip(rec) if clip_mode else (0, n)
                # Clamp to the stored frame count: the host path's
                # feats[lo:hi] silently truncates (or comes back empty),
                # and the device mask must match it exactly.
                video_clip[b] = (min(lo, n), min(hi, n))
            else:
                q = ds.question_embedding(rec)[:L]
                question[b, : len(q)] = q
                question_mask[b, : len(q)] = 1.0
                if not use_arena:
                    v = ds.video_feature(rec)[:F]
                    video[b, : len(v)] = v
                    video_mask[b, : len(v)] = 1.0
            answer[b] = ds.answer_id(rec)
        if use_arena and not dev:
            video, video_mask = arena.gather(
                [r["video_id"] for r in recs], F
            )

        tb = pad_traces(traces, T, NV, NF, NA)
        aux_emb = aux_mask = None
        if getattr(ds, "use_prog_word_embeddings", False):
            La = self.max_class_len
            aux_emb = np.zeros((B, T, La, text_dim), np.float32)
            aux_mask = np.zeros((B, T, La), np.float32)
            for b, tr in enumerate(traces):
                for t, ins in enumerate(tr.instrs):
                    if ins.span_start == -2 and 0 <= ins.token_pos < len(tr.tokens):
                        text = tr.tokens[ins.token_pos].replace(
                            "_", " ").replace("/", " ")
                        e = ds.embeddings.embed_sentence(text)[:La]
                        aux_emb[b, t, : len(e)] = e
                        aux_mask[b, t, : len(e)] = 1.0
        cand_emb = cand_mask = cand_valid = cand_ids = None
        if hasattr(ds, "candidates"):
            C, Lc = ds.num_candidates, self.max_class_len
            cand_valid = np.zeros((B, C), np.float32)
            if dev:
                cand_ids = np.full((B, C, Lc), -1, np.int32)
                for b, bidx in enumerate(indices):
                    for c, ids in enumerate(ds.candidate_token_ids(bidx)):
                        ids = ids[:Lc]
                        cand_ids[b, c, : len(ids)] = ids
                        cand_valid[b, c] = 1.0
            else:
                cand_emb = np.zeros((B, C, Lc, text_dim), np.float32)
                cand_mask = np.zeros((B, C, Lc), np.float32)
                for b, rec in enumerate(recs):
                    for c, text in enumerate(ds.candidates(rec)):
                        e = ds.embeddings.embed_sentence(text)[:Lc]
                        cand_emb[b, c, : len(e)] = e
                        cand_mask[b, c, : len(e)] = 1.0
                        cand_valid[b, c] = 1.0
        batch = Batch(
            question=question,
            question_mask=question_mask,
            video=video,
            video_mask=video_mask,
            answer=answer,
            trace=tb.fields,
            root_reg=tb.root_reg,
            root_is_vec=tb.root_is_vec,
            sup_channel=np.zeros((B, T), dtype=np.int32),
            sup_bool=np.zeros((B, T), dtype=np.float32),
            sup_attn=(
                None if dev else np.zeros((B, T, 2, F), dtype=np.float32)
            ),
            sup_attn_enc=(
                np.concatenate([
                    np.zeros((B, T, 2, 2), np.int32),        # lo, hi
                    np.full((B, T, 2, 2), -1, np.int32),     # i0, i1
                ], axis=-1) if dev else None
            ),
            sup_attn_w=np.zeros((B, T, 2, 2), np.float32) if dev else None,
            sup_attn_rows=np.zeros((B, T), dtype=np.int32),
            class_emb=(
                None if dev else np.zeros(
                    (self.max_classes, self.max_class_len, text_dim),
                    dtype=np.float32,
                )
            ),
            class_emb_mask=(
                None if dev else np.zeros(
                    (self.max_classes, self.max_class_len), dtype=np.float32
                )
            ),
            class_token_ids=(
                np.full((self.max_classes, self.max_class_len), -1,
                        np.int32) if dev else None
            ),
            class_valid=np.zeros((self.max_classes,), dtype=np.float32),
            sup_class=-np.ones((B, T, self.max_positives), dtype=np.int32),
            qa_ids=[r.get("qa_id") for r in recs],
            meta={"real": real if real is not None else B, "indices": indices},
            cand_emb=cand_emb, cand_mask=cand_mask, cand_valid=cand_valid,
            ff_index=np.zeros((self.max_filterframe, 2), np.int32),
            ff_gold=np.zeros(
                (self.max_filterframe, F, max(1, len(ds.id2index))),
                np.float32,
            ),
            ff_valid=np.zeros((self.max_filterframe,), np.float32),
            aux_emb=aux_emb, aux_mask=aux_mask,
            video_idx=video_idx, video_clip=video_clip,
            question_ids=question_ids, cand_ids=cand_ids,
        )
        self._pack_supervision(batch, recs, traces, indices)
        return batch

    # -- supervision ---------------------------------------------------------

    def _build_sup_cache(self):
        """Precompute the instruction x symbolic-gold join per record.

        The join (channel routing, interval rescale/encode, gold-class
        interning) is STATIC per record — only the batch-slot assembly
        varies per batch. Hoisting it out of ``pack`` turns the per-batch
        Python loop over B x T instructions into a handful of vectorized
        numpy gathers (the trainer's residual host-pack cost,
        REPORT round-2 perf notes).
        """
        ds = self.ds
        T, _, _, _ = self.geom
        P = self.max_positives
        F = ds.max_video_length
        arena = getattr(ds, "feature_arena", None)

        gids: dict[str, int] = {}          # dataset-global class registry

        def gid_of(name: str) -> int:
            if name not in gids:
                gids[name] = len(gids)
            return gids[name]

        n = len(ds.records)
        channel = np.zeros((n, T), np.int32)
        boolv = np.zeros((n, T), np.float32)
        rows = np.zeros((n, T), np.int32)
        attn_enc = np.concatenate([
            np.zeros((n, T, 2, 2), np.int32),
            np.full((n, T, 2, 2), -1, np.int32),
        ], axis=-1)
        attn_w = np.zeros((n, T, 2, 2), np.float32)
        cls = -np.ones((n, T, P), np.int32)
        ff: dict[int, list] = {}

        for i, (rec, tr) in enumerate(zip(ds.records, ds.traces)):
            if tr is None:
                continue
            sg = rec.get("sg_res_by_step") or {}
            if not sg:
                continue
            if arena is not None:
                nfr = min(arena.lengths[rec["video_id"]], F)
            else:
                nfr = min(len(ds.video_feats[rec["video_id"]]), F)
            if hasattr(ds, "video_clip"):
                lo_, hi_ = ds.video_clip(rec)
                if self.device_tables and device_table_support(ds):
                    # Device path: clip clamped to the stored frame count
                    # (mask rasterized in-jit must match).
                    video_len = max(0, min(hi_, nfr) - min(lo_, nfr))
                else:
                    # Host path: len(feats[lo:hi][:F]).
                    video_len = min(max(0, hi_ - lo_), F)
            else:
                video_len = nfr
            src_len = ds.video_secs.get(rec["video_id"], 0) * 3

            def rescale(iv):
                if src_len <= 0 or video_len <= 0:
                    return iv
                return (iv[0] / src_len * video_len,
                        iv[1] / src_len * video_len)

            for t, ins in enumerate(tr.instrs):
                if t >= T or not ins.supervised or ins.src not in sg:
                    continue
                gold = sg[ins.src]
                if gold is None:
                    continue
                family = OP_FAMILY.get(Opcode(ins.opcode))
                ch = _FAMILY_CHANNEL.get(family, SUP_NONE)
                if ch in (SUP_BOOL, SUP_EQUALS):
                    if isinstance(gold, bool):
                        channel[i, t] = ch
                        boolv[i, t] = float(gold)
                elif ch == SUP_ATTN1:
                    if (isinstance(gold, (tuple, list)) and len(gold) == 2
                            and isinstance(gold[0], float)):
                        channel[i, t] = ch
                        enc, w = encode_span(rescale(gold), F)
                        attn_enc[i, t, 0] = enc
                        attn_w[i, t, 0] = w
                        rows[i, t] = 1
                elif ch == SUP_ATTN2:
                    if (isinstance(gold, list) and gold
                            and isinstance(gold[0], tuple)):
                        r2 = min(len(gold), 2)
                        channel[i, t] = ch
                        for r in range(r2):
                            enc, w = encode_span(rescale(gold[r]), F)
                            attn_enc[i, t, r] = enc
                            attn_w[i, t, r] = w
                        rows[i, t] = r2
                elif family == "FilterFrame" and isinstance(gold, dict):
                    if not ds.word2id:
                        continue
                    spans = []
                    for name, iv in gold.items():
                        cid = ds.word2id.get(name)
                        if cid is None or not (
                            isinstance(iv, (tuple, list)) and len(iv) == 2
                        ):
                            continue
                        spans.append((cid, encode_span(rescale(iv), F)))
                    ff.setdefault(i, []).append((t, spans))
                elif ch == SUP_CONTRAST:
                    names = (
                        [gold] if isinstance(gold, str) else
                        [g for g in gold if isinstance(g, str)]
                        if isinstance(gold, list) else []
                    )
                    if not names:
                        continue
                    channel[i, t] = ch
                    for p, name in enumerate(names[:P]):
                        cls[i, t, p] = gid_of(name)

        G = max(1, len(gids))
        Lc = self.max_class_len
        tok = np.full((G, Lc), -1, np.int32)
        names_by_gid = [None] * G
        for name, g in gids.items():
            names_by_gid[g] = name
            ids = ds.text_token_ids_cached(name)[:Lc]
            tok[g, : len(ids)] = ids
        self._sup_cache = {
            "channel": channel, "bool": boolv, "rows": rows,
            "attn_enc": attn_enc, "attn_w": attn_w, "cls": cls, "ff": ff,
            "tok": tok, "names": names_by_gid, "emb": None,
        }
        return self._sup_cache

    @staticmethod
    def _rasterize(enc, w, F):
        """Vectorized ``span_to_attention`` from its integer encoding.

        enc [..., 4] = (lo, hi, i0, i1); w [..., 2]. Bit-identical to the
        scalar rasterizer: interior [lo, hi) adds 1.0 and the fractional
        writes land at i0/i1 (-1 = unused, always distinct indices).
        """
        lo, hi, i0, i1 = (enc[..., k][..., None] for k in range(4))
        idx = np.arange(F)
        out = ((idx >= lo) & (idx < hi)).astype(np.float32)
        out += np.where((idx == i0) & (i0 >= 0), w[..., 0][..., None], 0.0)
        out += np.where((idx == i1) & (i1 >= 0), w[..., 1][..., None], 0.0)
        return out

    def _pack_supervision(self, batch: Batch, recs, traces, indices=None):
        """Vectorized batch-slot assembly from the per-record cache."""
        if indices is None:
            return self._pack_supervision_slow(batch, recs, traces)
        cache = self._sup_cache or self._build_sup_cache()
        ds = self.ds
        F = ds.max_video_length
        idx = np.asarray(indices, np.int64)
        B = len(idx)
        T = batch.sup_channel.shape[1]

        batch.sup_channel[:] = cache["channel"][idx]
        batch.sup_bool[:] = cache["bool"][idx]
        batch.sup_attn_rows[:] = cache["rows"][idx]
        enc = cache["attn_enc"][idx]
        w = cache["attn_w"][idx]
        if batch.sup_attn is not None:
            batch.sup_attn[:] = self._rasterize(enc, w, F)
        else:
            batch.sup_attn_enc[:] = enc
            batch.sup_attn_w[:] = w

        # Batch class interning: first-seen order over the (b, t, p)
        # traversal, capped at max_classes (identical to the loop packer).
        cls = cache["cls"][idx]                              # [B, T, P]
        flat = cls.reshape(-1)
        used = flat[flat >= 0]
        if used.size:
            uniq, first = np.unique(used, return_index=True)
            ordered = uniq[np.argsort(first)][: self.max_classes]
            lut = np.full(cache["tok"].shape[0], -1, np.int32)
            lut[ordered] = np.arange(len(ordered), dtype=np.int32)
            mapped = np.where(cls >= 0, lut[np.maximum(cls, 0)], -1)
            # Compact each step's valid ids to the front (the loop packer
            # enumerates surviving cids from p=0 after cap overflow).
            order = np.argsort(mapped < 0, axis=-1, kind="stable")
            batch.sup_class[:] = np.take_along_axis(mapped, order, axis=-1)
            nb = len(ordered)
            if batch.class_token_ids is not None:
                batch.class_token_ids[:nb] = cache["tok"][ordered]
            else:
                if cache["emb"] is None:
                    Lc = self.max_class_len
                    D = ds.embeddings.dim
                    G = cache["tok"].shape[0]
                    emb = np.zeros((G, Lc, D), np.float32)
                    emb_mask = np.zeros((G, Lc), np.float32)
                    for g, name in enumerate(cache["names"]):
                        if name is None:
                            continue
                        e = ds.text_embedding_cached(name)[:Lc]
                        emb[g, : len(e)] = e
                        emb_mask[g, : len(e)] = 1.0
                    cache["emb"] = (emb, emb_mask)
                emb, emb_mask = cache["emb"]
                batch.class_emb[:nb] = emb[ordered]
                batch.class_emb_mask[:nb] = emb_mask[ordered]
            batch.class_valid[:nb] = 1.0
            # Steps whose every gold class overflowed the cap lose their
            # supervision channel, as in the loop packer.
            dead = (
                (batch.sup_channel == SUP_CONTRAST)
                & ~np.any(batch.sup_class >= 0, axis=-1)
            )
            batch.sup_channel[dead] = SUP_NONE
        else:
            batch.sup_class[:] = -1
            dead = batch.sup_channel == SUP_CONTRAST
            batch.sup_channel[dead] = SUP_NONE

        # FilterFrame slots (rare; bounded by max_filterframe).
        ff = cache["ff"]
        slot = 0
        for b, i in enumerate(idx):
            for t, spans in ff.get(int(i), []):
                if slot >= self.max_filterframe:
                    break
                grid = np.zeros_like(batch.ff_gold[slot])
                for cid, (e_, w_) in spans:
                    grid[:, cid] = self._rasterize(
                        np.asarray(e_), np.asarray(w_), F
                    )
                row_sum = grid.sum(axis=1, keepdims=True)
                with np.errstate(divide="ignore", invalid="ignore"):
                    grid = np.where(row_sum > 0, grid / row_sum, 0.0)
                batch.ff_index[slot] = (b, t)
                batch.ff_gold[slot] = grid
                batch.ff_valid[slot] = 1.0
                batch.sup_channel[b, t] = SUP_FRAME
                slot += 1

    def _pack_supervision_slow(self, batch: Batch, recs, traces):
        """Join symbolic step results onto instructions and rasterize golds.

        Gold intervals are emitted by the symbolic executor at 3 fps over the
        annotation clock; they are rescaled to feature frames exactly as the
        reference does (dataset.py:199-211: src length = video_secs * 3).
        """
        ds = self.ds
        F = ds.max_video_length
        class_ids: dict[str, int] = {}

        def intern_class(name: str) -> int:
            if name not in class_ids:
                cid = len(class_ids)
                if cid >= self.max_classes:
                    return -1
                class_ids[name] = cid
                Lc = self.max_class_len
                if batch.class_emb is not None:
                    emb = ds.text_embedding_cached(name)[:Lc]
                    batch.class_emb[cid, : len(emb)] = emb
                    batch.class_emb_mask[cid, : len(emb)] = 1.0
                else:
                    ids = ds.text_token_ids_cached(name)[:Lc]
                    batch.class_token_ids[cid, : len(ids)] = ids
                batch.class_valid[cid] = 1.0
            return class_ids[name]

        for b, (rec, tr) in enumerate(zip(recs, traces)):
            sg = rec.get("sg_res_by_step") or {}
            if not sg:
                continue
            if batch.video_mask is not None:
                video_len = int(batch.video_mask[b].sum())
            else:
                # device-table mode: the mask materializes on device;
                # mirror the host mask length (clip clamped to the
                # stored frame count).
                n = min(ds.feature_arena.lengths[rec["video_id"]], F)
                if hasattr(ds, "video_clip"):
                    lo, hi = ds.video_clip(rec)
                    video_len = max(0, min(hi, n) - min(lo, n))
                else:
                    video_len = n
            src_len = ds.video_secs.get(rec["video_id"], 0) * 3

            def put_gold(b, t, r, iv):
                if batch.sup_attn is not None:
                    batch.sup_attn[b, t, r] = span_to_attention(iv, F)
                else:
                    enc, w = encode_span(iv, F)
                    batch.sup_attn_enc[b, t, r] = enc
                    batch.sup_attn_w[b, t, r] = w

            def rescale(iv):
                if src_len <= 0 or video_len <= 0:
                    return iv
                return (
                    iv[0] / src_len * video_len,
                    iv[1] / src_len * video_len,
                )

            for t, ins in enumerate(tr.instrs):
                if not ins.supervised or ins.src not in sg:
                    continue
                gold = sg[ins.src]
                if gold is None:
                    continue
                family = OP_FAMILY.get(Opcode(ins.opcode))
                channel = _FAMILY_CHANNEL.get(family, SUP_NONE)
                if channel == SUP_BOOL or channel == SUP_EQUALS:
                    if not isinstance(gold, bool):
                        continue
                    batch.sup_channel[b, t] = channel
                    batch.sup_bool[b, t] = float(gold)
                elif channel == SUP_ATTN1:
                    if (
                        isinstance(gold, (tuple, list))
                        and len(gold) == 2
                        and isinstance(gold[0], float)
                    ):
                        batch.sup_channel[b, t] = channel
                        put_gold(b, t, 0, rescale(gold))
                        batch.sup_attn_rows[b, t] = 1
                elif channel == SUP_ATTN2:
                    if isinstance(gold, list) and gold and isinstance(
                        gold[0], tuple
                    ):
                        rows = min(len(gold), 2)
                        batch.sup_channel[b, t] = channel
                        for r in range(rows):
                            put_gold(b, t, r, rescale(gold[r]))
                        batch.sup_attn_rows[b, t] = rows
                elif family == "FilterFrame" and isinstance(gold, dict):
                    # Per-class occurrence grid, rows normalized
                    # (ref train_module.py:141-155). Sparse: few steps/batch.
                    slot = int(batch.ff_valid.sum())
                    if slot >= self.max_filterframe or not ds.word2id:
                        continue
                    grid = np.zeros_like(batch.ff_gold[slot])
                    for name, iv in gold.items():
                        cid = ds.word2id.get(name)
                        if cid is None or not (
                            isinstance(iv, (tuple, list)) and len(iv) == 2
                        ):
                            continue
                        grid[:, cid] = span_to_attention(rescale(iv), F)
                    row_sum = grid.sum(axis=1, keepdims=True)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        grid = np.where(row_sum > 0, grid / row_sum, 0.0)
                    batch.ff_index[slot] = (b, t)
                    batch.ff_gold[slot] = grid
                    batch.ff_valid[slot] = 1.0
                    batch.sup_channel[b, t] = SUP_FRAME
                elif channel == SUP_CONTRAST:
                    names = (
                        [gold] if isinstance(gold, str) else
                        [g for g in gold if isinstance(g, str)]
                        if isinstance(gold, list) else []
                    )
                    if not names:
                        continue
                    cids = [intern_class(n) for n in names[: self.max_positives]]
                    cids = [c for c in cids if c >= 0]
                    if not cids:
                        continue
                    batch.sup_channel[b, t] = channel
                    for p, cid in enumerate(cids):
                        batch.sup_class[b, t, p] = cid
