"""ctypes bindings for the native runtime + the prefetching input pipeline.

The port's own copy of ``stair_tpu/runtime/loader.py``: it builds its own
``_native.so`` / ``_parser.so`` from the sources beside it and never loads
the JAX package's libraries. The C++ library (:file:`native.cpp`) is
compiled on demand with the system toolchain and cached next to the source
(written under a temporary name and renamed, so concurrent first uses do
not load a half-written file); every entry point has a numpy fallback so
the framework degrades gracefully on hosts without a compiler.
``device_prefetch`` is the port's own (the JAX trainers start
``jax.device_put`` in their prefetch worker instead): pinned host-to-device
copies on a side stream.

``FeatureArena`` packs all per-video features into one contiguous float32
block (one allocation, zero per-batch Python object traffic) and assembles
padded batches with the native multithreaded gather. ``PrefetchIterator``
runs any batch generator on a background thread with a bounded queue so host
packing overlaps device compute — the role torch DataLoader workers play in
the reference (train_module.py:282-283).
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading

import numpy as np

from stair_tpu_torch.data.dataset import span_to_attention
from stair_tpu_torch.ir.lowering import (
    _INT_FIELDS,
    _F_OUT_VEC, _F_OUT_FRAMES, _F_OUT_ATTN, _F_OUT_ATTN_B,
    _F_SPAN_START, _F_SPAN_END, _F_SRC,
    TraceBatch, lower_program,
)
from stair_tpu_torch.programs.parser import parse_nmn_program
from stair_tpu_torch.programs.spans import link_program_spans


def _compile(args, src, lib):
    """g++ ``src`` into ``lib`` unless ``lib`` is newer; atomic."""
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run(["g++", *args, "-O3", "-shared", "-fPIC", "-pthread",
                    src, "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, lib)


_SRC = os.path.join(os.path.dirname(__file__), "native.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "_native.so")
_lib = None
_lib_tried = False


def native_lib():
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        _compile([], _SRC, _LIB)
        lib = ctypes.CDLL(_LIB)
        lib.stair_native_version.restype = ctypes.c_int
        assert lib.stair_native_version() == 2
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.stair_gather_pad_f32.argtypes = [
            f32p, i64p, i32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, f32p, f32p, ctypes.c_int,
        ]
        lib.stair_span_to_attention.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_int,
        ]
        lib.stair_gather_rows_f32.argtypes = [
            f32p, i64p, ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_int,
        ]
        lib.stair_vocab_reset.argtypes = []
        lib.stair_vocab_add_words.restype = ctypes.c_int64
        lib.stair_vocab_add_words.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64,
        ]
        lib.stair_vocab_size.restype = ctypes.c_int64
        lib.stair_vocab_size.argtypes = []
        lib.stair_vocab_word.restype = ctypes.c_int64
        lib.stair_vocab_word.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.stair_tokenize_ids.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int32,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


DEFAULT_THREADS = min(16, os.cpu_count() or 1)


class FeatureArena:
    """All video features in one contiguous [total_rows, D] float32 block."""

    def __init__(self, feats: dict[str, np.ndarray]):
        self.dim = next(iter(feats.values())).shape[-1]
        self.offsets: dict[str, int] = {}
        self.lengths: dict[str, int] = {}
        total = 0
        for vid, arr in feats.items():
            self.offsets[vid] = total
            self.lengths[vid] = len(arr)
            total += len(arr)
        self.arena = np.empty((total, self.dim), np.float32)
        for vid, arr in feats.items():
            o = self.offsets[vid]
            self.arena[o:o + len(arr)] = arr

    def padded_table(self, max_rows: int):
        """Export as a device-uploadable padded table.

        -> (table [n_videos, max_rows, D] f32, lengths [n_videos] int32,
        video_id -> row index). For slow device links the training loop
        uploads this once and batches ship only [B] int32 row indices.
        """
        ids = list(self.offsets)
        index = {vid: i for i, vid in enumerate(ids)}
        table = np.zeros((len(ids), max_rows, self.dim), np.float32)
        lens = np.zeros((len(ids),), np.int32)
        for i, vid in enumerate(ids):
            n = min(self.lengths[vid], max_rows)
            o = self.offsets[vid]
            table[i, :n] = self.arena[o:o + n]
            lens[i] = n
        return table, lens, index

    def gather(self, video_ids: list[str], max_rows: int):
        """-> (feats [B, F, D], mask [B, F])."""
        B = len(video_ids)
        offsets = np.array(
            [self.offsets[v] for v in video_ids], np.int64
        )
        lengths = np.array(
            [self.lengths[v] for v in video_ids], np.int32
        )
        out = np.empty((B, max_rows, self.dim), np.float32)
        mask = np.empty((B, max_rows), np.float32)
        lib = native_lib()
        if lib is not None:
            lib.stair_gather_pad_f32(
                self.arena, offsets, lengths, B, max_rows, self.dim,
                out, mask, DEFAULT_THREADS,
            )
            return out, mask
        out.fill(0.0)
        mask.fill(0.0)
        for b, vid in enumerate(video_ids):
            n = min(self.lengths[vid], max_rows)
            o = self.offsets[vid]
            out[b, :n] = self.arena[o:o + n]
            mask[b, :n] = 1.0
        return out, mask


def span_to_attention_batch(intervals: np.ndarray, frames: int) -> np.ndarray:
    """[N, 2] fractional intervals -> [N, frames] weights (native or numpy)."""
    intervals = np.ascontiguousarray(intervals, np.float32)
    n = len(intervals)
    out = np.empty((n, frames), np.float32)
    lib = native_lib()
    if lib is not None:
        lib.stair_span_to_attention(intervals, n, frames, out,
                                    DEFAULT_THREADS)
        return out
    for i in range(n):
        out[i] = span_to_attention(tuple(intervals[i]), frames)
    return out


_PARSER_SRC = os.path.join(os.path.dirname(__file__), "parser.cpp")
_PARSER_LIB = os.path.join(os.path.dirname(__file__), "_parser.so")
_parser_lib = None
_parser_tried = False


def parser_lib():
    """Load (compiling on demand) the native parser; None if unavailable."""
    global _parser_lib, _parser_tried
    if _parser_tried:
        return _parser_lib
    _parser_tried = True
    try:
        _compile(["-std=c++20"], _PARSER_SRC, _PARSER_LIB)
        lib = ctypes.CDLL(_PARSER_LIB)
        lib.stair_parser_version.restype = ctypes.c_int
        assert lib.stair_parser_version() == 3
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.stair_parse_lower_batch.argtypes = [
            ctypes.c_char_p, i64p,             # programs
            ctypes.c_char_p, ctypes.c_void_p,  # questions (nullable)
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            i32p, u8p, i32p, u8p, ctypes.c_int,
        ]
        _parser_lib = lib
    except Exception:
        _parser_lib = None
    return _parser_lib


def _pack_strings(strings: list[str]):
    if not strings:
        return b"\0", np.zeros((0,), np.int64)
    encoded = [s.encode() for s in strings]
    blob = b"\0".join(encoded) + b"\0"
    lengths = np.fromiter(
        (len(e) + 1 for e in encoded), np.int64, count=len(encoded)
    )
    offsets = np.concatenate(([0], np.cumsum(lengths[:-1])))
    return blob, offsets


def native_parse_lower_batch(
    programs: list[str], max_steps: int, num_vec: int, num_frames: int,
    num_attn: int, threads: int | None = None,
    questions: list[str] | None = None, aux_missing: bool = False,
):
    """Parse+lower a batch of annotation strings natively.

    Returns a TraceBatch (same contract as ``pad_traces``), falling back to
    the Python pipeline per program when the native parser reports an
    unsupported construct. With ``questions``, free-text arguments are
    span-linked to question tokens in C++ (utils/agqa_lite.py:62-119
    semantics via the text.py fallback rules); without, they lower to the
    whole-question mean. Returns None if the native library is unavailable.
    """
    lib = parser_lib()
    if lib is None:
        return None
    B = len(programs)
    blob, offsets = _pack_strings(programs)
    q_blob, q_offsets = (
        _pack_strings(questions) if questions is not None else (None, None)
    )
    nf = len(_INT_FIELDS)
    fields3 = np.zeros((B, max_steps, nf), np.int32)
    supervised = np.zeros((B, max_steps), np.uint8)
    meta = np.zeros((B, 6), np.int32)
    ok = np.zeros((B,), np.uint8)
    lib.stair_parse_lower_batch(
        blob, offsets, q_blob,
        q_offsets.ctypes.data if q_offsets is not None else None,
        B, max_steps, 1 if aux_missing else 0,
        fields3, supervised, meta, ok,
        threads or DEFAULT_THREADS,
    )

    scratch_cols = (
        (_F_OUT_VEC, num_vec), (_F_OUT_FRAMES, num_frames),
        (_F_OUT_ATTN, num_attn), (_F_OUT_ATTN_B, num_attn),
    )
    fits = (
        ok.astype(bool)
        & (meta[:, 1] <= num_vec)
        & (meta[:, 2] <= num_frames)
        & (meta[:, 3] <= num_attn)
    )
    for b in np.nonzero(~fits)[0]:
        # Python fallback (also raises clean errors on bad programs).
        parsed = parse_nmn_program(programs[b])
        span_by_word = None
        if questions is not None:
            span_by_word, _ = link_program_spans(
                parsed.tokens, questions[b]
            )
        tr = lower_program(
            parsed.tokens, parsed.source_index, span_by_word or {},
            aux_text_for_missing_spans=aux_missing,
        )
        T = len(tr.instrs)
        if T > max_steps:
            raise ValueError(f"trace has {T} steps > max_steps={max_steps}")
        # Enforce the pad_traces capacity contract (lowering.py): register
        # indices beyond the configured capacities would be silently clamped
        # by gathers downstream.
        for kind, need, cap in (("vec", tr.num_vec, num_vec),
                                ("frames", tr.num_frames, num_frames),
                                ("attn", tr.num_attn, num_attn)):
            if need > cap:
                raise ValueError(
                    f"trace needs {need} {kind} registers > capacity {cap}"
                )
        fields3[b, :T] = tr.field_matrix()
        supervised[b, :T] = [ins.supervised for ins in tr.instrs]
        meta[b] = (T, tr.num_vec, tr.num_frames, tr.num_attn,
                   tr.root_reg, 1 if tr.root_kind.value == "vec" else 0)

    num_steps = meta[:, 0].astype(np.int32)
    step_mask = np.arange(max_steps)[None, :] < num_steps[:, None]
    pad = ~step_mask
    supervised[pad] = 0
    fields3[pad] = 0
    fields3[:, :, _F_SPAN_START][pad] = -1
    fields3[:, :, _F_SPAN_END][pad] = -1
    fields3[:, :, _F_SRC][pad] = -1
    for col, idx in scratch_cols:
        c = fields3[:, :, col]
        c[pad] = idx
        c[c == -1] = idx  # resolve scratch sentinels
    root_is_vec = meta[:, 5].astype(bool)
    root_reg = meta[:, 4].astype(np.int32)

    fields = {
        name: np.ascontiguousarray(fields3[:, :, i])
        for i, name in enumerate(_INT_FIELDS)
    }
    return TraceBatch(
        fields=fields,
        step_mask=step_mask,
        supervised=supervised.astype(bool),
        root_is_vec=root_is_vec,
        root_reg=root_reg,
        num_steps=num_steps,
    )


def windowed(iterable, depth: int = 4):
    """Yield from ``iterable`` keeping at most ``depth`` items materialized
    ahead of the consumer.

    Used to bound async-dispatched device work: a plain list comprehension
    over dispatched eval steps would put every batch's inputs/outputs in
    flight at once (the whole split resident on device); a per-item fetch
    serializes a device round trip into each iteration. A window keeps the
    pipeline full without unbounded residency.
    """
    from collections import deque

    buf = deque()
    for item in iterable:
        buf.append(item)
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def device_prefetch(batches, device):
    """Iterate ``batches`` (dicts of numpy arrays, or tuples and nested
    dicts of them) as the same structures with every array a tensor on
    ``device``, prepared one batch ahead on a worker thread. For a CUDA
    device the worker pins each array and starts its host-to-device copy on
    a side stream, so the copy overlaps the previous step; the consumer's
    stream waits for the copy's event before the batch is handed out.
    Values that are not arrays pass through."""
    import torch

    device = torch.device(device)
    on_card = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_card else None

    def put(v):
        if isinstance(v, dict):
            return {k: put(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(put(x) for x in v)
        if not isinstance(v, np.ndarray):
            return v
        t = torch.from_numpy(np.ascontiguousarray(v))
        if on_card:
            t = t.pin_memory().to(device, non_blocking=True)
        return t

    def tensors(v):
        if isinstance(v, dict):
            v = tuple(v.values())
        if isinstance(v, tuple):
            for x in v:
                yield from tensors(x)
        elif torch.is_tensor(v):
            yield v

    def worker():
        for b in batches:
            if not on_card:
                yield put(b), None
                continue
            with torch.cuda.stream(side):
                out = put(b)
                done = torch.cuda.Event()
                done.record(side)
            yield out, done

    def consume():
        for out, done in PrefetchIterator(worker()):
            if done is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(done)
                for t in tensors(out):
                    t.record_stream(cur)
            yield out

    return consume()


class PrefetchIterator:
    """Run a batch generator on a background thread with a bounded queue."""

    _DONE = object()

    def __init__(self, generator, depth: int = 2):
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self.error = None

        def worker():
            try:
                for item in generator:
                    self.queue.put(item)
            except BaseException as err:  # propagate to the consumer
                self.error = err
            finally:
                self.queue.put(self._DONE)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queue.get()
        if item is self._DONE:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item
