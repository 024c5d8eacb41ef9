"""Symbolic executor over spatio-temporal scene graphs.

A scene graph (AGQA/Charades format) maps node keys to node dicts:

  * frame nodes   — keys starting ``'0'`` (zero-padded frame numbers), with a
    ``'secs'`` timestamp;
  * action nodes  — keys starting ``'c'`` (Charades action ids, possibly
    ``'cXXX/...'``), with ``'charades'``/``'verb_id'``/``'object_id'``/
    ``'phrase'``/``'start'``/``'end'``/``'all_f'`` fields;
  * object nodes  — keys ``'o<classid>/<frame>'`` with a ``'class'`` field;
  * relation nodes — keys ``'r.../<frame>'`` or ``'v.../<frame>'`` with
    ``'objects'`` lists.

The executor interprets the *symbolic* program (postfix, read right-to-left)
over one video's graph and records every op's intermediate result keyed by the
op's source-token index. Those records — frame intervals, class-name lists,
booleans — are the gold supervision for the neural modules ("auditable
intermediate results"). Semantics follow yellow-binary-tree/STAIR
``utils/scene_graphs.py:36-558``; implementation is original. The port's own
copy of ``stair_tpu/programs/scene_graph.py``.
"""

from __future__ import annotations

import json
import pickle
from functools import partial

# ---------------------------------------------------------------------------
# Symbolic-level program parsing
# ---------------------------------------------------------------------------

#: Arities at the symbolic level: Temporal exists natively (arity 2 — mode +
#: intervals), Localize is 1-ary after the decoupling rewrite.
#: ref: utils/scene_graphs.py:12-27
SG_ARITY: dict[str, int] = {
    "Array1": 1, "HasItem": 1, "OnlyItem": 1, "Localizenew": 1, "Localize": 1,
    "Array2": 2, "AND": 2, "XOR": 2, "And": 2, "Xor": 2, "Compare": 2,
    "Equals": 2, "Exists": 2, "Filter": 2, "Iterate": 2, "ToAction": 2,
    "Query": 2, "Subtract": 2, "Temporal": 2,
    "Array3": 3, "Superlative": 3, "Choose": 3,
    "IterateUntil": 4,
}

SG_KEYWORDS = frozenset({
    "forward", "backward", "while", "temporal tag", "between", "before",
    "after", "max", "min", "start", "end", "video", "frame", "relations",
    "objects", "class", "actions",
})


def parse_sg_program(string: str) -> tuple[list[str], list[int | None]]:
    """Tokenize an annotation into the symbolic program + source indices.

    Lighter rewrite than the neural one: only op renames plus the
    Localize decoupling ``Localize(mode, act) -> Temporal(mode, Localize(act))``
    (no ``video`` operand at this level). ref: utils/scene_graphs.py:36-83
    """
    from stair_tpu_torch.programs.parser import tokenize_annotation

    tokens = tokenize_annotation(string)
    prog: list[list] = [[t, i] for i, t in enumerate(tokens)]
    i = 0
    while i < len(prog):
        tok = prog[i][0]
        if tok == "XOR":
            prog[i][0] = "Xor"
        elif tok == "AND":
            prog[i][0] = "And"
        elif tok == "relation":
            prog[i][0] = "relations"
        elif tok == "Localize":
            mode_src = prog[i + 1][1]
            prog[i + 1][1] = None
            prog[i][0] = "Temporal"
            prog.insert(i + 2, ["Localize", mode_src])
            i += 3
            continue
        i += 1
    return [c[0] for c in prog], [c[1] for c in prog]


# ---------------------------------------------------------------------------
# Frame intervals
# ---------------------------------------------------------------------------

class FrameInterval:
    """A closed integer frame range [start, end] (auto-ordered).
    ref: utils/scene_graphs.py:104-128"""

    __slots__ = ("start", "end")

    def __init__(self, start, end):
        start, end = int(start), int(end)
        self.start, self.end = (start, end) if start < end else (end, start)

    def has_frame(self, frame) -> bool:
        return self.start <= int(frame) <= self.end

    def length(self) -> int:
        return self.end - self.start

    def rescaled(self, old_fps: float, new_fps: float) -> tuple[float, float]:
        """The interval in a different frame rate, as a float tuple."""
        return (self.start * new_fps / old_fps, self.end * new_fps / old_fps)

    def __eq__(self, other):
        return (
            isinstance(other, FrameInterval)
            and (self.start, self.end) == (other.start, other.end)
        )

    def __repr__(self):
        return f"FrameInterval({self.start}, {self.end})"


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

class SceneGraphExecutor:
    """Interprets symbolic programs over scene graphs.

    Parameters
    ----------
    graphs:
        A dict of ``video_id -> scene_graph``, a pickle filename holding one,
        or a list of such filenames (merged).
    id2word / word2id:
        Vocabulary mapping class ids to surface strings and back; filenames of
        JSON files or already-loaded dicts. Underscores in surface strings are
        normalized to spaces.
    output_fps:
        Frame rate that all emitted FrameIntervals are rescaled to
        (the reference emits supervision at 3 fps).
    """

    def __init__(self, graphs, id2word, word2id, output_fps: float = 3):
        self.graphs = self._load_graphs(graphs)
        self.id2word = {
            k: v.replace("_", " ") for k, v in self._load_json(id2word).items()
        }
        self.word2id = {
            k.replace("_", " "): v for k, v in self._load_json(word2id).items()
        }
        self.output_fps = output_fps
        # Mean frames-per-second of each video, from frame-node timestamps.
        # ref: utils/scene_graphs.py:148-157
        self.frame_rates: dict[str, float] = {}
        for vid, graph in self.graphs.items():
            rates = [
                int(key) / graph[key]["secs"]
                for key in graph
                if key.startswith("0")
            ]
            self.frame_rates[vid] = sum(rates) / len(rates)

    @staticmethod
    def _load_graphs(graphs):
        if isinstance(graphs, str):
            with open(graphs, "rb") as f:
                return pickle.load(f)
        if isinstance(graphs, list):
            merged = {}
            for fname in graphs:
                with open(fname, "rb") as f:
                    merged.update(pickle.load(f))
            return merged
        return graphs

    @staticmethod
    def _load_json(obj):
        if isinstance(obj, str):
            with open(obj) as f:
                return json.load(f)
        return obj

    # -- graph views ---------------------------------------------------------

    def _bind(self, video_id: str) -> None:
        g = self.graphs[video_id]
        self._g = g
        self._frames = sorted(
            (k for k in g if k.startswith("0")), key=lambda k: k[-6:]
        )
        self._actions = [k for k in g if k.startswith("c")]
        self._objects = sorted(
            (k for k in g if k.startswith("o")), key=lambda k: k[-6:]
        )
        self._relations = sorted(
            (k for k in g if k.startswith(("r", "v"))), key=lambda k: k[-6:]
        )
        self._nodes = {
            "frames": self._frames, "actions": self._actions,
            "objects": self._objects, "relations": self._relations,
        }

    # -- top-level call ------------------------------------------------------

    def run(
        self,
        video_id: str,
        program: str | None = None,
        tokens: list[str] | None = None,
        source_index: list[int | None] | None = None,
        frame_source_indices: list[int] | None = None,
        existsframe_to_filterframe: dict[int, int] | None = None,
    ):
        """Execute a program; return (answer, step_results, video_metadata).

        ``step_results`` maps each op's source index to its symbolic value
        (FrameIntervals rescaled to ``output_fps``). When
        ``frame_source_indices`` marks Filter ops that the neural side turned
        into FilterFrame, the per-class occurrence intervals are recorded
        instead; Exists ops listed in ``existsframe_to_filterframe`` record
        the matching interval for their query (ExistsFrame supervision).
        ref: utils/scene_graphs.py:187-255
        """
        self._bind(video_id)
        if tokens is None:
            tokens, source_index = parse_sg_program(program)
        fps = self.frame_rates[video_id]
        frame_set = set(frame_source_indices or ())
        ef_ff = existsframe_to_filterframe or {}

        stack: list = []
        steps: dict[int, object] = {}
        for tok, src in zip(reversed(tokens), reversed(source_index)):
            if tok not in SG_ARITY:
                stack.append(tok.replace("_", " "))
                continue
            args = [stack.pop() for _ in range(SG_ARITY[tok])]
            value = self._dispatch(tok, args)
            stack.append(value)
            if src is None:
                continue
            if tok == "Filter" and src in frame_set:
                # The neural side sees a FilterFrame here: record per-class
                # occurrence intervals over the whole video.
                occ = self._class_occurrence_intervals(args[1])
                steps[src] = {
                    name: iv.rescaled(fps, self.output_fps)
                    for name, iv in occ.items()
                }
            elif tok == "Exists" and src in ef_ff:
                table = steps[ef_ff[src]]
                steps[src] = table.get(args[0])
            else:
                if isinstance(value, FrameInterval):
                    steps[src] = value.rescaled(fps, self.output_fps)
                elif isinstance(value, tuple) and value and isinstance(
                    value[0], FrameInterval
                ):
                    steps[src] = [
                        v.rescaled(fps, self.output_fps) for v in value
                    ]
                else:
                    steps[src] = value

        if len(stack) != 1:
            raise ValueError("program left %d values on the stack" % len(stack))
        result = stack[0]
        answer = "yes" if result is True else "no" if result is False else result
        return answer, steps, {"frame_rate": fps}

    # -- op implementations ----------------------------------------------------

    def _dispatch(self, op: str, args: list):
        return getattr(self, "_op_" + op.lower().replace("array1", "array")
                       .replace("array2", "array").replace("array3", "array"))(*args)

    def _op_array(self, *items):
        return tuple(items)

    def _op_and(self, a, b):
        return a and b

    def _op_xor(self, a, b):
        # Either operand may be a pending per-frame predicate (a callable);
        # the Xor then becomes a per-frame predicate itself.
        if callable(a) and callable(b):
            return lambda frame: self._xor_bool(a(frame), b(frame))
        if callable(a):
            return partial(self._op_xor, b=b)
        if callable(b):
            return partial(self._op_xor, b=a)
        return self._xor_bool(a, b)

    @staticmethod
    def _xor_bool(a, b):
        return (a and not b) or (not a and b)

    def _op_choose(self, cand1, cand2, pool):
        return cand1 if cand1 in pool else cand2

    def _op_compare(self, items, pred):
        for item in items:
            if pred(item):
                return item
        return None

    def _op_equals(self, a, b):
        return a == b

    def _op_exists(self, item, pool):
        if callable(pool):
            return lambda frame: item in pool(frame)
        return item in pool

    def _op_localize(self, action):
        """Occurrence interval(s) of one action (or a pair)."""
        if isinstance(action, tuple):
            return tuple(self._action_interval(a) for a in action)
        return (self._action_interval(action),)

    def _action_interval(self, action_phrase: str) -> FrameInterval:
        aid = self.word2id[action_phrase]
        for key in self._actions:
            node = self._g[key]
            if node["charades"] == aid:
                return FrameInterval(node["all_f"][0], node["all_f"][-1])
        raise ValueError("action not found: %r" % action_phrase)

    def _op_temporal(self, mode, intervals):
        if mode == "temporal tag":
            return partial(self._op_temporal, intervals=intervals)
        if mode == "between":
            a, b = intervals[0], intervals[1]
            if a.end <= b.start:
                return FrameInterval(a.end + 1, b.start - 1)
            return FrameInterval(b.end + 1, a.start - 1)
        if mode == "before":
            return FrameInterval(0, intervals[0].start - 1)
        if mode == "after":
            return FrameInterval(intervals[0].end + 1, 999999)
        if mode == "while":
            return intervals[0]
        raise ValueError("bad temporal mode %r" % mode)

    def _op_filter(self, scope, query):
        if scope == "frame":
            return partial(self._filter_in_frame, query=query)
        if len(query) == 1:
            return [self._g[k] for k in self._nodes[query[0]]]
        # Filter(actions, (actions, phrase)) — match action phrases.
        if query[0] != "actions":
            raise ValueError("unsupported filter query %r" % (query,))
        hits = [
            self._g[k]["phrase"]
            for k in self._actions
            if self._g[k]["phrase"] == query[1]
        ]
        return list(set(hits))

    def _filter_in_frame(self, frame: str, query: tuple):
        """Class names present in one frame matching the query."""
        hits: list[str] = []
        if len(query) == 1:
            kind = query[0]
            if kind in ("objects", "relations"):
                for key in self._nodes[kind]:
                    if key.endswith(frame):
                        hits.append(self.id2word[self._g[key]["class"]])
            else:  # actions: active if the frame falls inside [first, last]
                for key in self._actions:
                    node = self._g[key]
                    if node["all_f"][0] <= frame <= node["all_f"][-1]:
                        hits.append(node["phrase"])
        else:
            # (relations, <rel>, objects): objects linked by <rel> this frame.
            if len(query) != 3 or query[0] != "relations" or query[2] != "objects":
                raise ValueError("unsupported frame query %r" % (query,))
            rel_id = self.word2id[query[1]]
            for key in self._relations:
                if key.endswith(frame) and key.split("/")[0] == rel_id:
                    for obj in self._g[key]["objects"]:
                        hits.append(self.id2word[obj["class"]])
        return list(set(hits))

    def _op_iterate(self, scope, fn):
        if callable(scope):
            return lambda frame: self._op_iterate(scope(frame), fn)
        if scope == "video":
            scope = FrameInterval(self._frames[0], self._frames[-1])
        acc: list = []
        for frame in self._frames:
            if scope.has_frame(frame):
                acc.extend(fn(frame))
        return list(set(acc))

    def _op_hasitem(self, items):
        if callable(items):
            return self._op_hasitem
        return len(items) > 0

    def _op_onlyitem(self, items):
        return items[0]

    def _op_query(self, mode, item):
        if mode == "class":
            return item
        return partial(self._action_endpoint, mode=mode)

    def _action_endpoint(self, action_phrase: str, mode: str):
        first = last = None
        for key in self._actions:
            node = self._g[key]
            if node["phrase"] == action_phrase:
                first, last = node["all_f"][0], node["all_f"][-1]
        return first if mode == "start" else last

    def _op_subtract(self, fn1, fn2):
        def length(action):
            return FrameInterval(fn1(action), fn2(action)).length()
        return length

    def _op_superlative(self, mode, items, fn):
        pool: list[str] = []
        for item in items:
            if isinstance(item, (tuple, list)):
                pool.extend(item)
            elif isinstance(item, str):
                pool.append(item)
            else:  # a node dict
                pool.append(item["phrase"])
        scores = [fn(item) for item in pool]
        if mode == "min":
            scores = [-s for s in scores]
        best = max(range(len(scores)), key=lambda i: scores[i])
        return pool[best]

    def _op_iterateuntil(self, direction, scope, pred, fn):
        if scope == "video":
            scope = FrameInterval(self._frames[0], self._frames[-1])
        frames = self._frames if direction == "forward" else self._frames[::-1]
        for frame in frames:
            if scope.has_frame(frame) and pred(frame):
                return fn(frame)
        raise ValueError("IterateUntil found no matching frame")

    def _op_toaction(self, verb, obj):
        vid = self.word2id.get(verb)
        oid = self.word2id.get(obj)
        for key in self._actions:
            node = self._g[key]
            if node["verb_id"] == vid and node["object_id"] == oid:
                return node["phrase"]
        raise ValueError("no action composed of %r + %r" % (verb, obj))

    def _op_localizenew(self, action):
        return self._op_localize(action)

    # -- FilterFrame-style supervision ---------------------------------------

    def _class_occurrence_intervals(self, query: tuple) -> dict[str, FrameInterval]:
        """First-to-last occurrence interval of every class matching ``query``.
        ref: utils/scene_graphs.py:494-541"""
        out: dict[str, FrameInterval] = {}
        if len(query) == 1:
            kind = query[0]
            if kind in ("objects", "relations"):
                by_class: dict[str, list[int]] = {}
                for key in self._nodes[kind]:
                    class_id, frame = key.split("/")
                    by_class.setdefault(class_id, []).append(int(frame))
                for class_id, frames in by_class.items():
                    out[self.id2word[class_id]] = FrameInterval(
                        min(frames), max(frames)
                    )
            else:  # actions
                for key in self._actions:
                    node = self._g[key]
                    out[node["phrase"]] = FrameInterval(
                        node["start"], node["end"]
                    )
        else:
            if len(query) != 3 or query[0] != "relations" or query[2] != "objects":
                raise ValueError("unsupported query %r" % (query,))
            rel_id = self.word2id[query[1]]
            wanted: set[str] = set()
            for key in self._relations:
                if key.split("/")[0] == rel_id:
                    for obj in self._g[key]["objects"]:
                        wanted.add(obj["class"])
            by_class = {cid: [] for cid in wanted}
            for key in self._objects:
                class_id, frame = key.split("/")
                if class_id in wanted:
                    by_class[class_id].append(int(frame))
            for class_id, frames in by_class.items():
                out[self.id2word[class_id]] = FrameInterval(
                    min(frames), max(frames)
                )
        return out
