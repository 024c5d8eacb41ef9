"""AGQA annotation -> neural-program rewriter.

An AGQA question annotation carries a LISP-ish program string such as::

    XOR(Exists(food, Iterate(Localize(between, [a, b]), Filter(frame, [...]))),
        ...)

This module tokenizes that string into a *prefix* token list (postfix when read
right-to-left, which is how every executor in this framework consumes it) and
rewrites symbolic-level ops into the neural module set:

  * ``OnlyItem`` / ``Array1``                  -> elided
  * ``Query(class, X)``                        -> ``X``
  * ``Subtract(Query(end,a), Query(start,a))`` -> ``video``
  * ``Localize(mode, act)``   -> ``Temporal(mode, video, Localize(video, act))``
  * ``Iterate(items, Filter(frame, q))``       -> ``Filter(items, q)``
  * ``IterateUntil(...)``  -> a ``Filter/AttnVideo/Relate`` block with
    per-frame variants (``ExistsFrame``/``FilterFrame``/``XorFrame``)
  * ``Compare(...)``  -> program duplicated with ``before``/``after`` tags

Every output token keeps a pointer (``source_index``) into the original token
list so per-step supervision produced by the symbolic scene-graph executor
(``programs/scene_graph.py`` of the JAX package; not copied into the port
yet) can be joined back onto neural module outputs. This is the port's own
copy of ``stair_tpu/programs/parser.py``. Semantics follow the reference implementation
(yellow-binary-tree/STAIR ``utils/program_parser.py:28-333``) so that
reference-produced pickles remain loadable; the implementation is original.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# Vocabulary and arities
# ---------------------------------------------------------------------------

#: Reserved keywords that appear as literal program arguments.
KEYWORDS = frozenset({
    "forward", "backward", "while", "temporal_tag", "between", "before",
    "after", "max", "min", "start", "end", "video", "frame", "relations",
    "objects", "class", "actions",
})

#: Arity of each op at annotation (pre-rewrite) level.
#: ref: utils/program_parser.py:8-14
PARSE_ARITY: dict[str, int] = {
    "Array1": 1, "HasItem": 1, "OnlyItem": 1,
    "Array2": 2, "AND": 2, "XOR": 2, "And": 2, "Xor": 2, "Compare": 2,
    "Equals": 2, "Exists": 2, "Filter": 2, "Iterate": 2, "Localize": 2,
    "ToAction": 2, "Query": 2, "Subtract": 2,
    "Array3": 3, "Superlative": 3, "Choose": 3,
    "IterateUntil": 4,
}

#: Arity of each op at neural (post-rewrite) level. ``Localize`` becomes a
#: 2-ary frame-attention op, ``Temporal`` is introduced as 3-ary, and the
#: per-frame module variants appear. ref: utils/program_parser.py:16-23
NMN_ARITY: dict[str, int] = dict(PARSE_ARITY)
NMN_ARITY.update({
    "Query": 1,
    "Relate": 2, "AttnVideo": 2, "FilterFrame": 2, "ExistsFrame": 2,
    "XorFrame": 2, "Temporal": 3,
})
del NMN_ARITY["Subtract"]

ALL_RESERVED = KEYWORDS | set(NMN_ARITY)


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------

def tokenize_annotation(string: str) -> list[str]:
    """Flatten an annotation string into prefix tokens.

    Multi-word arguments become single underscore-joined tokens; a bracketed
    list ``[x, y, ...]`` becomes an ``ArrayN`` head whose N counts *top-level*
    items (nested ops inside the list consume their own arguments).
    ref: utils/program_parser.py:40-60
    """
    s = string.replace(", ", ";").replace(" ", "_")
    s = s.replace("(", ";").replace(")", "")
    s = s.replace("[", "[;").replace("]", ";]")
    tokens = [t for t in s.split(";")]

    # Resolve brackets innermost-first into ArrayN heads.
    out: list[str] = []
    open_stack: list[int] = []
    for tok in tokens:
        if tok == "[":
            open_stack.append(len(out))
            out.append(tok)  # placeholder, patched on close
        elif tok == "]":
            start = open_stack.pop()
            inner = out[start + 1:]
            # Top-level item count: each op token consumes `arity` operands.
            n_items = len(inner) - sum(
                PARSE_ARITY.get(t, 0) for t in inner
            )
            out[start] = "Array%d" % n_items
        else:
            out.append(tok)
    return out


# ---------------------------------------------------------------------------
# Stack/tree utilities (shared by parser, IR lowering and audits)
# ---------------------------------------------------------------------------

def children_and_parents(
    tokens: list[str], arity: dict[str, int] | None = None
) -> tuple[list[list[int]], list[int]]:
    """Per-position child positions and parent position of a prefix program.

    Children are listed in argument order. The root's parent is 0.
    ref: utils/program_parser.py:182-200
    """
    arity = NMN_ARITY if arity is None else arity
    kids: list[list[int]] = [[] for _ in tokens]
    parent = [0] * len(tokens)
    stack: list[int] = []
    for pos in range(len(tokens) - 1, -1, -1):
        tok = tokens[pos]
        if tok in arity:
            for _ in range(arity[tok]):
                kids[pos].append(stack.pop())
            stack.append(pos)
        else:
            stack.append(pos)
    for pos, ks in enumerate(kids):
        for k in ks:
            parent[k] = pos
    return kids, parent


def subtree_positions(kids: list[list[int]], pos: int) -> list[int]:
    """All positions in the subtree rooted at ``pos``, sorted ascending.
    ref: utils/program_parser.py:173-179"""
    acc = [pos]
    frontier = list(kids[pos])
    while frontier:
        p = frontier.pop()
        acc.append(p)
        frontier.extend(kids[p])
    acc.sort()
    return acc


def module_levels(tokens: list[str], arity: dict[str, int] | None = None) -> list[int]:
    """Tree depth of every token: leaves are 0, each op is 1 + max(children).
    ref: utils/program_parser.py:307-321"""
    arity = NMN_ARITY if arity is None else arity
    levels = [0] * len(tokens)
    stack: list[int] = []
    for pos in range(len(tokens) - 1, -1, -1):
        tok = tokens[pos]
        if tok in arity:
            args = [stack.pop() for _ in range(arity[tok])]
            lvl = max(args) + 1
            stack.append(lvl)
            levels[pos] = lvl
        else:
            stack.append(0)
    return levels


def program_is_valid(tokens: list[str], arity: dict[str, int] | None = None) -> bool:
    """Check stack discipline: reading right-to-left must end with depth 1.
    ref: utils/program_parser.py:324-333"""
    arity = NMN_ARITY if arity is None else arity
    depth = 0
    for tok in reversed(tokens):
        depth += 1 - arity.get(tok, 0)
        if depth < 0:
            return False
    return depth == 1


def visualize(tokens: list[str], arity: dict[str, int] | None = None) -> str:
    """Indented rendering of a prefix program, for debugging/audit output."""
    arity = NMN_ARITY if arity is None else arity
    lines, pending = [], []
    for tok in tokens:
        lines.append("    " * len(pending) + tok)
        if pending:
            pending[-1] -= 1
        if tok in arity:
            pending.append(arity[tok])
        while pending and pending[-1] == 0:
            pending.pop()
    return "\n".join(lines)


def op_signatures(tokens: list[str], arity: dict[str, int] | None = None):
    """For every op, the tuple of argument kinds it receives (keywords kept,
    free text collapsed to 'string'). Used by program audits.
    ref: utils/program_parser.py:266-282"""
    arity = NMN_ARITY if arity is None else arity
    sigs: dict[str, list[tuple[str, ...]]] = {op: [] for op in arity}
    stack: list[str] = []
    for tok in reversed(tokens):
        if tok in arity:
            args = tuple(
                a if a in (KEYWORDS | set(arity)) else "string"
                for a in (stack.pop() for _ in range(arity[tok]))
            )
            sigs[tok].append(args)
            stack.append(tok)
        else:
            stack.append(tok)
    return sigs


# ---------------------------------------------------------------------------
# The rewriter
# ---------------------------------------------------------------------------

@dataclass
class ParsedProgram:
    """A rewritten neural program plus provenance metadata."""

    tokens: list[str]
    #: For each output token, the index of the original token it derives from
    #: (None for synthesized tokens). Joins neural steps to symbolic
    #: supervision. ref "idx_list": utils/program_parser.py:166
    source_index: list[int | None]
    #: Maps source-index of an ``Exists`` op that became ``ExistsFrame`` to the
    #: source-index of the ``Filter`` that became its ``FilterFrame`` input.
    existsframe_to_filterframe: dict[int, int] = field(default_factory=dict)
    #: The original flattened token list (the shared index space).
    source_tokens: list[str] = field(default_factory=list)


def parse_nmn_program(string: str) -> ParsedProgram:
    """Tokenize and rewrite an annotation string into a neural program."""
    source_tokens = tokenize_annotation(string)
    # Work list of [token, source_index] cells.
    prog: list[list] = [[tok, i] for i, tok in enumerate(source_tokens)]

    prog, iterate_marks = _linear_rewrites(prog)
    if iterate_marks:
        prog = _rewrite_iterate(prog, iterate_marks)
    ef_ff_map: dict[int, int] = {}
    if any(cell[0] == "IterateUntil" for cell in prog):
        prog, ef_ff_map = _rewrite_iterate_until(prog)
    if prog and prog[0][0] == "Compare":
        prog = _rewrite_compare(prog)

    return ParsedProgram(
        tokens=[c[0] for c in prog],
        source_index=[c[1] for c in prog],
        existsframe_to_filterframe=ef_ff_map,
        source_tokens=source_tokens,
    )


def _linear_rewrites(prog: list[list]) -> tuple[list[list], list[int]]:
    """Single left-to-right pass of local rewrites.
    ref: utils/program_parser.py:67-123"""
    iterate_marks: list[int] = []
    i = 0
    while i < len(prog):
        tok = prog[i][0]
        if tok == "OnlyItem" or tok == "Array1":
            del prog[i]
            continue
        if tok == "XOR":
            prog[i][0] = "Xor"
        elif tok == "AND":
            prog[i][0] = "And"
        elif tok == "relation":
            prog[i][0] = "relations"
        elif tok == "Query" and i + 1 < len(prog) and prog[i + 1][0] == "class":
            # Query(class, X) -> X
            del prog[i:i + 2]
            continue
        elif tok == "Subtract":
            # Subtract(Query(end, a), Query(start, a)) -> the whole video.
            del prog[i + 1:i + 7]
            prog[i] = ["video", None]
        elif tok == "Iterate":
            iterate_marks.append(i)
        elif tok == "Localize":
            # Localize(mode, act) -> Temporal(mode, video, Localize(video, act))
            # The synthesized Localize inherits the *mode token's* source index
            # (and the mode keeps its slot with index cleared) so that the
            # symbolic side, which applies the same move, stays join-able.
            mode_src = prog[i + 1][1]
            prog[i + 1][1] = None
            prog[i][0] = "Temporal"
            prog[i + 2:i + 2] = [
                ["video", None], ["Localize", mode_src], ["video", None],
            ]
            i += 4
            continue
        elif tok == "Array3":
            # Array3(relations, x, objects) -> x
            del prog[i + 3]
            del prog[i + 1]
            del prog[i]
            continue
        elif tok == "Array2" and i + 1 < len(prog) and prog[i + 1][0] == "actions":
            # Array2(actions, x) -> x
            del prog[i:i + 2]
            continue
        elif tok == "Superlative" and i + 2 < len(prog) and prog[i + 2][0] == "Filter":
            prog[i + 2][0] = "FilterFrame"
        i += 1
    return prog, iterate_marks


def _rewrite_iterate(prog: list[list], marks: list[int]) -> list[list]:
    """Iterate(items, Filter(frame, q)) -> Filter(items, q).
    ref: utils/program_parser.py:126-140"""
    kids, _ = children_and_parents([c[0] for c in prog])
    dead: set[int] = set()
    for pos in marks:
        prog[pos][0] = "Filter"
        inner_filter = kids[pos][1]     # the Filter(frame, ...) argument
        dead.add(inner_filter)          # drop its 'Filter' head ...
        dead.add(inner_filter + 1)      # ... and its 'frame' keyword
    return [c for p, c in enumerate(prog) if p not in dead]


def _rewrite_iterate_until(prog: list[list]) -> tuple[list[list], dict[int, int]]:
    """Expand every IterateUntil block into a Filter/AttnVideo/Relate block.

    ``IterateUntil(direction, items, bool_fn, Filter(frame, query))`` walks
    frames in ``direction`` over ``items`` until ``bool_fn`` holds, then
    applies the filter. Neurally this becomes::

        Filter(AttnVideo(<items>, Relate(direction, <bool_fn per-frame>)),
               <query>)

    where inside ``bool_fn``: ``frame`` -> ``video``, ``Filter(frame, q)`` ->
    ``FilterFrame(video, q)``, an ``Exists`` over such a filter ->
    ``ExistsFrame``, ``Xor`` -> ``XorFrame``. Nested blocks are expanded
    innermost-first. ref: utils/program_parser.py:144-263
    """
    ef_ff: dict[int, int] = {}
    while True:
        tokens = [c[0] for c in prog]
        iu_positions = [p for p, t in enumerate(tokens) if t == "IterateUntil"]
        if not iu_positions:
            return prog, ef_ff
        kids, parents = children_and_parents(tokens)
        # Pick the smallest block (innermost) to expand this round.
        blocks = []
        for p in iu_positions:
            span = subtree_positions(kids, p)
            blocks.append((span[0], span[-1] + 1))
        start, end = min(blocks, key=lambda b: b[1] - b[0])

        seg: list[list] = [["Filter", prog[start][1]], ["AttnVideo", None]]
        # Arg 2 (items): copied verbatim.
        items_len = len(subtree_positions(kids, kids[start][1]))
        seg.extend(prog[start + 2:start + 2 + items_len])
        # Arg 3 (bool_fn): becomes Relate(direction, <per-frame bool_fn>).
        seg.extend([["Relate", None], prog[start + 1]])
        for p in subtree_positions(kids, kids[start][2]):
            cell = prog[p]
            if cell[0] == "frame":
                seg.append(["video", cell[1]])
            elif cell[0] == "Filter" and prog[p + 1][0] == "frame":
                if prog[parents[p]][0] == "Exists":
                    # Patch the Exists already emitted (parent precedes child
                    # in prefix order, so it sits `p - parents[p]` cells back).
                    seg[parents[p] - p][0] = "ExistsFrame"
                seg.append(["FilterFrame", cell[1]])
                ef_ff[prog[parents[p]][1]] = cell[1]
            elif cell[0] == "Xor":
                seg.append(["XorFrame", cell[1]])
            else:
                seg.append(cell)
        # Arg 4 (Filter(frame, query)): keep only the query subtree.
        for p in subtree_positions(kids, kids[kids[start][3]][1]):
            seg.append(prog[p])

        if len(seg) != end - start:
            raise ValueError(
                "IterateUntil expansion length mismatch: %d vs %d for %r"
                % (len(seg), end - start, tokens[start:end])
            )
        prog = prog[:start] + seg + prog[end:]


def _rewrite_compare(prog: list[list]) -> list[list]:
    """Compare(Array2(before, after), body) -> Compare(body@before, body@after).

    The Array2(before, after) header is dropped and the remaining body is
    duplicated; the ``temporal_tag`` placeholder becomes ``before`` in the
    first copy and ``after`` in the second. ref: utils/program_parser.py:157-163
    """
    import copy as _copy

    del prog[1:4]
    tag_pos = [c[0] for c in prog].index("temporal_tag")
    body_len = len(prog)
    doubled = _copy.deepcopy(prog) + _copy.deepcopy(prog[1:])
    doubled[tag_pos][0] = "before"
    doubled[tag_pos + body_len - 1][0] = "after"
    return doubled


# ---------------------------------------------------------------------------
# Generated-program cleanup (used when a seq2seq parser emits programs)
# ---------------------------------------------------------------------------

_GENERATED_FIXUPS = {"when": "while", "with": "while"}


def repair_generated_program(tokens: list[str]) -> list[str] | None:
    """Apply keyword fixups to a parser-generated program; None if invalid.
    ref: utils/agqa_lite.py:181-187"""
    fixed = [
        "video" if t.lower() == "next" else _GENERATED_FIXUPS.get(t, t)
        for t in tokens
    ]
    return fixed if program_is_valid(fixed) else None
