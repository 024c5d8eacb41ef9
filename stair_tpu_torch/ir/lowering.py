"""Lower neural programs to fixed-shape instruction traces.

The reference executes programs with a Python stack interpreter dispatching
one tiny module call at a time (yellow-binary-tree/STAIR
``video_nmn/module_net.py:94-133``) — structurally batch-size-1 and hostile
to any compiler. Here the interpreter itself is compiled: at preprocessing
time every program is lowered to a *register machine trace* — a table of
fixed-width instructions over three typed register files:

  * VEC    registers: [H]      — text embeddings, module summary vectors
  * FRAMES registers: [F, H]   — per-frame feature maps (register 0 is
    pinned to the encoded video)
  * ATTN   registers: [F]      — per-frame attention rows

Stack discipline, value kinds, keyword modes and pair structure (``Array2``)
are all resolved **statically** during lowering: keywords become enum fields,
pairs become two operand slots, and every instruction knows exactly which
registers it reads and writes. At runtime a ``lax.scan`` walks the padded
instruction table with a ``switch`` over opcodes; a whole batch of
heterogeneous programs executes as one XLA program (see
``stair_tpu_torch/models/nmn.py``). Because registers are written exactly once
(SSA), the final register files hold every step's output — which is how the
framework preserves STAIR's headline feature, auditable intermediates,
without any per-step Python.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from stair_tpu_torch.programs.parser import NMN_ARITY


class Opcode(enum.IntEnum):
    NOP = 0
    PUSH_TEXT = 1       # span mean of question token features -> vec
    AND_VEC = 2         # elementwise min                       -> vec
    AND_ATTN = 3        # elementwise min                       -> attn
    COMPARE = 4         # relu(W [va;vb])                       -> vec
    EQUALS = 5          # relu(W [va;vb])                       -> vec
    CHOOSE = 6          # cos-sim hard select                   -> vec
    XOR = 7             # relu(W [|va-vb|;va;vb])               -> vec
    XORFRAME = 8        # |aa - ab|                             -> attn
    QUERY = 9           # mlp(va)                               -> vec
    TOACTION = 10       # mlp([va;vb])                          -> vec
    HASITEM = 11        # sigmoid mlp per frame                 -> attn
    EXISTS = 12         # mlp([feat;kw;feat*kw])                -> vec
    EXISTSFRAME = 13    # cos(kw, frames)                       -> attn
    LOCALIZE = 14       # projected cosine attention            -> attn x count
    SUPERLATIVE_V = 15  # soft-argmax over 1-2 action vecs      -> vec
    SUPERLATIVE_F = 16  # soft-argmax over per-frame actions    -> vec
    TEMPORAL = 17       # gated temporal re-weighting           -> frames (+attn aux)
    ATTNVIDEO = 18      # attn[:,None] * frames                 -> frames
    FILTER_V = 19       # attention-pool frames by keyword vec  -> vec
    FILTER_K = 20       # type-keyword MLP + sum-pool           -> vec
    FILTERFRAME_V = 21  # per-frame gate by keyword vec         -> frames
    FILTERFRAME_K = 22  # type-keyword MLP per frame            -> frames
    RELATE = 23         # learned shift + softmax               -> attn


#: Which op family each opcode belongs to (for supervision/loss routing).
OP_FAMILY = {
    Opcode.AND_VEC: "And", Opcode.AND_ATTN: "And", Opcode.COMPARE: "Compare",
    Opcode.EQUALS: "Equals", Opcode.CHOOSE: "Choose", Opcode.XOR: "Xor",
    Opcode.XORFRAME: "XorFrame", Opcode.QUERY: "Query",
    Opcode.TOACTION: "ToAction", Opcode.HASITEM: "HasItem",
    Opcode.EXISTS: "Exists", Opcode.EXISTSFRAME: "ExistsFrame",
    Opcode.LOCALIZE: "Localize", Opcode.SUPERLATIVE_V: "Superlative",
    Opcode.SUPERLATIVE_F: "Superlative", Opcode.TEMPORAL: "Temporal",
    Opcode.ATTNVIDEO: "AttnVideo", Opcode.FILTER_V: "Filter",
    Opcode.FILTER_K: "Filter", Opcode.FILTERFRAME_V: "FilterFrame",
    Opcode.FILTERFRAME_K: "FilterFrame", Opcode.RELATE: "Relate",
}

#: Modules whose intermediate output is supervised by the symbolic executor.
#: ref: train_module.py:36-48 (criterion table)
SUPERVISED_FAMILIES = frozenset({
    "Exists", "Xor", "Equals", "Filter", "ToAction", "FilterFrame",
    "ExistsFrame", "Superlative", "Localize", "Temporal",
})

TEMPORAL_MODES = {"while": 0, "before": 1, "after": 2, "between": 3}
RELATE_MODES = {"forward": 0, "backward": 1}
SUPERLATIVE_MODES = {"max": 0, "min": 1}
TYPE_KEYWORDS = {"actions": 0, "objects": 1, "relations": 2}

#: Keywords that ride the stack as enum values rather than tensors.
#: ref: video_nmn/dataset.py:23, module_net.py:23-25
STACK_KEYWORDS = frozenset(
    set(TEMPORAL_MODES) | set(RELATE_MODES) | set(SUPERLATIVE_MODES)
    | set(TYPE_KEYWORDS) | {"start", "end"}
)


class Kind(enum.Enum):
    VEC = "vec"
    FRAMES = "frames"
    ATTN = "attn"
    KW = "kw"


@dataclass(slots=True)
class _Val:
    """A lowering-time stack value: a kind plus 1-2 backing registers
    (or the keyword string for KW)."""

    kind: Kind
    regs: tuple = ()
    keyword: str | None = None


@dataclass(slots=True)
class Instr:
    opcode: Opcode
    va: int = 0
    vb: int = 0
    vc: int = 0
    fa: int = 0
    fb: int = 0
    aa: int = 0
    ab: int = 0
    mode: int = 0
    count: int = 1
    span_start: int = -1
    span_end: int = -1
    out_vec: int = 0
    out_frames: int = 0
    out_attn: int = 0
    out_attn_b: int = 0
    src: int = -1          # source-token index (supervision join key)
    token_pos: int = -1    # position in the rewritten token list
    supervised: bool = False


#: Scratch-slot sentinel inside cached field matrices, resolved to the
#: configured register-file scratch index at pack time.
_SCRATCH = -1


@dataclass
class Trace:
    """One lowered program."""

    instrs: list[Instr]
    num_vec: int
    num_frames: int
    num_attn: int
    root_kind: Kind
    root_reg: int
    tokens: list[str] = field(default_factory=list)
    _matrix: "np.ndarray | None" = None

    def field_matrix(self) -> "np.ndarray":
        """[T, len(_INT_FIELDS)] int32, cached; unused outputs = _SCRATCH.

        Built once per trace so batch packing is row copies, not per-field
        attribute walks.
        """
        if self._matrix is not None:
            return self._matrix
        mat = np.zeros((len(self.instrs), len(_INT_FIELDS)), np.int32)
        for t, ins in enumerate(self.instrs):
            op = ins.opcode
            for i, name in enumerate(_INT_FIELDS):
                mat[t, i] = getattr(ins, name)
            if op not in _VEC_PRODUCERS:
                mat[t, _F_OUT_VEC] = _SCRATCH
            if op not in _FRAMES_PRODUCERS:
                mat[t, _F_OUT_FRAMES] = _SCRATCH
            if op not in _ATTN_PRODUCERS:
                mat[t, _F_OUT_ATTN] = _SCRATCH
            if not ((op is Opcode.LOCALIZE and ins.count == 2)
                    or op is Opcode.TEMPORAL):
                mat[t, _F_OUT_ATTN_B] = _SCRATCH
        self._matrix = mat
        return mat


class LoweringError(ValueError):
    pass


def lower_program(
    tokens: list[str],
    source_index: list[int | None] | None = None,
    span_by_word: dict | None = None,
    aux_text_for_missing_spans: bool = False,
) -> Trace:
    """Lower a rewritten program (prefix token list) to a Trace.

    ``span_by_word`` maps token positions to question-token spans for
    free-text arguments; a missing/None span lowers to (-1, -1), which the
    executor interprets as "mean over the whole question" (matching the
    reference's ``token_feature[None:None]`` full-slice behavior,
    module_net.py:127-129). With ``aux_text_for_missing_spans`` (the
    --use-prog-word-embeddings path) a missing span lowers to (-2, -2):
    the executor substitutes a text encoding of the program token itself
    (packed per batch as an auxiliary embedding table).
    """
    if source_index is None:
        source_index = [None] * len(tokens)
    span_by_word = span_by_word or {}

    instrs: list[Instr] = []
    stack: list[_Val] = []
    # Register allocators. FRAMES register 0 is pinned to the encoded video.
    next_vec, next_frames, next_attn = [0], [1], [0]

    def alloc(counter: list[int]) -> int:
        counter[0] += 1
        return counter[0] - 1

    def emit(instr: Instr) -> None:
        instrs.append(instr)

    def pop_vec(tok: str) -> int:
        v = stack.pop()
        if v.kind is not Kind.VEC or len(v.regs) != 1:
            raise LoweringError(f"{tok}: expected a vector operand, got {v.kind}/{len(v.regs)}")
        return v.regs[0]

    def pop_frames(tok: str) -> int:
        v = stack.pop()
        if v.kind is not Kind.FRAMES:
            raise LoweringError(f"{tok}: expected a frames operand, got {v.kind}")
        return v.regs[0]

    def pop_kw(tok: str, table: dict) -> int:
        v = stack.pop()
        if v.kind is not Kind.KW or v.keyword not in table:
            raise LoweringError(f"{tok}: expected a keyword in {sorted(table)}, got {v}")
        return table[v.keyword]

    for pos in range(len(tokens) - 1, -1, -1):
        tok = tokens[pos]
        src = source_index[pos]
        src = -1 if src is None else src

        if tok not in NMN_ARITY:
            if tok == "video":
                stack.append(_Val(Kind.FRAMES, (0,)))
            elif tok in STACK_KEYWORDS:
                stack.append(_Val(Kind.KW, keyword=tok))
            else:
                out = alloc(next_vec)
                span = span_by_word.get(pos, (None, None))
                missing = (-2, -2) if aux_text_for_missing_spans else (-1, -1)
                s, e = (span if span and None not in span else missing)
                emit(Instr(Opcode.PUSH_TEXT, span_start=s, span_end=e,
                           out_vec=out, src=src, token_pos=pos))
                stack.append(_Val(Kind.VEC, (out,)))
            continue

        instr = Instr(Opcode.NOP, src=src, token_pos=pos)

        if tok == "Array2":
            a, b = stack.pop(), stack.pop()
            if a.kind is Kind.VEC and b.kind is Kind.VEC:
                stack.append(_Val(Kind.VEC, (a.regs[0], b.regs[0])))
            elif a.kind is Kind.ATTN and b.kind is Kind.ATTN:
                stack.append(_Val(Kind.ATTN, (a.regs[0], b.regs[0])))
            else:
                raise LoweringError(f"Array2 over {a.kind}/{b.kind} unsupported")
            continue

        if tok in ("And", "Xor"):
            a, b = stack.pop(), stack.pop()
            if a.kind is Kind.VEC and b.kind is Kind.VEC:
                instr.opcode = Opcode.AND_VEC if tok == "And" else Opcode.XOR
                instr.va, instr.vb = a.regs[0], b.regs[0]
                instr.out_vec = alloc(next_vec)
                stack.append(_Val(Kind.VEC, (instr.out_vec,)))
            elif a.kind is Kind.ATTN and b.kind is Kind.ATTN:
                instr.opcode = Opcode.AND_ATTN if tok == "And" else Opcode.XORFRAME
                instr.aa, instr.ab = a.regs[0], b.regs[0]
                instr.out_attn = alloc(next_attn)
                stack.append(_Val(Kind.ATTN, (instr.out_attn,)))
            else:
                raise LoweringError(f"{tok} over {a.kind}/{b.kind} unsupported")
        elif tok == "XorFrame":
            a, b = stack.pop(), stack.pop()
            if a.kind is not Kind.ATTN or b.kind is not Kind.ATTN:
                raise LoweringError(f"XorFrame over {a.kind}/{b.kind} unsupported")
            instr.opcode = Opcode.XORFRAME
            instr.aa, instr.ab = a.regs[0], b.regs[0]
            instr.out_attn = alloc(next_attn)
            stack.append(_Val(Kind.ATTN, (instr.out_attn,)))
        elif tok in ("Compare", "Equals", "ToAction"):
            instr.opcode = {"Compare": Opcode.COMPARE, "Equals": Opcode.EQUALS,
                            "ToAction": Opcode.TOACTION}[tok]
            instr.va = pop_vec(tok)
            instr.vb = pop_vec(tok)
            instr.out_vec = alloc(next_vec)
            stack.append(_Val(Kind.VEC, (instr.out_vec,)))
        elif tok == "Choose":
            instr.opcode = Opcode.CHOOSE
            instr.va = pop_vec(tok)
            instr.vb = pop_vec(tok)
            instr.vc = pop_vec(tok)
            instr.out_vec = alloc(next_vec)
            stack.append(_Val(Kind.VEC, (instr.out_vec,)))
        elif tok == "Query":
            instr.opcode = Opcode.QUERY
            instr.va = pop_vec(tok)
            instr.out_vec = alloc(next_vec)
            stack.append(_Val(Kind.VEC, (instr.out_vec,)))
        elif tok == "HasItem":
            instr.opcode = Opcode.HASITEM
            instr.fa = pop_frames(tok)
            instr.out_attn = alloc(next_attn)
            stack.append(_Val(Kind.ATTN, (instr.out_attn,)))
        elif tok == "Exists":
            instr.opcode = Opcode.EXISTS
            instr.va = pop_vec(tok)   # keyword
            instr.vb = pop_vec(tok)   # feat
            instr.out_vec = alloc(next_vec)
            stack.append(_Val(Kind.VEC, (instr.out_vec,)))
        elif tok == "ExistsFrame":
            instr.opcode = Opcode.EXISTSFRAME
            instr.va = pop_vec(tok)   # keyword
            instr.fa = pop_frames(tok)
            instr.out_attn = alloc(next_attn)
            stack.append(_Val(Kind.ATTN, (instr.out_attn,)))
        elif tok == "Localize":
            instr.opcode = Opcode.LOCALIZE
            instr.fa = pop_frames(tok)
            kw = stack.pop()
            if kw.kind is not Kind.VEC:
                raise LoweringError(f"Localize keyword must be vec(s), got {kw.kind}")
            instr.count = len(kw.regs)
            instr.va = kw.regs[0]
            instr.vb = kw.regs[-1]
            instr.out_attn = alloc(next_attn)
            instr.out_attn_b = alloc(next_attn) if instr.count == 2 else instr.out_attn
            regs = ((instr.out_attn, instr.out_attn_b) if instr.count == 2
                    else (instr.out_attn,))
            stack.append(_Val(Kind.ATTN, regs))
        elif tok == "Superlative":
            instr.mode = pop_kw(tok, SUPERLATIVE_MODES)
            actions = stack.pop()
            if actions.kind is Kind.VEC:
                instr.opcode = Opcode.SUPERLATIVE_V
                instr.count = len(actions.regs)
                instr.va = actions.regs[0]
                instr.vb = actions.regs[-1]
            elif actions.kind is Kind.FRAMES:
                instr.opcode = Opcode.SUPERLATIVE_F
                instr.fb = actions.regs[0]
            else:
                raise LoweringError(f"Superlative actions kind {actions.kind} unsupported")
            instr.fa = pop_frames(tok)
            instr.out_vec = alloc(next_vec)
            stack.append(_Val(Kind.VEC, (instr.out_vec,)))
        elif tok == "Temporal":
            instr.opcode = Opcode.TEMPORAL
            instr.mode = pop_kw(tok, TEMPORAL_MODES)
            instr.fa = pop_frames(tok)
            attn = stack.pop()
            if attn.kind is not Kind.ATTN:
                raise LoweringError(f"Temporal attention operand is {attn.kind}")
            instr.count = len(attn.regs)
            instr.aa = attn.regs[0]
            instr.ab = attn.regs[-1]
            instr.out_frames = alloc(next_frames)
            instr.out_attn_b = alloc(next_attn)  # related_attn (audit/supervision)
            stack.append(_Val(Kind.FRAMES, (instr.out_frames,)))
        elif tok == "AttnVideo":
            instr.opcode = Opcode.ATTNVIDEO
            instr.fa = pop_frames(tok)
            attn = stack.pop()
            if attn.kind is not Kind.ATTN or len(attn.regs) != 1:
                raise LoweringError("AttnVideo attention operand malformed")
            instr.aa = attn.regs[0]
            instr.out_frames = alloc(next_frames)
            stack.append(_Val(Kind.FRAMES, (instr.out_frames,)))
        elif tok in ("Filter", "FilterFrame"):
            is_frame = tok == "FilterFrame"
            instr.fa = pop_frames(tok)
            kw = stack.pop()
            if kw.kind is Kind.VEC:
                instr.opcode = Opcode.FILTERFRAME_V if is_frame else Opcode.FILTER_V
                instr.va = kw.regs[0]
            elif kw.kind is Kind.KW and kw.keyword in TYPE_KEYWORDS:
                instr.opcode = Opcode.FILTERFRAME_K if is_frame else Opcode.FILTER_K
                instr.mode = TYPE_KEYWORDS[kw.keyword]
            else:
                raise LoweringError(f"{tok} keyword operand {kw} unsupported")
            if is_frame:
                instr.out_frames = alloc(next_frames)
                stack.append(_Val(Kind.FRAMES, (instr.out_frames,)))
            else:
                instr.out_vec = alloc(next_vec)
                stack.append(_Val(Kind.VEC, (instr.out_vec,)))
        elif tok == "Relate":
            instr.opcode = Opcode.RELATE
            instr.mode = pop_kw(tok, RELATE_MODES)
            attn = stack.pop()
            if attn.kind is not Kind.ATTN:
                raise LoweringError(f"Relate attention operand is {attn.kind}")
            instr.aa = attn.regs[0]
            instr.out_attn = alloc(next_attn)
            stack.append(_Val(Kind.ATTN, (instr.out_attn,)))
        else:
            raise LoweringError(f"cannot lower op {tok!r}")

        # Supervision: reference records every non-root supervised module that
        # has a source index. ref: module_net.py:107-113
        fam = OP_FAMILY.get(instr.opcode)
        instr.supervised = (
            instr.src >= 0 and fam in SUPERVISED_FAMILIES and pos != 0
        )
        emit(instr)

    if len(stack) != 1:
        raise LoweringError(f"program left {len(stack)} values on the stack")
    root = stack[0]
    if root.kind is Kind.KW:
        raise LoweringError("program root is a bare keyword")
    return Trace(
        instrs=instrs,
        num_vec=next_vec[0],
        num_frames=next_frames[0],
        num_attn=next_attn[0],
        root_kind=root.kind,
        root_reg=root.regs[0],
        tokens=list(tokens),
    )


# ---------------------------------------------------------------------------
# Batch packing
# ---------------------------------------------------------------------------

_INT_FIELDS = (
    "opcode", "va", "vb", "vc", "fa", "fb", "aa", "ab", "mode", "count",
    "span_start", "span_end", "out_vec", "out_frames", "out_attn",
    "out_attn_b", "src",
)
_F_OUT_VEC = _INT_FIELDS.index("out_vec")
_F_OUT_FRAMES = _INT_FIELDS.index("out_frames")
_F_OUT_ATTN = _INT_FIELDS.index("out_attn")
_F_OUT_ATTN_B = _INT_FIELDS.index("out_attn_b")
_F_SPAN_START = _INT_FIELDS.index("span_start")
_F_SPAN_END = _INT_FIELDS.index("span_end")
_F_SRC = _INT_FIELDS.index("src")

_VEC_PRODUCERS = frozenset({
    Opcode.PUSH_TEXT, Opcode.AND_VEC, Opcode.COMPARE, Opcode.EQUALS,
    Opcode.CHOOSE, Opcode.XOR, Opcode.QUERY, Opcode.TOACTION,
    Opcode.EXISTS, Opcode.FILTER_V, Opcode.FILTER_K,
    Opcode.SUPERLATIVE_V, Opcode.SUPERLATIVE_F,
})
_FRAMES_PRODUCERS = frozenset({
    Opcode.TEMPORAL, Opcode.ATTNVIDEO, Opcode.FILTERFRAME_V,
    Opcode.FILTERFRAME_K,
})
_ATTN_PRODUCERS = frozenset({
    Opcode.AND_ATTN, Opcode.XORFRAME, Opcode.HASITEM,
    Opcode.EXISTSFRAME, Opcode.LOCALIZE, Opcode.RELATE,
})


@dataclass
class TraceBatch:
    """A [B, T]-padded batch of traces, ready to feed the executor.

    ``fields`` maps each instruction field name to an int32 [B, T] array.
    Scratch register indices (one past the configured register counts) soak
    up writes from NOP padding steps.
    """

    fields: dict[str, np.ndarray]
    step_mask: np.ndarray       # [B, T] bool
    supervised: np.ndarray      # [B, T] bool
    root_is_vec: np.ndarray     # [B] bool
    root_reg: np.ndarray        # [B] int32
    num_steps: np.ndarray       # [B] int32

    @property
    def batch(self) -> int:
        return self.step_mask.shape[0]

    @property
    def length(self) -> int:
        return self.step_mask.shape[1]


def pad_traces(
    traces: list[Trace],
    max_steps: int,
    num_vec: int,
    num_frames: int,
    num_attn: int,
) -> TraceBatch:
    """Pack traces into [B, T] int32 arrays with register-file scratch slots.

    The configured register counts must cover every trace; each file gets one
    extra scratch slot (index ``num_*``) receiving writes from padding steps
    and from outputs an op does not produce.
    """
    B = len(traces)
    stacked = np.zeros((B, max_steps, len(_INT_FIELDS)), np.int32)
    # Padding-row defaults: NOPs writing to scratch, inert spans/src.
    stacked[:, :, _F_OUT_VEC] = num_vec
    stacked[:, :, _F_OUT_FRAMES] = num_frames
    stacked[:, :, _F_OUT_ATTN] = num_attn
    stacked[:, :, _F_OUT_ATTN_B] = num_attn
    stacked[:, :, _F_SPAN_START] = -1
    stacked[:, :, _F_SPAN_END] = -1
    stacked[:, :, _F_SRC] = -1
    step_mask = np.zeros((B, max_steps), dtype=bool)
    supervised = np.zeros((B, max_steps), dtype=bool)
    root_is_vec = np.zeros((B,), dtype=bool)
    root_reg = np.zeros((B,), dtype=np.int32)
    num_steps = np.zeros((B,), dtype=np.int32)

    scratch = (
        (_F_OUT_VEC, num_vec), (_F_OUT_FRAMES, num_frames),
        (_F_OUT_ATTN, num_attn), (_F_OUT_ATTN_B, num_attn),
    )
    for b, tr in enumerate(traces):
        T = len(tr.instrs)
        if T > max_steps:
            raise LoweringError(
                f"trace has {T} steps > max_steps={max_steps}"
            )
        if tr.num_vec > num_vec or tr.num_frames > num_frames or tr.num_attn > num_attn:
            raise LoweringError(
                f"trace needs regs (v{tr.num_vec},f{tr.num_frames},a{tr.num_attn})"
                f" > configured (v{num_vec},f{num_frames},a{num_attn})"
            )
        root_is_vec[b] = tr.root_kind is Kind.VEC
        root_reg[b] = tr.root_reg
        num_steps[b] = T
        rows = stacked[b, :T]
        rows[:] = tr.field_matrix()
        for col, idx in scratch:
            c = rows[:, col]
            c[c == _SCRATCH] = idx
        step_mask[b, :T] = True
        for t, ins in enumerate(tr.instrs):
            supervised[b, t] = ins.supervised

    fields = {
        name: np.ascontiguousarray(stacked[:, :, i])
        for i, name in enumerate(_INT_FIELDS)
    }
    return TraceBatch(
        fields=fields,
        step_mask=step_mask,
        supervised=supervised,
        root_is_vec=root_is_vec,
        root_reg=root_reg,
        num_steps=num_steps,
    )
