"""VideoNMN: the batched NMN question-answering model (port of
``stair_tpu/models/nmn.py``).

Two masked BiLSTM encoders (video and question), the executor over three
typed register files (vec ``[Nv+1, H]``, frames ``[Nf+1, F, H]``, attn
``[Na+1, F]`` per example), and the answer decoder. Parameters keep the JAX
package's key paths and ``[in, out]`` layouts, so
``weights.params_from_numpy`` carries a JAX params tree over unchanged.

The executor is chosen when the model is built, ``VideoNMN(config, ...,
executor=...)``, where the JAX package reads environment variables:

- ``"mega"`` (default): one kernel runs an example's whole program
  (``ops/mega_exec.py``: TPU kernel #4 in eval, #5 / #6 in training).
- ``"step"``: the scan executor. A Python loop over the ``T`` padded steps;
  each step reads its operands from the register files by index, computes
  every module family for the batch and writes four registers back. In
  eval with the parity Filter the ``[F, H]``-level families of a step run
  in one kernel (``ops/executor_step.py fused_step``, TPU kernel #10:
  ``T`` launches per forward) and its frames result lands in the frames
  file in place. In eval with the softmax Filter, and in training, they
  run as expert-grouped ``torch.matmul`` stages over the expert-sorted
  rows (``_Scan.heavy_stages``), differentiated by autograd.
- ``"rev"``: training through the reversible executor
  (``models/rev_exec.py``): the same step function, no stored carries, the
  register writes and the backward's cotangent updates through the slot
  kernels (``ops/regslots.py``, TPU kernels #11-#13); eval as ``"step"``.

Every route runs the encoders' BiLSTM kernels (#1 in eval, #2 / #3 in
training) under the default ``encoder="lstm"``; ``encoder="transformer"``
(``ops/lstm.py transformer_encode``) is plain torch ops. ``forward(batch, generator, deterministic=False)`` is the
training forward: the executor's dropout is keyed on a seed drawn from
``generator`` (the megakernel's counter hash; on the scan routes a
``torch.Generator`` re-seeded from ``(seed, step)``, so that a replayed
step sees the forward's masks), then the decoder mask. The serving forward
(``deterministic=True``, the default) runs under ``torch.no_grad``. There
is no knob between a kernel and its plain version: CPU tensors take the
plain versions, CUDA tensors the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stair_tpu_torch.ir.lowering import Opcode
from stair_tpu_torch.models import modules as M
from stair_tpu_torch.models.rev_exec import (
    RevCore, gather_operands, init_regs, rev_exec,
)
from stair_tpu_torch.ops import executor_step as ES
from stair_tpu_torch.ops.lstm import (
    bilstm_forward, bilstm_forward_train, init_lstm_params,
    init_transformer_encoder_params, transformer_encode,
)
from stair_tpu_torch.ops.mega_exec import mega_exec
from stair_tpu_torch.ops.mega_grad import mega_exec_train
from stair_tpu_torch.weights import (  # noqa: F401  (tree_map: re-export)
    ParamModule, tree_map,
)


#: the executors of ``VideoNMN`` (see the module docstring)
EXECUTORS = ("mega", "step", "rev")


@dataclass(frozen=True)
class NMNConfig:
    """Twin of ``stair_tpu.models.nmn.NMNConfig`` (same fields/defaults)."""

    hidden_size: int = 512
    video_size: int = 2048
    text_size: int = 300
    dropout: float = 0.25
    answer_vocab_length: int = 172
    max_video_length: int = 150
    object_types: int = 1
    have_pretrain_head: bool = True
    #: 'parity' reproduces the reference Filter pooling quirk; 'softmax' fixes it.
    filter_attention: str = "parity"
    #: 'float32' or 'bfloat16' (executor matmuls and tokens in bf16).
    compute_dtype: str = "float32"
    #: 'lstm' (the BiLSTM kernels) or 'transformer' (plain torch ops).
    encoder: str = "lstm"
    max_steps: int = 32
    num_vec: int = 24
    num_frames: int = 8
    num_attn: int = 10

    @property
    def conv_temporal(self) -> bool:
        return self.max_video_length > 32

    def to_dict(self):
        return dict(self.__dict__)


class VideoNMN(ParamModule):
    """The NMN model. Parameters live in one ``nn.ParameterDict`` keyed by
    the JAX key path joined with ``/``; ``param_tree()`` gives the nested
    view the functions below index."""

    def __init__(self, config: NMNConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device=None,
                 executor: str = "mega"):
        super().__init__()
        if config.encoder not in ("lstm", "transformer"):
            raise ValueError(f"encoder {config.encoder!r}: expected 'lstm' "
                             "or 'transformer'")
        if executor not in EXECUTORS:
            raise ValueError(f"executor {executor!r}: expected one of "
                             f"{EXECUTORS}")
        self.config = config
        self.executor = executor
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = self.init(generator, device)
        self._hold(params, device)

    # -- parameters ----------------------------------------------------------

    def init(self, gen: torch.Generator, device=None) -> dict:
        """A fresh params tree with the JAX package's keys and shapes."""
        cfg = self.config
        H = cfg.hidden_size
        # draws in this order: modules, video encoder, text encoder, decoder
        modules = M.init_module_params(gen, {
            "hidden_size": H,
            "max_video_length": cfg.max_video_length,
            "object_types": cfg.object_types,
            "have_pretrain_head": cfg.have_pretrain_head,
        }, device)
        if cfg.encoder == "lstm":
            video_enc = init_lstm_params(gen, cfg.video_size, H // 2, device)
            text_enc = init_lstm_params(gen, cfg.text_size, H // 2, device)
        else:
            video_enc = init_transformer_encoder_params(
                gen, cfg.video_size, H, max_len=max(cfg.max_video_length, 512),
                device=device)
            text_enc = init_transformer_encoder_params(gen, cfg.text_size, H,
                                                       device=device)
        return {
            "modules": modules,
            "video_encoder": video_enc,
            "text_encoder": text_enc,
            "decoder": {
                "l1": M._init_linear(gen, 2 * H, 2 * H, device),
                "l2": M._init_linear(gen, 2 * H, cfg.answer_vocab_length,
                                     device),
            },
            "choice_proj": M._init_linear(gen, 2 * H, H, device),
        }

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.config.compute_dtype == "bfloat16"
                else torch.float32)

    # -- encoders ------------------------------------------------------------

    def _encode_batched(self, enc_params, x, mask):
        """[B, L, D] -> (tokens [B, L, H] dt, sentence [B, H] f32,
        (fwd, bwd) halves [B, L, H/2] dt). The recurrence goes to
        ``bilstm_reference`` for CPU tensors and to the kernel for CUDA
        tensors: the differentiable training pair when autograd is on
        (``bilstm_forward_train``), the eval kernel otherwise. The
        transformer encoder runs in float32 with no kernel; its halves are
        the two halves of its tokens, which the executor casts."""
        if self.config.encoder == "transformer":
            tokens, sent = transformer_encode(enc_params, x, mask)
            half = tokens.shape[-1] // 2
            return tokens, sent, (tokens[..., :half], tokens[..., half:])
        dt = self.compute_dtype
        mm = dt if dt != torch.float32 else None
        fn = bilstm_forward_train if torch.is_grad_enabled() else \
            bilstm_forward
        return fn(enc_params, x, mask, mm_dtype=mm, token_dtype=dt)

    def encode_sentences(self, embeddings, mask, params=None):
        """Batch-encode standalone phrases -> sentence features [N, H]."""
        if params is None:
            params = self.param_tree()
        return self._encode_batched(params["text_encoder"], embeddings,
                                    mask)[1]

    # -- the executor --------------------------------------------------------

    @staticmethod
    def _fused_tables(mods):
        """Stack the [H, H]-matmul module families into expert tables.

        Stage-1 rows (two-layer MLP): [filter.repr, filter.kw x3, ff.repr,
        ff.kw x3, localize.v1/v2, null, hasitem.l1/l2(padded)].
        Pooled-dense rows: [filter.dense, ff.dense, null].
        Stage-2 rows: [ff.dense, temporal.dense, localize.k, null].
        """
        f, ff = mods["filter"], mods["filterframe"]
        loc, hi, tmp = mods["localize"], mods["hasitem"], mods["temporal"]
        w = f["repr_w1"]
        H = w.shape[0]
        zw = torch.zeros((1, H, H), dtype=w.dtype, device=w.device)
        zb = torch.zeros((1, H), dtype=w.dtype, device=w.device)
        l2w = torch.nn.functional.pad(hi["l2"]["w"], (0, H - 1))
        l2b = torch.nn.functional.pad(hi["l2"]["b"], (0, H - 1))
        cat = torch.cat
        return {
            "w1u": cat([f["repr_w1"][None], f["kw_w1"], ff["repr_w1"][None],
                        ff["kw_w1"], loc["v1"]["w"][None], zw,
                        hi["l1"]["w"][None]]),
            "b1u": cat([f["repr_b1"][None], f["kw_b1"], ff["repr_b1"][None],
                        ff["kw_b1"], loc["v1"]["b"][None], zb,
                        hi["l1"]["b"][None]]),
            "w2u": cat([f["repr_w2"][None], f["kw_w2"], ff["repr_w2"][None],
                        ff["kw_w2"], loc["v2"]["w"][None], zw, l2w[None]]),
            "b2u": cat([f["repr_b2"][None], f["kw_b2"], ff["repr_b2"][None],
                        ff["kw_b2"], loc["v2"]["b"][None], zb, l2b[None]]),
            "dense3": cat([f["dense"]["w"][None], ff["dense"]["w"][None],
                           zw]),
            "db3": cat([f["dense"]["b"][None], ff["dense"]["b"][None], zb]),
            "w2t": cat([ff["dense"]["w"][None], tmp["dense"]["w"][None],
                        loc["k"]["w"][None], zw]),
            "b2t": cat([ff["dense"]["b"][None], tmp["dense"]["b"][None],
                        loc["k"]["b"][None], zb]),
        }

    def run_trace(self, params, trace_fields, video_halves, video_mask,
                  token_halves, token_mask, aux_vec=None, seed=None):
        """Execute all programs; returns the final register files (dt).
        With ``seed`` (two int32 values) it is the training executor with
        dropout at ``config.dropout``."""
        dt = self.compute_dtype
        mods = params["modules"]
        if dt != torch.float32:
            mods = tree_map(lambda x: x.to(dt), mods)
            video_mask = video_mask.to(dt)
        tables = self._fused_tables(mods)
        halves = tuple(tuple(p.to(dt) for p in pair)
                       for pair in (video_halves, token_halves))
        aux_in = None if aux_vec is None else aux_vec.to(dt)
        if self.executor != "mega":
            return self._run_scan(
                mods, tables, trace_fields, torch.cat(halves[0], dim=-1),
                video_mask, torch.cat(halves[1], dim=-1), token_mask, aux_in,
                seed)
        if seed is not None:
            return mega_exec_train(
                self.config, mods, tables, trace_fields, halves[0],
                video_mask, halves[1], token_mask, self.config.dropout, seed,
                aux_vec=aux_in)
        return mega_exec(self.config, mods, tables, trace_fields, halves[0],
                         video_mask, halves[1], token_mask, aux_vec=aux_in)

    def _run_scan(self, mods, tables, trace_fields, video_frames, video_mask,
                  token_features, token_mask, aux_vec, seed):
        """The scan executor (``"step"`` and ``"rev"``): a loop over the
        ``T`` steps on register files indexed per example."""
        cfg = self.config
        B, F, H = video_frames.shape
        T = trace_fields["opcode"].shape[1]
        scan = _Scan(cfg, trace_fields, seed, video_frames.dtype)
        video0 = video_frames * video_mask[:, :, None]
        if aux_vec is None:
            aux = torch.zeros(T, B, H, dtype=video_frames.dtype,
                              device=video_frames.device)
        else:
            aux = aux_vec.transpose(0, 1)
        # the Temporal conv layers as banded matrices, built once for the
        # T steps (an empty tuple in linear mode)
        bands = (M.temporal_bands(mods["temporal"], F)
                 if cfg.conv_temporal else ())
        consts = (mods, tables, token_features, token_mask, video_mask,
                  bands)
        core = RevCore(scan.step, scan.fields, cfg.num_vec, cfg.num_frames,
                       cfg.num_attn)
        if self.executor == "rev" and seed is not None:
            return rev_exec(core, video0, consts, aux.contiguous())
        regs = init_regs(core, video0)
        for t in range(T):
            regs = scan.advance(regs, consts, t, aux[t])
        # The scratch frames slot needs no re-zeroing after the loop: the
        # fused step writes nothing for a tile without a frames result, and
        # the other route writes zeros there.
        return regs

    # -- full forward --------------------------------------------------------

    def forward(self, batch, generator: torch.Generator | None = None,
                deterministic: bool = True):
        """Encoders + executor + answer decoder on a padded batch.

        ``batch`` keys: question [B, L, text_size], question_mask [B, L],
        video [B, F, video_size], video_mask [B, F], trace (dict of [B, T]
        int tensors), root_reg [B], root_is_vec [B]; optionally aux_emb
        [B, T, La, text_size] and aux_mask [B, T, La]. Returns the JAX
        forward's dict: logits, question_feature, token_features,
        regs_vec, regs_frames, regs_attn (float32) and root.

        ``deterministic=False`` with a ``generator`` is the training
        forward (autograd on, dropout drawn from ``generator``: the
        executor's hash seed, then the decoder mask); without a generator
        the forward is deterministic, as in JAX without an rng.
        """
        if generator is None or deterministic:
            with torch.no_grad():
                return self._forward(batch, None)
        return self._forward(batch, generator)

    def _forward(self, batch, gen):
        cfg = self.config
        params = self.param_tree()
        if gen is None:
            params = tree_map(lambda x: x.detach(), params)
        seed = None if gen is None else tuple(torch.randint(
            0, 2 ** 31 - 1, (2,), generator=gen, device=gen.device).tolist())
        _, _, video_halves = self._encode_batched(
            params["video_encoder"], batch["video"], batch["video_mask"])
        token_features, question_feature, token_halves = (
            self._encode_batched(params["text_encoder"], batch["question"],
                                 batch["question_mask"]))
        aux_vec = None
        if batch.get("aux_emb") is not None:
            ae = batch["aux_emb"]
            B_, T_, La, td = ae.shape
            aux_vec = self.encode_sentences(
                ae.reshape(B_ * T_, La, td),
                batch["aux_mask"].reshape(B_ * T_, La), params,
            ).reshape(B_, T_, -1)
        rv, rf, ra = self.run_trace(
            params, batch["trace"], video_halves, batch["video_mask"],
            token_halves, batch["question_mask"], aux_vec=aux_vec,
            seed=seed)

        B = rv.shape[0]
        ar = torch.arange(B, device=rv.device)
        root_reg = batch["root_reg"].long()
        root_vec = rv[ar, root_reg].float()
        # Non-vec roots: masked mean of the root frames register.
        root_frames = rf[ar, torch.clamp(root_reg, max=cfg.num_frames)]
        vmask = batch["video_mask"].float()
        fallback = torch.sum(root_frames.float() * vmask[:, :, None], 1) / (
            torch.clamp(vmask.sum(1, keepdim=True), min=1.0))
        root = torch.where(batch["root_is_vec"].bool()[:, None], root_vec,
                           fallback)
        rv, rf, ra = rv.float(), rf.float(), ra.float()

        hidden = torch.cat([root, question_feature], dim=-1)
        h = torch.relu(M.linear(params["decoder"]["l1"], hidden))
        h = M.dropout(h, cfg.dropout, gen, gen is None)
        logits = M.linear(params["decoder"]["l2"], h)
        return {
            "logits": logits,
            "question_feature": question_feature,
            "token_features": token_features,
            "regs_vec": rv,
            "regs_frames": rf,
            "regs_attn": ra,
            "root": root,
        }


def choice_logits(model, out, cand_emb, cand_mask, cand_valid, params=None):
    """Score multiple-choice candidates (STAR; the port of
    ``stair_tpu.models.nmn.choice_logits``): candidates are text-encoded
    and scored against a projection of [program output; question feature].
    ``cand_emb`` [B, C, Lc, text]; returns [B, C] with -inf on invalid
    slots."""
    if params is None:
        params = model.param_tree()
    B, C, Lc, text = cand_emb.shape
    reps = model.encode_sentences(
        cand_emb.reshape(B * C, Lc, text), cand_mask.reshape(B * C, Lc),
        params).reshape(B, C, -1)                           # [B, C, H]
    query = torch.relu(M.linear(
        params["choice_proj"],
        torch.cat([out["root"], out["question_feature"]], dim=-1)))
    scores = torch.einsum("bh,bch->bc", query, reps)
    return torch.where(cand_valid > 0, scores,
                       torch.full_like(scores, -torch.inf))


# ---------------------------------------------------------------------------
# The scan executor
# ---------------------------------------------------------------------------

def _select(is_op, candidates, default):
    """Pick, per example, the candidate of the example's opcode:
    ``is_op[code]`` is the ``[B]`` mask of the examples that run ``code``."""
    out = default
    for code, value in candidates:
        hit = is_op[code].reshape((-1,) + (1,) * (value.dim() - 1))
        out = torch.where(hit, value.to(out.dtype), out)
    return out


def _grouped(x, table, bias, sizes, null):
    """Expert-grouped ``x @ table[g] + bias[g]``: the rows of ``x`` are
    sorted by expert and ``sizes`` (host integers) gives each expert's row
    count. One ``torch.matmul`` per expert present; the ``null`` expert's
    rows (zero weights) come back as zeros without a product. No weight is
    ever gathered per example."""
    outs, start = [], 0
    for g, n in enumerate(sizes):
        if n == 0:
            continue
        rows = x[start:start + n]
        if g == null:
            outs.append(rows.new_zeros(rows.shape[:-1] + table.shape[-1:]))
        else:
            outs.append(rows @ table[g] + bias[g])
        start += n
    return torch.cat(outs)


def _superlative(dense, scores, actions, amask, mode, vm):
    """Soft-argmax over candidate actions: scores [n, K, F], actions
    [n, K, H], amask [n, K] -> [n, H] (in the scores' dtype)."""
    row = torch.sum(scores * vm[:, None, :], dim=2)
    w = M.masked_softmax(row, amask, dim=1)
    w = torch.where((mode == 1)[:, None], 1.0 - w, w) * amask
    pooled = torch.sum(w[:, :, None] * actions, dim=1)
    return torch.relu(pooled @ dense["w"].to(pooled.dtype)
                      + dense["b"].to(pooled.dtype))


class _Scan:
    """One run of the scan executor over a batch: the dispatch schedule of
    all ``T`` steps, computed once from the trace before the loop, and the
    step function that the ``"step"`` loop, the ``"rev"`` forward and the
    ``"rev"`` backward's replay share.

    The schedule (expert codes, sort permutations, the fused kernel's
    packed ``[12, B]`` rows, the SUPERLATIVE_F rows) lives on the device;
    the group sizes of every step come to the host in ONE transfer, because
    ``_grouped`` slices rows with host integers.
    """

    def __init__(self, cfg, trace_fields, seed, dtype):
        self.cfg = cfg
        self.dt = dtype
        self.rate = cfg.dropout
        self.seed = seed
        self.deterministic = seed is None
        self.parity = cfg.filter_attention == "parity"
        #: eval with the parity Filter: the per-step kernel (#10)
        self.fused = self.deterministic and self.parity
        f = {k: v.to(torch.int32).t().contiguous()
             for k, v in trace_fields.items()}                # [T, B]
        self.fields = f
        op, mode = f["opcode"], f["mode"]
        T, B = op.shape

        #: opcode -> [T, B] mask of the steps that run it
        self.op_is = {code: op == int(code) for code in Opcode}

        def is_op(*codes):
            m = torch.zeros_like(op, dtype=torch.bool)
            for c in codes:
                m |= self.op_is[c]
            return m

        is_ff = is_op(Opcode.FILTERFRAME_V, Opcode.FILTERFRAME_K)
        is_filter = is_ff | is_op(Opcode.FILTER_V, Opcode.FILTER_K)
        is_kw = is_op(Opcode.FILTER_K, Opcode.FILTERFRAME_K)
        is_supf = is_op(Opcode.SUPERLATIVE_F)
        is_locsup = is_supf | is_op(Opcode.LOCALIZE, Opcode.SUPERLATIVE_V)
        zero = torch.zeros_like(op)
        # stage-1 experts: [filter x4 | filterframe x4 | localize | null |
        # hasitem]; stage-2 families as the fused kernel's e2 codes
        e1 = torch.where(
            is_filter,
            torch.where(is_ff, 4, zero) + torch.where(is_kw, 1 + mode, zero),
            torch.where(is_locsup, 8,
                        torch.where(is_op(Opcode.HASITEM), 10, 9 + zero)))
        e2 = torch.where(
            is_ff, ES.E2_FF, torch.where(
                is_op(Opcode.TEMPORAL), ES.E2_TEMPORAL, torch.where(
                    is_supf, ES.E2_SUPF, torch.where(
                        is_op(Opcode.ATTNVIDEO), ES.E2_ATTNVIDEO,
                        ES.E2_NULL + zero))))
        self.is_ff, self.is_filter, self.is_supf = is_ff, is_filter, is_supf
        self.is_temporal = is_op(Opcode.TEMPORAL)
        self.is_ffv = is_op(Opcode.FILTERFRAME_V)
        self.is_filter_v = is_op(Opcode.FILTER_V)

        def counts(codes, n):
            return torch.nn.functional.one_hot(codes.long(), n).sum(1)

        def sort(keys):
            perm = torch.argsort(keys, dim=1, stable=True)
            return perm, torch.argsort(perm, dim=1)

        host = [counts(e1, ES.NUM_E1), is_supf.sum(1, keepdim=True)]
        #: rows whose opcode is SUPERLATIVE_F first, per step
        self.supf_rows = torch.argsort((~is_supf).to(torch.int8), dim=1,
                                       stable=True)
        if self.fused:
            self.perm1, self.inv1 = sort(e1 * 5 + e2)
            perm = self.perm1

            def g(a):
                return torch.gather(a.to(torch.int32), 1, perm)

            w2t_code = torch.where(e2 == ES.E2_SUPF, 3, e2.clamp(max=3))
            self.scal = torch.stack([
                perm.to(torch.int32), g(e1), g(w2t_code), g(e2), g(f["fa"]),
                g(f["fb"]), g(f["va"]), g(f["aa"]), g(is_filter),
                g(self.is_ffv), g(f["vb"]), g(f["out_frames"]),
            ], dim=1).contiguous()                            # [T, NS, B]
        else:
            e2 = e2.clamp(max=ES.E2_NULL)    # attnvideo: no projection
            self.perm1, self.inv1 = sort(e1)
            self.perm2, self.inv2 = sort(e2)
            host.append(counts(e2, 4))
        host = torch.cat(host, dim=1).cpu().tolist()   # the one transfer
        self.sizes1 = [row[:ES.NUM_E1] for row in host]
        self.nsup = [row[ES.NUM_E1] for row in host]
        self.sizes2 = [row[ES.NUM_E1 + 1:] for row in host]

    # -- dropout ---------------------------------------------------------

    def _generator(self, t, device):
        """The generator of step ``t``'s masks, a function of ``(seed,
        t)`` alone: the reversible backward replays a step and must draw
        the masks its forward drew."""
        if self.deterministic or self.rate == 0.0:
            return None
        s0, s1 = (int(v) for v in self.seed)
        gen = torch.Generator(device=device)
        gen.manual_seed((((s0 << 31) ^ s1) * 4099 + t) % (1 << 63))
        return gen

    # -- one step --------------------------------------------------------

    def step(self, operands, consts, t, aux_t):
        """Step ``t`` for the whole batch on gathered operands (the grouped
        torch route): the four register writes ``(new_vec, new_frames,
        new_attn, new_attn_b)``. Every differentiable value arrives through
        the arguments, so the reversible backward can replay it."""
        mods, tables, tokens, tmask, vmask, bands = consts
        gen = self._generator(t, vmask.device)
        heavy = self.heavy_stages(operands, t, mods, tables, vmask, bands,
                                  gen)
        return self.step_one(mods, operands, t, vmask, tokens, tmask, aux_t,
                             heavy, gen)

    def advance(self, regs, consts, t, aux_t):
        """Read step ``t``'s operands from ``regs``, run it and write its
        results back (index ops; in place on the files ``_run_scan``
        allocated)."""
        f = self.fields
        rv, rf, ra = regs
        ar = torch.arange(rv.shape[0], device=rv.device)
        if self.fused:
            mods, tables, tokens, tmask, vmask, bands = consts
            ops = (rv[ar, f["va"][t]], rv[ar, f["vb"][t]],
                   rv[ar, f["vc"][t]], None, None,
                   ra[ar, f["aa"][t]], ra[ar, f["ab"][t]])
            # the frames write happens inside the kernel
            heavy = self.heavy_fused(regs, ops, t, mods, tables, vmask,
                                     bands)
            new = self.step_one(mods, ops, t, vmask, tokens, tmask, aux_t,
                                heavy, None)
        else:
            new = self.step(gather_operands(regs, f, t), consts, t, aux_t)
            rf.index_put_((ar, f["out_frames"][t]), new[1])
        rv.index_put_((ar, f["out_vec"][t]), new[0])
        ra.index_put_((ar, f["out_attn"][t]), new[2])
        ra.index_put_((ar, f["out_attn_b"][t]), new[3])
        return rv, rf, ra

    def step_one(self, mods, operands, t, vmask, tokens, tmask, aux_t, heavy,
                 gen):
        """The cheap ``[H]``- and ``[F]``-level modules and the opcode
        selection of step ``t``; ``heavy`` carries the outputs of the
        ``[F, H]``-level families."""
        f, dt = self.fields, self.dt
        rate, det = self.rate, self.deterministic
        mode = f["mode"][t]
        is_op = {code: m[t] for code, m in self.op_is.items()}
        va, vb, vc, fa, _fb, aa, ab = operands
        B, H = va.shape
        F = aa.shape[1]

        # --- span-mean text push (float32 sum, one rounding) -------------
        s, e = f["span_start"][t][:, None], f["span_end"][t][:, None]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        valid = tmask > 0
        span_w = torch.where(s < 0, valid,
                             (pos >= s) & (pos < e) & valid).float()
        push_text = torch.einsum("bl,blh->bh", span_w, tokens.float()) / (
            torch.clamp(span_w.sum(1, keepdim=True), min=1.0))
        # -2 marks the substitution of a program word's own text encoding
        push_text = torch.where(s == -2, aux_t, push_text.to(dt))

        # --- vec candidates (dropout sites in this order) -----------------
        query = M.query_module(mods["query"], va, rate, gen, det)
        toaction = M.toaction_module(mods["toaction"], va, vb, rate, gen, det)
        exists = M.exists_module(mods["exists"], va, vb, rate, gen, det)
        new_vec = _select(is_op, [
            (Opcode.PUSH_TEXT, push_text),
            (Opcode.AND_VEC, M.and_module(va, vb)),
            (Opcode.COMPARE, M.compare_module(mods["compare"], va, vb)),
            (Opcode.EQUALS, M.equals_module(mods["equals"], va, vb)),
            (Opcode.CHOOSE, M.choose_module(va, vb, vc)),
            (Opcode.XOR, M.xor_module(mods["xor"], va, vb)),
            (Opcode.QUERY, query),
            (Opcode.TOACTION, toaction),
            (Opcode.EXISTS, exists),
            (Opcode.FILTER_V, heavy["filter_vec"]),
            (Opcode.FILTER_K, heavy["filter_vec"]),
            (Opcode.SUPERLATIVE_V, heavy["sup_v"]),
            (Opcode.SUPERLATIVE_F, heavy["sup_f"]),
        ], va.new_zeros(B, H))

        # --- frames candidates (the fused kernel wrote them already) ------
        new_frames = None
        if "temporal_out" in heavy:
            new_frames = _select(is_op, [
                (Opcode.TEMPORAL, heavy["temporal_out"]),
                (Opcode.ATTNVIDEO, M.attnvideo_module(fa, aa)),
                (Opcode.FILTERFRAME_V, heavy["ff_frames"]),
                (Opcode.FILTERFRAME_K, heavy["ff_frames"]),
            ], fa.new_zeros(fa.shape))

        # --- attn candidates ----------------------------------------------
        existsframe = (heavy["existsframe"] if "existsframe" in heavy
                       else M.existsframe_module(va, fa, vmask))
        new_attn = _select(is_op, [
            (Opcode.AND_ATTN, M.and_module(aa, ab)),
            (Opcode.XORFRAME, M.xorframe_module(aa, ab)),
            (Opcode.HASITEM, heavy["hasitem"]),
            (Opcode.EXISTSFRAME, existsframe),
            (Opcode.LOCALIZE, heavy["loc_scores"][:, 0]),
            (Opcode.RELATE, M.relate_module(mods["relate"], mode == 1, aa,
                                            vmask > 0)),
        ], aa.new_zeros(B, F))
        new_attn_b = _select(is_op, [
            (Opcode.LOCALIZE, heavy["loc_scores"][:, 1]),
            (Opcode.TEMPORAL, heavy["temporal_rel"]),
        ], aa.new_zeros(B, F))
        return new_vec, new_frames, new_attn, new_attn_b

    def _related(self, mods, t, aa, ab, vmask, bands):
        """The Temporal module's gated attention for every row: [B, F]."""
        f = self.fields
        attn_mean = torch.where((f["count"][t] == 2)[:, None],
                                (aa + ab) / 2.0, aa)
        return M.temporal_related_attn_batched(
            mods["temporal"], f["mode"][t], attn_mean,
            self.cfg.conv_temporal, bands or None) * vmask

    def _filter_dense(self, t, pooled_s, tables):
        """The Filter head's dense layer on pooled rows in stage-1 sorted
        order ([filter | filterframe | the rest] -> ``dense3``), back in
        example order."""
        sizes1 = self.sizes1[t]
        n0, n1 = sum(sizes1[:4]), sum(sizes1[4:8])
        return torch.relu(_grouped(
            pooled_s, tables["dense3"], tables["db3"],
            [n0, n1, pooled_s.shape[0] - n0 - n1], 2))[self.inv1[t]]

    def _sup_v(self, mods, t, loc_scores, va, vb, vmask):
        """SUPERLATIVE_V: soft-argmax over the one or two keyword vectors
        by their Localize scores [B, 2, F]."""
        pair = torch.stack([va, vb], dim=1)                  # [B, 2, H]
        pair_mask = torch.arange(2, device=va.device)[None] < (
            self.fields["count"][t][:, None])
        return _superlative(mods["superlative"]["dense"], loc_scores, pair,
                            pair_mask, self.fields["mode"][t], vmask)

    def _sup_f(self, mods, t, kw_f, vfeat, fb, vmask, like):
        """SUPERLATIVE_F on its own rows (its all-pairs ``[F, F]`` cosine
        is the fattest product of a step and its opcode is rare); zeros
        elsewhere. ``kw_f`` / ``vfeat`` / ``fb`` are given for those rows."""
        rows = self.supf_rows[t, :self.nsup[t]]
        out = like.new_zeros(like.shape)
        if not self.nsup[t]:
            return out
        vm = vmask[rows]
        scores = (M.cosine_matrix(kw_f, vfeat) + 1.0) * 0.49 * vm[:, None, :]
        sup = _superlative(mods["superlative"]["dense"], scores, fb, vm > 0,
                           self.fields["mode"][t][rows], vm)
        return out.index_copy(0, rows, sup.to(out.dtype))

    def heavy_stages(self, operands, t, mods, tables, vmask, bands, gen):
        """All ``[F, H]``-matmul module families of step ``t`` for the whole
        batch as expert-grouped stages (``_fused_tables``): per step each
        example needs at most one family of each stage, so the batch is
        sorted by expert and each expert present is one ``torch.matmul``;
        rows whose opcode needs none go to a null expert. A row's unused
        family outputs are discarded by ``step_one``'s opcode selection.
        Dropout sites, in order: stage-1 hidden, stage-1 output, stage-2
        output, hasitem."""
        rate, det = self.rate, self.deterministic
        va, vb, _vc, fa, fb, aa, ab = operands
        H = fa.shape[-1]
        is_ff, is_supf = self.is_ff[t], self.is_supf[t]
        is_temporal = self.is_temporal[t]

        # ---- stage 1: two-layer frames MLP ------------------------------
        perm1, inv1, sizes1 = self.perm1[t], self.inv1[t], self.sizes1[t]
        h = _grouped(fa[perm1], tables["w1u"], tables["b1u"], sizes1,
                     ES.E1_NULL)
        h = M.dropout(torch.relu(h), rate, gen, det)
        h2 = _grouped(h, tables["w2u"], tables["b2u"], sizes1, ES.E1_NULL)
        # filter rows relu + dropout; localize v2 / hasitem l2 stay linear
        feat_like = M.dropout(torch.relu(h2), rate, gen, det)
        feat_s = torch.where(self.is_filter[t][perm1][:, None, None],
                             feat_like, h2)
        out1 = feat_s[inv1]                                  # [B, F, H]

        # ---- filter heads (sorted domain) -------------------------------
        vm_s, va_s = vmask[perm1], va[perm1]
        if self.parity:
            weights = vm_s[:, :, None]
        else:
            aw = mods["filter"]["attn_w"]
            logits = (feat_s @ aw[:H] + (
                va_s @ aw[H:] + mods["filter"]["attn_b"])[:, None, :])[..., 0]
            soft = M.masked_softmax(logits, vm_s > 0)
            weights = torch.where(
                self.is_filter_v[t][perm1][:, None, None], soft[:, :, None],
                vm_s[:, :, None])
        pooled = torch.sum(weights * feat_s * vm_s[:, :, None], dim=1)
        filter_vec = self._filter_dense(t, pooled, tables)
        # FilterFrame sigmoid gate (vec keyword) or identity
        ffw = mods["filterframe"]["attn_w"]
        gate = torch.sigmoid(feat_s @ ffw[:H] + (
            va_s @ ffw[H:] + mods["filterframe"]["attn_b"])[:, None, :])
        gate = torch.where(self.is_ffv[t][perm1][:, None, None], gate,
                           torch.ones_like(gate))
        x_ff = (gate * feat_s)[inv1]

        related = self._related(mods, t, aa, ab, vmask, bands)   # [B, F]

        # ---- stage 2: output projections --------------------------------
        # experts: [ff.dense | temporal.dense | localize.k | null]
        x2 = torch.where(
            is_ff[:, None, None], x_ff, torch.where(
                is_temporal[:, None, None], related[:, :, None] * fa,
                torch.where(is_supf[:, None, None], fb, fa)))
        perm2, inv2 = self.perm2[t], self.inv2[t]
        y2 = _grouped(x2[perm2], tables["w2t"], tables["b2t"],
                      self.sizes2[t], ES.E2_NULL)[inv2]
        # shared relu + dropout epilogue (rows are ff XOR temporal); the
        # localize.k output (SUPERLATIVE_F's keywords) stays linear
        base = M.dropout(torch.relu(y2), rate, gen, det)
        ff_frames = base * vmask[:, :, None]
        temporal_out = M.layer_norm(mods["temporal"]["ln"], base)

        # ---- localize / superlative heads -------------------------------
        kw_pair = M.linear(mods["localize"]["k"],
                           torch.stack([va, vb], dim=1))     # [B, 2, H]
        loc_scores = (M.cosine_matrix(kw_pair, out1) + 1.0) * 0.49 * (
            vmask[:, None, :])                               # [B, 2, F]
        sup_v = self._sup_v(mods, t, loc_scores, va, vb, vmask)
        rows = self.supf_rows[t, :self.nsup[t]]
        sup_f = self._sup_f(mods, t, y2[rows], out1[rows], fb[rows], vmask,
                            sup_v)

        hasitem = M.dropout(torch.sigmoid(out1[..., 0]), rate, gen,
                            det) * vmask
        return {
            "filter_vec": filter_vec, "ff_frames": ff_frames,
            "loc_scores": loc_scores, "sup_v": sup_v, "sup_f": sup_f,
            "temporal_out": temporal_out, "temporal_rel": related,
            "hasitem": hasitem,
        }

    def heavy_fused(self, regs, operands, t, mods, tables, vmask, bands):
        """The same families through the fused step kernel (eval, parity
        Filter): operands come straight from the register files inside the
        kernel, and the frames result is written into ``rf`` there. What
        stays outside: the Temporal gate's tiny ``[B, F]`` stack, the
        Filter head's grouped dense on the pooled rows, the superlative
        soft-argmax, and SUPERLATIVE_F on its own rows."""
        f, dt = self.fields, self.dt
        rv, rf, ra = regs
        va, vb, _vc, _fa, _fb, aa, ab = operands
        H = va.shape[-1]
        related = self._related(mods, t, aa, ab, vmask, bands)
        ffw = mods["filterframe"]["attn_w"]
        gkb = (va @ ffw[H:] + mods["filterframe"]["attn_b"]).float()
        ln, lock = mods["temporal"]["ln"], mods["localize"]["k"]
        _, pooled_s, hasitem, exf, loc_a, loc_b = ES.fused_step(
            self.scal[t], rv, rf, ra, related.to(dt), vmask.to(dt), gkb,
            tables["w1u"], tables["b1u"], tables["w2u"], tables["b2u"],
            tables["w2t"], tables["b2t"], ffw[:H].contiguous(),
            ln["scale"][None], ln["bias"][None], lock["w"], lock["b"][None])

        filter_vec = self._filter_dense(t, pooled_s, tables)
        loc_scores = torch.stack([loc_a, loc_b], dim=1)      # [B, 2, F] f32
        sup_v = self._sup_v(mods, t, loc_scores, va, vb, vmask)

        # SUPERLATIVE_F: its keywords (fb through localize.k) and the
        # stage-1 localize projection of fa, recomputed for its rows alone
        # (the kernel emits no [B, F, H] feat buffer).
        rows = self.supf_rows[t, :self.nsup[t]]
        fbc = rf[rows, f["fb"][t][rows]]
        fac = rf[rows, f["fa"][t][rows]]
        kw_f = fbc @ tables["w2t"][2] + tables["b2t"][2]
        hid = torch.relu(fac @ tables["w1u"][8] + tables["b1u"][8])
        vfeat = hid @ tables["w2u"][8] + tables["b2u"][8]
        sup_f = self._sup_f(mods, t, kw_f, vfeat, fbc, vmask, sup_v)
        return {
            "filter_vec": filter_vec, "loc_scores": loc_scores,
            "sup_v": sup_v, "sup_f": sup_f, "temporal_rel": related,
            "hasitem": hasitem, "existsframe": exf,
        }
