"""VideoNMN: the batched NMN question-answering forward (port of
``stair_tpu/models/nmn.py``).

The serving forward: two masked BiLSTM encoders (video and question), the
executor over three typed register files, and the answer decoder. The
encoders' recurrence and the executor run in the two CUDA kernels on the
card (``ops/lstm.py bilstm``, ``ops/mega_exec.py mega_exec``) and in their
plain versions on the CPU. Parameters keep the JAX package's key paths and
``[in, out]`` layouts, so ``weights.params_from_numpy`` carries a JAX
params tree over unchanged.

Only the executor route is ported (the JAX package's XLA ragged-dot scan is
its CPU fallback). ``forward(batch, generator, deterministic=False)`` is
the training forward: the differentiable encoders (``bilstm_forward_train``,
TPU kernels #2/#3), the training executor (``mega_exec_train``, kernels
#5/#6, counter-hash dropout seeded from ``generator``) and decoder dropout.
The serving forward (``deterministic=True``, the default) runs under
``torch.no_grad`` on the eval kernels. There are no route knobs: CPU tensors
take the plain versions, CUDA tensors the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stair_tpu_torch.models import modules as M
from stair_tpu_torch.ops.lstm import (
    bilstm_forward, bilstm_forward_train, init_lstm_params,
)
from stair_tpu_torch.ops.mega_exec import mega_exec
from stair_tpu_torch.ops.mega_grad import mega_exec_train
from stair_tpu_torch.weights import (  # noqa: F401  (tree_map: re-export)
    ParamModule, tree_map,
)


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
    #: only 'lstm' is ported.
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
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if config.encoder != "lstm":
            raise NotImplementedError("only the lstm encoder is ported")
        self.config = config
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
        return {
            "modules": M.init_module_params(gen, {
                "hidden_size": H,
                "max_video_length": cfg.max_video_length,
                "object_types": cfg.object_types,
                "have_pretrain_head": cfg.have_pretrain_head,
            }, device),
            "video_encoder": init_lstm_params(gen, cfg.video_size, H // 2,
                                              device),
            "text_encoder": init_lstm_params(gen, cfg.text_size, H // 2,
                                             device),
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
        (``bilstm_forward_train``), the eval kernel otherwise."""
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
        if seed is not None:
            return mega_exec_train(
                self.config, mods, tables, trace_fields, halves[0],
                video_mask, halves[1], token_mask, self.config.dropout, seed,
                aux_vec=aux_in)
        return mega_exec(self.config, mods, tables, trace_fields, halves[0],
                         video_mask, halves[1], token_mask, aux_vec=aux_in)

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
