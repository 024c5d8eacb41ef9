"""Per-module intermediate-supervision losses, batched (port of
``stair_tpu/train/losses.py``).

Masked over the [B, T] step grid of the executor's final register files:
Exists/Xor CE on the pretrain head, Equals MSE, soft attention CE for
ExistsFrame/Temporal/Localize, in-batch (or windowed) contrastive CE for
Filter/ToAction/Superlative against the text-encoded class table (encoded
under ``torch.no_grad``, as the JAX ``stop_gradient``), optional
FilterFrame BCE, and the answer CE. ``SUP_*`` and ``OP_FAMILY`` come from
the port's own ``data/dataset.py`` and ``ir/lowering.py``.
"""

from __future__ import annotations

import torch

from stair_tpu_torch.data.dataset import (
    SUP_ATTN1, SUP_ATTN2, SUP_BOOL, SUP_CONTRAST, SUP_EQUALS,
)
from stair_tpu_torch.ir.lowering import OP_FAMILY, Opcode
from stair_tpu_torch.models.modules import l2_normalize, linear
from stair_tpu_torch.models.nmn import choice_logits, tree_map

#: Stable family list for telemetry vectors.
FAMILIES = (
    "Exists", "Xor", "Equals", "Filter", "ToAction", "Superlative",
    "ExistsFrame", "Localize", "Temporal", "FilterFrame", "decoder",
)
_FAMILY_INDEX = {f: i for i, f in enumerate(FAMILIES)}
_UNTRACKED = len(FAMILIES)
_OPCODE_FAMILY = [_UNTRACKED] * (max(Opcode) + 1)
for _op, _fam in OP_FAMILY.items():
    _OPCODE_FAMILY[int(_op)] = _FAMILY_INDEX.get(_fam, _UNTRACKED)

_EPS = 1e-6


def _soft_attention_ce(pred, gold, mask):
    """Per-frame binary soft CE, masked mean over frames."""
    pred = torch.clamp(pred, _EPS, 1.0 - _EPS)
    per_frame = -(gold * torch.log(pred) + (1.0 - gold) * torch.log(1.0 - pred))
    return torch.sum(per_frame * mask, dim=-1) / torch.clamp(
        torch.sum(mask, dim=-1), min=1.0)


def encode_class_table(model, batch, params=None):
    """Text-encode and L2-normalize the batch's gold class strings, without
    gradient."""
    if params is None:
        params = model.param_tree()
    with torch.no_grad():
        p = tree_map(lambda x: x.detach(), params)
        reps = model.encode_sentences(batch["class_emb"],
                                      batch["class_emb_mask"], p)
        return l2_normalize(reps, dim=-1)


def filterframe_loss(model, out, batch, params=None, rank=None):
    """BCE between the softmaxed [F, object_types] FilterFrame grid and the
    gold occurrence grid over the batch's packed FilterFrame slots; returns
    (sum, count). On data-parallel rank ``rank`` the slot table carries
    global example indices while ``out`` holds the rank's shard: they are
    mapped to local indices and the slots of other shards are zeroed (each
    slot is counted by one rank; the step's sum over the ranks restores the
    global sums)."""
    if batch.get("ff_index") is None:
        zero = torch.zeros((), device=out["logits"].device)
        return zero, zero
    if params is None:
        params = model.param_tree()
    tr = batch["trace"]
    rf = out["regs_frames"]
    ffb = batch["ff_index"][:, 0].long()
    fft = batch["ff_index"][:, 1].long()
    valid = batch["ff_valid"]
    if rank is not None:
        B = rf.shape[0]
        ffb = ffb - rank * B
        in_shard = (ffb >= 0) & (ffb < B)
        valid = valid * in_shard.to(valid.dtype)
        ffb = torch.clamp(ffb, 0, B - 1)
    frames_out = rf[ffb, tr["out_frames"][ffb, fft].long()]   # [S, F, H]
    logits = linear(params["modules"]["heads"]["filterframe"], frames_out)
    pred = torch.clamp(torch.softmax(logits, dim=-1), _EPS, 1.0 - _EPS)
    gold = batch["ff_gold"]
    bce = -(gold * torch.log(pred) + (1.0 - gold) * torch.log(1.0 - pred))
    per_slot = torch.mean(bce, dim=(1, 2))
    return torch.sum(per_slot * valid), torch.sum(valid)


def supervision_losses(model, out, batch, train_filterframe=False,
                       contrastive_window=0, params=None, class_reps=None,
                       rank=None, axis_size=1):
    """All intermediate losses and the decoder CE.

    Returns (scalars, telemetry): ``module_loss`` and ``decoder_loss``
    (means per example), and per-family loss sums and counts (length
    ``len(FAMILIES)``). ``contrastive_window`` > 0 restricts each example's
    contrastive negatives to the classes of its window-sized group.
    ``class_reps`` is the batch's ``encode_class_table`` when the caller
    has it already (the eval step encodes the table once for this and
    ``eval_contrastive_similarity``). On data-parallel rank ``rank`` of
    ``axis_size`` the batch is the rank's contiguous shard: the window is
    compared with the global batch ``B * axis_size`` (with the window equal
    to the shard, its one group is the global window group), and the
    FilterFrame slots are remapped (``filterframe_loss``). ``rank`` None
    is one device."""
    if params is None:
        params = model.param_tree()
    tr = batch["trace"]
    rv, ra = out["regs_vec"], out["regs_attn"]
    op = tr["opcode"].long()
    B, T = op.shape
    dev = rv.device
    bidx = torch.arange(B, device=dev)[:, None]
    ch = batch["sup_channel"]
    vmask = batch["video_mask"]

    vec_out = rv[bidx, tr["out_vec"].long()]                  # [B, T, H]
    fam = torch.tensor(_OPCODE_FAMILY, device=dev)[op]        # [B, T]
    n_fam = len(FAMILIES)
    loss_sums = torch.zeros(n_fam + 1, device=dev)
    loss_counts = torch.zeros(n_fam + 1, device=dev)

    def scatter_family(sums, counts, losses, mask):
        w = mask.to(losses.dtype)
        idx = fam.reshape(-1)
        sums = sums.index_add(0, idx, (losses * w).reshape(-1))
        counts = counts.index_add(0, idx, w.reshape(-1))
        return sums, counts

    total = torch.zeros((), device=dev)
    zero = torch.zeros((), device=dev)

    # Exists / Xor: 2-way CE on the pretrain head
    heads = params["modules"]["heads"]
    logits_e = linear(heads["exists"], vec_out)
    logits_x = linear(heads["xor"], vec_out)
    logits2 = torch.where((op == int(Opcode.XOR))[..., None], logits_x,
                          logits_e)
    label = batch["sup_bool"].long()
    lse = torch.logsumexp(logits2, dim=-1)
    picked = torch.gather(logits2, -1, label[..., None])[..., 0]
    ce_bool = lse - picked
    mask_bool = ch == SUP_BOOL
    total = total + torch.sum(torch.where(mask_bool, ce_bool, zero))
    loss_sums, loss_counts = scatter_family(loss_sums, loss_counts, ce_bool,
                                            mask_bool)

    # Equals: MSE on the 1-logit head
    pred_eq = linear(heads["equals"], vec_out)[..., 0]
    mse_eq = torch.square(pred_eq - batch["sup_bool"])
    mask_eq = ch == SUP_EQUALS
    total = total + torch.sum(torch.where(mask_eq, mse_eq, zero))
    loss_sums, loss_counts = scatter_family(loss_sums, loss_counts, mse_eq,
                                            mask_eq)

    # Attention channels (Temporal's signal is its gated attention)
    attn_idx = torch.where(op == int(Opcode.TEMPORAL), tr["out_attn_b"],
                           tr["out_attn"]).long()
    attn_row0 = ra[bidx, attn_idx]
    attn_row1 = ra[bidx, tr["out_attn_b"].long()]
    gold = batch["sup_attn"]                                  # [B, T, 2, F]
    fmask = vmask[:, None, :]
    ce_row0 = _soft_attention_ce(attn_row0, gold[:, :, 0], fmask)
    mask_a1 = ch == SUP_ATTN1
    total = total + torch.sum(torch.where(mask_a1, ce_row0, zero))
    loss_sums, loss_counts = scatter_family(loss_sums, loss_counts, ce_row0,
                                            mask_a1)
    ce_row1 = _soft_attention_ce(attn_row1, gold[:, :, 1], fmask)
    rows = batch["sup_attn_rows"].float()
    ce_loc = torch.where(rows == 2, (ce_row0 + ce_row1) / 2.0, ce_row0)
    mask_a2 = ch == SUP_ATTN2
    total = total + torch.sum(torch.where(mask_a2, ce_loc, zero))
    loss_sums, loss_counts = scatter_family(loss_sums, loss_counts, ce_loc,
                                            mask_a2)

    # Contrastive (Filter / ToAction / Superlative)
    if class_reps is None:
        class_reps = encode_class_table(model, batch, params)  # [C, H]
    pred = l2_normalize(vec_out, dim=-1)
    sims = torch.einsum("bth,ch->btc", pred, class_reps)
    cls = batch["sup_class"].long()                           # [B, T, P]
    pair_valid = (cls >= 0) & (ch == SUP_CONTRAST)[..., None]
    neg_mask = batch["class_valid"][None, None, :] > 0
    if contrastive_window and contrastive_window < B * axis_size:
        W = contrastive_window
        G = -(-B // W)
        C = class_reps.shape[0]
        group_of_b = torch.arange(B, device=dev) // W
        flat_cls = torch.clamp(cls, min=0).reshape(B, -1)
        flat_ok = pair_valid.reshape(B, -1).long()
        gidx = group_of_b[:, None].expand_as(flat_cls)
        incidence = torch.zeros(G * C, dtype=torch.long, device=dev)
        incidence = incidence.index_add(
            0, (gidx * C + flat_cls).reshape(-1), flat_ok.reshape(-1))
        incidence = incidence.reshape(G, C)
        neg_mask = neg_mask & (incidence[group_of_b] > 0)[:, None, :]
    # Masked entries at the float32 minimum, not -inf: the same values on
    # every row with an unmasked entry, and zero (not NaN) gradients on
    # all-masked rows, which carry no valid pair (JAX's logsumexp gives 0).
    sims = torch.where(neg_mask, sims,
                       torch.full_like(sims, torch.finfo(sims.dtype).min))
    lse_c = torch.logsumexp(sims, dim=-1)
    picked_c = torch.gather(sims, -1, torch.clamp(cls, min=0))
    ce_cont = lse_c[..., None] - picked_c
    total = total + torch.sum(torch.where(pair_valid, ce_cont, zero))
    pair_count = torch.sum(pair_valid, dim=-1)
    step_cont = torch.sum(torch.where(pair_valid, ce_cont, zero), dim=-1) / \
        torch.clamp(pair_count, min=1)
    loss_sums, loss_counts = scatter_family(loss_sums, loss_counts,
                                            step_cont, pair_count > 0)

    # Decoder CE
    logits = out["logits"]
    dec_lse = torch.logsumexp(logits, dim=-1)
    if logits.shape[-1]:
        dec_picked = torch.gather(logits, -1,
                                  batch["answer"][:, None].long())[:, 0]
    else:
        # a multiple-choice corpus (STAR) has no open answers: JAX's
        # take_along_axis reads 0 on the empty axis, so the CE is -inf
        # there too; total_loss answers through the choice head instead
        dec_picked = torch.zeros_like(dec_lse)
    dec_ce = dec_lse - dec_picked
    decoder_loss = torch.mean(dec_ce)
    didx = _FAMILY_INDEX["decoder"]
    loss_sums = loss_sums.index_add(
        0, torch.tensor([didx], device=dev), torch.sum(dec_ce)[None])
    loss_counts = loss_counts.index_add(
        0, torch.tensor([didx], device=dev),
        torch.tensor([float(B)], device=dev))

    # FilterFrame (optional)
    ff_sum, ff_count = filterframe_loss(model, out, batch, params, rank)
    fidx = torch.tensor([_FAMILY_INDEX["FilterFrame"]], device=dev)
    loss_sums = loss_sums.index_add(0, fidx, ff_sum.reshape(1))
    loss_counts = loss_counts.index_add(0, fidx, ff_count.reshape(1))
    if train_filterframe:
        total = total + ff_sum

    scalars = {"module_loss": total / B, "decoder_loss": decoder_loss}
    telemetry = {"loss_sums": loss_sums[:n_fam],
                 "loss_counts": loss_counts[:n_fam]}
    return scalars, telemetry


def eval_contrastive_similarity(model, out, batch, params=None,
                                class_reps=None):
    """Cosine similarity of each supervised step's output to the mean gold
    class representation ('cont-valid'); returns (sum, count)."""
    tr = batch["trace"]
    rv = out["regs_vec"]
    B = rv.shape[0]
    bidx = torch.arange(B, device=rv.device)[:, None]
    vec_out = rv[bidx, tr["out_vec"].long()]
    if class_reps is None:
        class_reps = encode_class_table(model, batch, params)
    cls = batch["sup_class"].long()
    pair_valid = (cls >= 0) & (batch["sup_channel"] == SUP_CONTRAST)[..., None]
    reps = class_reps[torch.clamp(cls, min=0)]                 # [B, T, P, H]
    mean_gold = torch.sum(
        torch.where(pair_valid[..., None], reps, torch.zeros_like(reps)),
        dim=2) / torch.clamp(torch.sum(pair_valid, dim=2, keepdim=True), min=1)
    num = torch.sum(vec_out * mean_gold, dim=-1)
    den = torch.clamp(torch.linalg.norm(vec_out, dim=-1)
                      * torch.linalg.norm(mean_gold, dim=-1), min=1e-8)
    cos = num / den
    step_valid = torch.any(pair_valid, dim=-1)
    return (torch.sum(torch.where(step_valid, cos, torch.zeros_like(cos))),
            torch.sum(step_valid))


def total_loss(model, batch, generator, module_loss_weight,
               decoder_loss_weight, module_gate, decoder_gate,
               deterministic=False, train_filterframe=False,
               contrastive_window=0, rank=None, axis_size=1):
    """Full training objective; returns (loss, aux). With multiple-choice
    candidates (STAR) the answer objective is CE over the choice head.
    ``rank`` / ``axis_size``: the data-parallel rank and the number of
    ranks (``supervision_losses``); the loss is the mean over the rank's
    shard, and the ranks' mean is the global mean."""
    params = model.param_tree()
    out = model(batch, generator=generator, deterministic=deterministic)
    scalars, telemetry = supervision_losses(
        model, out, batch, train_filterframe=train_filterframe,
        contrastive_window=contrastive_window, params=params, rank=rank,
        axis_size=axis_size)
    answer_loss = scalars["decoder_loss"]
    if batch.get("cand_emb") is not None:
        logits = choice_logits(model, out, batch["cand_emb"],
                               batch["cand_mask"], batch["cand_valid"],
                               params)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              batch["answer"][:, None].long())[:, 0]
        answer_loss = torch.mean(lse - picked)
        scalars = dict(scalars, decoder_loss=answer_loss)
        out = dict(out, choice_logits=logits)
    loss = (module_loss_weight * module_gate * scalars["module_loss"]
            + decoder_loss_weight * decoder_gate * answer_loss)
    return loss, {"out": out, "scalars": scalars, "telemetry": telemetry}
