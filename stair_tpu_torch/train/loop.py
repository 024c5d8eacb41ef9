"""The NMN trainer (port of ``stair_tpu/train/loop.py``): the train and eval
steps, device-resident feature tables, the metrics stream, checkpoints with
resume, and the CLI.

One train step: the training forward (encoders and executor through their
forward/backward kernel pairs, dropout), ``total_loss``, ``backward``, and
an Adam update with the trainer's linear learning-rate schedule. Adam
follows ``optax.adam(lr_schedule)``: ``m_hat / (sqrt(v_hat) + 1e-8)`` with
the schedule read at the step count before the update, which is what
``torch.optim.Adam`` under ``ScheduleLR`` stepped after each update gives;
under ``--weight-decay`` it is ``torch.optim.AdamW``, as the JAX trainer
takes ``optax.adamw``. A parameter the loss does not reach gets a zero
gradient, as under optax, so its moments decay and AdamW decays it.
``args`` is the trainer's argument namespace (the port's own
``train/args.py``).

``main`` reads the JAX trainer's preprocessed ``.pkl`` splits, features and
GloVe file through the port's copy of ``data/dataset.py``, makes the same
batches, keeps the video features and the embedding table on the device
(``make_device_tables``; batches ship int32 indices and
``materialize_batch`` gathers on the device), trains, evaluates and writes
the JAX trainer's checkpoint files (``train/checkpoint.py``), so either
package resumes or evaluates the other's run. Metrics stay on the device
and are fetched once per report window.

``--mesh-dp N`` trains on ``N`` data-parallel ranks (``parallel/mesh.py``):
one card each with NCCL, or ``N`` CPU processes with gloo under ``--device
cpu``. Every rank takes its contiguous shard of each batch and runs the
kernels on it; the gradients are averaged and the loss scalars averaged
(the per-family sums summed) in one all-reduce, the dropout generator of
each rank is the step's folded with the rank, and Adam runs on every rank,
so the ranks keep equal parameters. Rank 0 alone prints, writes
``metrics.jsonl`` and checkpoints; a resume loads on every rank; the
evaluation runs per shard and gathers the predictions in example order.
``--mesh-tp`` replicates the NMN step (no rank is added; the numbers are
those of ``--mesh-tp 1``), as the JAX trainer's shard_map route does. A
batch that does not split into equal shards, or a contrastive window that
does not divide a rank's batch, is refused: the JAX trainer falls back to
GSPMD with its kernels off there, a route the port does not have.

Run: ``python -m stair_tpu_torch.train.loop --rgb-path ... --output ...
[--device cpu] [--executor mega|step|rev] [--mesh-dp N]``; without
``--device`` it runs on the first CUDA device (``N`` cards under
``--mesh-dp N``), and exits where there is none.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import time

import numpy as np
import torch

from stair_tpu_torch.data.dataset import (
    AGQADataset,
    Batcher,
    DataPaths,
    MSRVTTDataset,
    STARDataset,
    device_table_support,
)
from stair_tpu_torch.models.nmn import (
    EXECUTORS, NMNConfig, VideoNMN, choice_logits,
)
from stair_tpu_torch.parallel import mesh
from stair_tpu_torch.runtime.loader import device_prefetch
from stair_tpu_torch.train import checkpoint as ckpt
from stair_tpu_torch.train.args import build_parser
from stair_tpu_torch.train.losses import (
    FAMILIES,
    encode_class_table,
    eval_contrastive_similarity,
    supervision_losses,
    total_loss,
)
from stair_tpu_torch.utils.device import pick_device


def trainer_defaults(**overrides) -> argparse.Namespace:
    """The trainer CLI's argument defaults (``train/args.py``) as a namespace, with ``overrides`` applied."""
    parser = build_parser()
    ns = {a.dest: a.default for a in parser._actions if a.dest != "help"}
    ns.update(overrides)
    return argparse.Namespace(**ns)


def cli_parser() -> argparse.ArgumentParser:
    """``train/args.py``'s parser (the JAX trainer's options) plus the
    port's ``--device`` (default: the first CUDA device) and
    ``--executor``."""
    p = build_parser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--executor", default="mega", choices=EXECUTORS,
                   help="the NMN executor (models/nmn.py)")
    return p


def parse_cli(args):
    """``args`` as a namespace: None reads ``sys.argv``, a list is parsed
    with ``cli_parser``, a namespace passes through."""
    if args is None or isinstance(args, (list, tuple)):
        args = cli_parser().parse_args(args)
        if args.modules_no_intermediate_train is None:
            args.modules_no_intermediate_train = []
    return args


# ---------------------------------------------------------------------------
# schedule, optimizer, train step
# ---------------------------------------------------------------------------

def lr_schedule(args):
    """Linear start -> end factor of ``args.lr`` over total iters, then
    flat: step -> learning rate."""
    start, end = args.scheduler_start_factor, args.scheduler_end_factor
    total = max(1.0, float(args.scheduler_total_iters))

    def schedule(step):
        frac = min(float(step), total) / total
        return args.lr * (start + (end - start) * frac)

    return schedule


class ScheduleLR(torch.optim.lr_scheduler.LRScheduler):
    """Every group's learning rate is ``schedule(last_epoch)`` exactly, with
    ``last_epoch`` the number of updates made (optax's schedule count)."""

    def __init__(self, optimizer, schedule):
        self.schedule = schedule
        super().__init__(optimizer)

    def get_lr(self):
        return [self.schedule(self.last_epoch)
                for _ in self.optimizer.param_groups]

    def set_step(self, step: int):
        """Resume at ``step`` updates (a restored optimizer state)."""
        self.last_epoch = int(step)
        self._last_lr = self.get_lr()
        for group, lr in zip(self.optimizer.param_groups, self._last_lr):
            group["lr"] = lr


def make_optimizer(model, args):
    """``(Adam, ScheduleLR)`` over the model's parameters with the
    trainer's schedule (optax.adam's betas and eps), or ``AdamW`` with
    ``args.weight_decay`` when it is set (``optax.adamw``)."""
    sched = lr_schedule(args)
    wd = getattr(args, "weight_decay", 0.0) or 0.0
    kw = dict(lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
    opt = (torch.optim.AdamW(model.parameters(), weight_decay=wd, **kw)
           if wd else torch.optim.Adam(model.parameters(), **kw))
    return opt, ScheduleLR(opt, sched)


def metrics_of(loss, aux):
    return {
        "loss": loss,
        "decoder_loss": aux["scalars"]["decoder_loss"].detach(),
        "module_loss": aux["scalars"]["module_loss"].detach(),
        "loss_sums": aux["telemetry"]["loss_sums"].detach(),
        "loss_counts": aux["telemetry"]["loss_counts"].detach(),
    }


def make_train_step(model, args, optimizer=None, tables=None, dp=None):
    """-> ``train_step(batch, generator, module_gate, decoder_gate)``,
    which updates ``model`` in place and returns the step's metrics (on
    the device; nothing is fetched). ``optimizer`` is an ``(Adam,
    ScheduleLR)`` pair, ``make_optimizer``'s by default; with ``tables``
    (``make_device_tables``) the batch is materialized on the device
    first. With ``dp`` (a ``parallel.mesh.DataParallel`` rank) the batch is
    the rank's shard: the gradients and the loss scalars are averaged over
    the ranks and the per-family sums summed, in one all-reduce, before
    Adam (JAX's ``pmean`` / ``psum`` under ``shard_map``)."""
    opt, scheduler = optimizer or make_optimizer(model, args)
    train_filterframe = "FilterFrame" not in (
        args.modules_no_intermediate_train or [])
    window = getattr(args, "contrastive_window", 0) or 0
    rank, size = (dp.rank, dp.size) if dp is not None else (None, 1)

    def train_step(batch, generator, module_gate, decoder_gate):
        batch = materialize_batch(batch, tables)
        opt.zero_grad(set_to_none=True)
        loss, aux = total_loss(
            model, batch, generator,
            module_loss_weight=args.module_loss_weight,
            decoder_loss_weight=args.decoder_loss_weight,
            module_gate=module_gate, decoder_gate=decoder_gate,
            deterministic=False, train_filterframe=train_filterframe,
            contrastive_window=window, rank=rank, axis_size=size)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = metrics_of(loss.detach(), aux)
        if dp is not None:
            (loss_, dec, mod), (sums, counts) = dp.average_gradients(
                model.parameters(),
                means=(metrics["loss"], metrics["decoder_loss"],
                       metrics["module_loss"]),
                sums=(metrics["loss_sums"], metrics["loss_counts"]))
            metrics = {"loss": loss_[0], "decoder_loss": dec[0],
                       "module_loss": mod[0], "loss_sums": sums,
                       "loss_counts": counts}
        opt.step()
        scheduler.step()
        return metrics

    train_step.optimizer = opt
    train_step.scheduler = scheduler
    return train_step


# ---------------------------------------------------------------------------
# data: paths, datasets, batches, device tables
# ---------------------------------------------------------------------------

def data_paths(args) -> DataPaths:
    return DataPaths(
        rgb_path=args.rgb_path,
        flow_path=args.flow_path,
        glove_filename=args.glove_filename,
        vocab_filename=args.vocab_filename,
        video_secs_path=args.video_secs_path,
        train_filename=args.train_filename,
        valid_filename=args.valid_filename,
        test_filename=args.test_filename,
        str2num_path=args.str2num_path,
        word2id_filename=args.word2id_filename,
    )


DATASET_CLASSES = {
    "AGQA": AGQADataset, "STAR": STARDataset, "MSRVTT": MSRVTTDataset,
    # NEXTQA records (merge_json_records) share STAR's multiple-choice shape.
    "NEXTQA": STARDataset,
}


def _base_device_dict(batch) -> dict:
    d = {
        "answer": batch.answer,
        "trace": batch.trace,
        "root_reg": batch.root_reg,
        "root_is_vec": batch.root_is_vec,
        "sup_channel": batch.sup_channel,
        "sup_bool": batch.sup_bool,
        "sup_attn_rows": batch.sup_attn_rows,
        "class_valid": batch.class_valid,
        "sup_class": batch.sup_class,
        "ff_index": batch.ff_index,
        "ff_gold": batch.ff_gold,
        "ff_valid": batch.ff_valid,
    }
    if batch.question_ids is not None:
        d["question_ids"] = batch.question_ids
        d["video_idx"] = batch.video_idx
        d["video_clip"] = batch.video_clip
        d["sup_attn_enc"] = batch.sup_attn_enc
        d["sup_attn_w"] = batch.sup_attn_w
        d["class_token_ids"] = batch.class_token_ids
        if batch.cand_ids is not None:
            d["cand_ids"] = batch.cand_ids
            d["cand_valid"] = batch.cand_valid
    else:
        d["sup_attn"] = batch.sup_attn
        d["class_emb"] = batch.class_emb
        d["class_emb_mask"] = batch.class_emb_mask
        d["question"] = batch.question
        d["question_mask"] = batch.question_mask
        d["video"] = batch.video
        d["video_mask"] = batch.video_mask
    return d


def batch_to_device_dict(batch) -> dict:
    """A packed ``Batch`` -> the dict of numpy arrays the steps read."""
    d = _base_device_dict(batch)
    if batch.aux_emb is not None:
        d["aux_emb"] = batch.aux_emb
        d["aux_mask"] = batch.aux_mask
    if batch.cand_emb is not None:
        d["cand_emb"] = batch.cand_emb
        d["cand_mask"] = batch.cand_mask
        d["cand_valid"] = batch.cand_valid
    return d


def _device_batches(batcher, device, shuffle, dp=None):
    """Yield ``(batch, device dict)``: a worker thread packs each batch and
    starts its host-to-device copy (pinned, on a side stream on the card),
    so batch N+1 crosses while batch N computes. With ``dp`` only the
    rank's shard of the dict crosses (``parallel.mesh.shard_batch``)."""
    def dicts():
        for b in batcher.epoch(shuffle=shuffle):
            d = batch_to_device_dict(b)
            yield b, (d if dp is None else
                      mesh.shard_batch(d, dp.rank, dp.size))

    return device_prefetch(dicts(), device)


def make_device_tables(ds, device) -> dict | None:
    """Upload the dataset's video features and word embeddings once: the
    video table [n, F, D], its lengths [n] and the embedding table [V, dim]
    on ``device``. Every OOV row is minted before the upload (questions,
    candidates and gold class names, which can hold words no question
    uses), so the table is final. None when the dataset has no feature
    arena."""
    if device_table_support(ds) is None:
        return None
    table, lens, _ = ds.device_video_table()
    for i, rec in enumerate(ds.records):
        ds.question_token_ids(i)
        if hasattr(ds, "candidate_token_ids"):
            ds.candidate_token_ids(i)
        for gold in (rec.get("sg_res_by_step") or {}).values():
            names = (
                [gold] if isinstance(gold, str) else
                [g for g in gold if isinstance(g, str)]
                if isinstance(gold, list) else []
            )
            for name in names:
                ds.text_token_ids_cached(name)
    emb = ds.embeddings.embedding_table()

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return {
        "video_table": put(table),
        "video_len": put(lens),
        "embed_table": put(emb.astype(np.float32)),
    }


def _embed(table, ids):
    """Rows of ``table`` at ``ids`` (``-1`` pads read as zeros)."""
    rows = table[torch.clamp(ids, min=0).long()]
    zero = torch.zeros((), device=rows.device)
    return torch.where(ids[..., None] >= 0, rows, zero)


def materialize_batch(batch: dict, tables: dict | None) -> dict:
    """Rebuild the question, video, gold-attention and class tensors of a
    device-table batch from the device tables (bit-identical to the JAX
    function in float32, and so to the host-packed batch): the
    clip-shifted video gather with its mask, the question, class and
    candidate embeddings from ids, and the gold spans rasterised from
    ``sup_attn_enc`` / ``sup_attn_w``. Other batches pass through."""
    if tables is None or batch.get("video_idx") is None:
        return batch
    vid = batch["video_idx"].long()
    F = tables["video_table"].shape[1]
    dev = vid.device
    # Per-question frame range [lo, hi): plain datasets ship (0, length),
    # STAR ships the question's clip; both are a shifted gather.
    lo = batch["video_clip"][:, 0]
    hi = batch["video_clip"][:, 1]
    pos = torch.arange(F, device=dev)[None, :]
    idx = torch.clamp(lo[:, None] + pos, max=F - 1).long()
    video = tables["video_table"][vid[:, None], idx]
    vmask = (pos < (hi - lo)[:, None]).float()
    video = video * vmask[:, :, None]
    ids = batch["question_ids"]
    # the encoded gold spans (dataset.encode_span): interior frames
    # [lo, hi) get 1.0 plus two host-computed fractional writes
    enc = batch["sup_attn_enc"]                 # [B, T, 2, 4] int32
    w = batch["sup_attn_w"]                     # [B, T, 2, 2] f32
    fpos = torch.arange(F, dtype=torch.int32, device=dev)
    interior = ((fpos >= enc[..., 0:1]) & (fpos < enc[..., 1:2])).float()
    sup_attn = (interior + w[..., 0:1] * (fpos == enc[..., 2:3])
                + w[..., 1:2] * (fpos == enc[..., 3:4]))
    cls = batch["class_token_ids"]
    out = dict(
        batch, video=video, video_mask=vmask,
        question=_embed(tables["embed_table"], ids),
        question_mask=(ids >= 0).float(), sup_attn=sup_attn,
        class_emb=_embed(tables["embed_table"], cls),
        class_emb_mask=(cls >= 0).float(),
    )
    if batch.get("cand_ids") is not None:
        cids = batch["cand_ids"]
        out["cand_emb"] = _embed(tables["embed_table"], cids)
        out["cand_mask"] = (cids >= 0).float()
    return out


def load_datasets(args):
    """The trainer's ``(train, valid)`` datasets (``--debug``: the train
    set twice)."""
    paths = data_paths(args)
    ds_cls = DATASET_CLASSES[args.dataset]
    train_ds = ds_cls(
        paths, "train", max_video_length=args.max_video_length,
        novel_comp=args.novel_comp, more_steps=args.more_steps,
        debug=args.debug, seed=args.rand_seed,
        shuffle_video=bool(args.shuffle_video),
        use_prog_word_embeddings=args.use_prog_word_embeddings,
    )
    valid_ds = train_ds if args.debug else ds_cls(
        paths, "valid", max_video_length=args.max_video_length,
        novel_comp=args.novel_comp, more_steps=args.more_steps,
        use_prog_word_embeddings=args.use_prog_word_embeddings,
    )
    return train_ds, valid_ds


def build_model(args, datasets, device=None, executor="mega",
                generator=None) -> tuple[VideoNMN, dict]:
    """The model the flags and the corpora ask for: widths from ``args``
    and the first dataset, trace geometry covering every dataset."""
    steps = vec = fr = at = 1
    for ds in datasets:
        s, v, f, a = ds.trace_geometry()
        steps, vec, fr, at = (
            max(steps, s), max(vec, v), max(fr, f), max(at, a),
        )
    ds0 = datasets[0]
    cfg = NMNConfig(
        hidden_size=args.hidden_size,
        video_size=ds0.video_size,
        text_size=ds0.embeddings.dim,
        dropout=args.dropout,
        answer_vocab_length=ds0.answer_vocab_length,
        max_video_length=args.max_video_length,
        object_types=max(1, len(ds0.id2index)),
        have_pretrain_head=args.module_loss_weight != 0,
        filter_attention=args.filter_attention,
        encoder=args.encoder,
        max_steps=steps, num_vec=vec, num_frames=fr, num_attn=at,
    )
    model = VideoNMN(cfg, generator=generator, device=device,
                     executor=executor)
    return model, cfg.to_dict()


def make_batcher(args, ds, model, seed=0, device_tables=False):
    cfg = model.config
    return Batcher(
        ds,
        batch_size=args.batch_size,
        max_steps=cfg.max_steps,
        num_vec=cfg.num_vec,
        num_frames=cfg.num_frames,
        num_attn=cfg.num_attn,
        max_question_len=args.max_question_len,
        seed=seed,
        device_tables=device_tables,
    )


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def make_eval_step(model, tables=None, keep_regs=False, dp=None):
    """-> ``eval_step(batch)``: the deterministic forward, then (when the
    model has the pretrain heads) ``supervision_losses`` and
    ``eval_contrastive_similarity`` on one encoding of the class table,
    and the predictions (``choice_logits`` for multiple-choice batches).
    Returns device tensors: preds, loss_sums, loss_counts, cos_sum,
    cos_count, and ``regs_vec`` with ``keep_regs``. With ``dp`` the batch
    is the rank's shard: the predictions of every rank come back in
    example order (all-gather) and the sums are summed over the ranks."""
    if keep_regs and dp is not None:
        raise ValueError("keep_regs reads one device's register files")
    rank = dp.rank if dp is not None else None
    has_heads = "heads" in model.param_tree()["modules"]
    n_fam = len(FAMILIES)

    def eval_step(batch):
        batch = materialize_batch(batch, tables)
        with torch.no_grad():
            out = model(batch)
            dev = out["logits"].device
            if has_heads:
                params = model.param_tree()
                reps = encode_class_table(model, batch, params)
                _, telemetry = supervision_losses(model, out, batch,
                                                  params=params,
                                                  class_reps=reps, rank=rank)
                cos_sum, cos_count = eval_contrastive_similarity(
                    model, out, batch, params, class_reps=reps)
            else:
                # no pretrain heads (module_loss_weight 0): predictions only
                telemetry = {"loss_sums": torch.zeros(n_fam, device=dev),
                             "loss_counts": torch.zeros(n_fam, device=dev)}
                cos_sum = cos_count = torch.zeros((), device=dev)
            if batch.get("cand_emb") is not None:
                logits = choice_logits(model, out, batch["cand_emb"],
                                       batch["cand_mask"], batch["cand_valid"])
            else:
                logits = out["logits"]
        res = {
            "preds": torch.argmax(logits, dim=-1),
            "loss_sums": telemetry["loss_sums"],
            "loss_counts": telemetry["loss_counts"],
            "cos_sum": cos_sum,
            "cos_count": cos_count,
        }
        if keep_regs:
            res["regs_vec"] = out["regs_vec"]
        if dp is not None:
            k = len(FAMILIES)
            sums = dp.all_reduce_sum(torch.cat([
                res["loss_sums"].float(), res["loss_counts"].float(),
                res["cos_sum"].float().reshape(1),
                res["cos_count"].float().reshape(1)]))
            res = {"preds": dp.all_gather(res["preds"]),
                   "loss_sums": sums[:k], "loss_counts": sums[k:2 * k],
                   "cos_sum": sums[2 * k], "cos_count": sums[2 * k + 1]}
        return res

    return eval_step


def evaluate_accuracy(batcher, eval_step, device, to_text=None, dp=None):
    """Accuracy (gold ``<UNK>`` counts as wrong, ref train_module.py:253),
    per-family mean losses (contrastive families report the cont-valid
    cosine) and the predictions; the results stay on the device until one
    fetch at the end. ``to_text(index, record)`` names each prediction and
    gold in ``preds_golds`` (default: its answer-vocabulary word). With
    ``dp`` each rank feeds its shard of every batch to ``eval_step``
    (``make_eval_step(..., dp=dp)``, which gathers the predictions), and
    every rank returns the same result."""
    ds = batcher.ds
    unk = ds.answer_vocab["word2id"].get("<UNK>", -1)
    id2w = ds.answer_vocab["id2word"]
    to_text = to_text or (lambda v, rec: id2w.get(v, v))
    preds, reals, golds, qa_ids, indices = [], [], [], [], []
    sums = counts = cos_sum = cos_count = 0
    for batch, bdict in _device_batches(batcher, device, shuffle=False,
                                        dp=dp):
        res = eval_step(bdict)
        real = batch.meta["real"]
        preds.append(res["preds"][:real])
        golds.append(batch.answer[:real])
        qa_ids.extend(batch.qa_ids[:real])
        indices.extend(batch.meta["indices"][:real])
        reals.append(real)
        sums = sums + res["loss_sums"]
        counts = counts + res["loss_counts"]
        cos_sum = cos_sum + res["cos_sum"]
        cos_count = cos_count + res["cos_count"]
    if not reals:
        return 0.0, {}, {"preds": [], "golds": [], "qa_ids": []}
    fetched = torch.cat([torch.cat(preds).double(), sums.double(),
                         counts.double(), cos_sum.double().reshape(1),
                         cos_count.double().reshape(1)]).cpu().numpy()
    n, k = sum(reals), len(FAMILIES)
    pred = fetched[:n].astype(np.int64)
    sums, counts = fetched[n:n + k], fetched[n + k:n + 2 * k]
    cos_sum, cos_count = fetched[n + 2 * k:]
    gold = np.concatenate(golds).astype(np.int64)
    correct = int(np.sum((pred == gold) & (gold != unk)))
    recs = [ds.records[j] for j in indices]
    preds_golds = {
        "preds": [to_text(int(p), r) for p, r in zip(pred, recs)],
        "golds": [to_text(int(g), r) for g, r in zip(gold, recs)],
        "qa_ids": qa_ids,
    }
    family_means = {
        fam: (sums[i] / counts[i]) if counts[i] else float("inf")
        for i, fam in enumerate(FAMILIES)
    }
    if cos_count:
        family_means["Filter_cosine"] = cos_sum / cos_count
    return correct / max(n, 1), family_means, preds_golds


class MetricsWriter:
    """JSONL metrics stream + optional TensorBoard mirror."""

    def __init__(self, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        self.f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(os.path.join(out_dir, "runs"))
        except Exception:
            pass

    def write(self, step: int, scalars: dict):
        rec = {"step": step, "time": time.time()}
        rec.update(scalars)
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb is not None:
            for key, val in scalars.items():
                if isinstance(val, (int, float)) and np.isfinite(val):
                    self.tb.add_scalar(key, val, step)

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()


# ---------------------------------------------------------------------------
# the dropout stream
# ---------------------------------------------------------------------------

def key_words(prng: str) -> int:
    """uint32 words of a JAX key of ``--prng``'s implementation."""
    return 2 if prng == "threefry2x32" else 4


def new_key(seed: int, prng: str) -> list[int]:
    """The run's first key: ``key_words(prng)`` uint32 values drawn from a
    generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2 ** 32, (key_words(prng),), generator=g,
                         dtype=torch.int64).tolist()


def _seed_of(raw: bytes) -> int:
    return int.from_bytes(hashlib.sha256(raw).digest()[:8], "little") >> 1


def split_key(key, rank=None) -> tuple[list[int], torch.Generator]:
    """``(next key, the step's generator)`` from a key (a list of uint32,
    the port's or a JAX trainer's): a generator seeded from the key's words
    draws both, so a run resumed from a saved key continues its stream.
    On data-parallel rank ``rank`` the step's seed is folded with the rank
    (JAX's ``fold_in(rng, axis_index)``), so shards never share masks; the
    next key is every rank's."""
    raw = b"".join(int(w).to_bytes(4, "little") for w in key)
    g = torch.Generator().manual_seed(_seed_of(raw))
    nxt = torch.randint(0, 2 ** 32, (len(key),), generator=g,
                        dtype=torch.int64).tolist()
    step_seed = int(torch.randint(0, 2 ** 62, (1,), generator=g))
    if rank is not None:
        step_seed = _seed_of(step_seed.to_bytes(8, "little")
                             + int(rank).to_bytes(4, "little"))
    return nxt, torch.Generator().manual_seed(step_seed)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _trainer_state(step, best_acc, key):
    return {"step": step, "best_acc": best_acc, "rng": [int(w) for w in key]}


def main(args=None, *, device=None, executor=None):
    """Train the NMN as ``python -m stair_tpu.train.loop`` does: on
    ``device`` (or ``--device``; default the first CUDA device) and
    ``executor`` (or ``--executor``; default ``"mega"``), on ``--mesh-dp``
    data-parallel ranks where it asks for more than one
    (``parallel.mesh.plan``). ``args`` is a namespace of ``train/args.py``'s
    options, a list of CLI words, or None for ``sys.argv``. Returns the
    best valid accuracy."""
    args = parse_cli(args)
    dev = pick_device(device or getattr(args, "device", None))
    executor = executor or getattr(args, "executor", None) or "mega"
    ranks = mesh.plan(args, dev)
    if ranks is None:
        return train(args, dev, executor)
    dp, devices, backend = ranks
    return mesh.launch(_train_rank, dp, devices, backend,
                       args=(args, executor))[0]


def _train_rank(dp, args, executor):
    return train(args, dp.device, executor, dp)


def train(args, dev, executor="mega", dp=None):
    """The trainer's body on one device, or on data-parallel rank ``dp``
    (a ``parallel.mesh.DataParallel``; only rank 0 writes). Returns the
    best valid accuracy."""
    lead = dp is None or dp.rank == 0
    print(args)
    train_ds, valid_ds = load_datasets(args)
    print(f"train={len(train_ds)} valid={len(valid_ds)} "
          f"dropped={train_ds.drop_reasons}")

    gen = torch.Generator().manual_seed(args.rand_seed)
    if args.config_filename:
        with open(args.config_filename) as f:
            config_dict = json.load(f)
        model = VideoNMN(NMNConfig(**config_dict), generator=gen, device=dev,
                         executor=executor)
    else:
        model, config_dict = build_model(args, [train_ds, valid_ds], dev,
                                         executor, gen)
    print("model config:", config_dict)
    if args.model_ckpt:
        print("loading checkpoint from", args.model_ckpt)
        ckpt.load_params(args.model_ckpt, model)
    if dp is not None:
        # every rank made or loaded the same weights; rank 0's are copied
        # to all, so the ranks start equal however the weights were made
        dp.broadcast_(model.parameters())
    opt, sched = make_optimizer(model, args)

    train_tables = valid_tables = None
    if args.device_tables != "off":
        train_tables = make_device_tables(train_ds, dev)
        valid_tables = (train_tables if valid_ds is train_ds
                        else make_device_tables(valid_ds, dev))
        if train_tables is not None:
            print("device tables: video features + embeddings resident "
                  "(batches ship int32 indices)")
    train_step = make_train_step(model, args, (opt, sched), train_tables, dp)
    eval_step = make_eval_step(model, valid_tables, dp=dp)
    train_batcher = make_batcher(args, train_ds, model, seed=args.rand_seed,
                                 device_tables=train_tables is not None)
    valid_batcher = make_batcher(args, valid_ds, model, seed=0,
                                 device_tables=valid_tables is not None)

    writer = None
    if lead:
        writer = MetricsWriter(args.output)
        from stair_tpu_torch.utils.snapshot import backup_code

        backup_code(args.output)
    print(f"model has {sum(p.numel() for p in model.parameters())} "
          "parameters")

    global_step, best_acc = 0, 0.0
    key = new_key(args.rand_seed, args.prng)
    latest = os.path.join(args.output, "latest")
    state = ckpt.load_trainer_state(latest)
    if state and args.model_ckpt:
        global_step, best_acc = state["step"], state["best_acc"]
        # Mid-run resume restores the Adam moments, the schedule's count
        # and the dropout stream, not just the parameters.
        restored = ckpt.load_opt_state(latest, model, opt, sched)
        if state.get("rng") is not None:
            key = [int(w) for w in state["rng"]]
        print(f"resuming at step {global_step} (optimizer state "
              f"{'restored' if restored is not None else 'not found'})")

    from stair_tpu_torch.utils import profiling

    timer = profiling.StepTimer()
    gc_timer = profiling.GCTimer()
    on_card = dev.type == "cuda"
    profile = contextlib.ExitStack()
    t_start = time.time()
    window, events = [], []
    t_wait = t_dispatch = 0.0
    rank = dp.rank if dp is not None else None

    def save(where):
        if lead:
            ckpt.save_checkpoint(
                os.path.join(args.output, where), model, config_dict,
                opt_state=ckpt.opt_state_tree(model, opt, sched),
                trainer_state=_trainer_state(global_step, best_acc, key))

    for _epoch in range(args.num_epochs):
        batches = iter(_device_batches(train_batcher, dev, shuffle=True,
                                       dp=dp))
        while True:
            t0 = time.perf_counter()
            try:
                _batch, bdict = next(batches)
            except StopIteration:
                break
            t_wait += time.perf_counter() - t0
            key, step_gen = split_key(key, rank)
            module_gate = float(global_step < args.train_module_before_iters)
            decoder_gate = float(
                global_step >= args.train_decoder_after_iters)
            if (lead and args.profile_dir
                    and global_step == args.profile_start):
                profile.enter_context(profiling.trace(args.profile_dir))
            t0 = time.perf_counter()
            if on_card:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            metrics = train_step(bdict, step_gen, module_gate, decoder_gate)
            if on_card:
                ev[1].record()
                events.append(ev)
            t_dispatch += time.perf_counter() - t0
            global_step += 1
            profile_end = args.profile_start + args.profile_steps
            if lead and args.profile_dir and global_step == profile_end:
                profile.close()
                print("wrote profiler trace to", args.profile_dir)
            timer.tick()
            window.append(metrics)

            if global_step % args.report_interval == 0 or global_step == 1:
                t0 = time.perf_counter()
                rows = torch.stack([torch.cat([
                    m["loss"].reshape(1), m["loss_sums"], m["loss_counts"]])
                    for m in window]).cpu().numpy()      # the one fetch
                t_fetch = time.perf_counter() - t0
                gc_s, gc_n = gc_timer.take()
                k = len(FAMILIES)
                sums = rows[:, 1:1 + k].sum(0)
                counts = rows[:, 1 + k:].sum(0)
                scalars = {
                    "loss/total": float(rows[:, 0].mean()),
                    "lr/lr": float(sched.get_last_lr()[0]),
                    "perf/steps_per_sec": len(window) / max(
                        time.time() - t_start, 1e-6),
                    # host-stall attribution for this window (ms)
                    "perf/batch_wait_ms": t_wait * 1e3,
                    "perf/dispatch_ms": t_dispatch * 1e3,
                    "perf/report_fetch_ms": t_fetch * 1e3,
                    "perf/gc_ms": gc_s * 1e3,
                    "perf/gc_collections": float(gc_n),
                }
                if events:
                    # CUDA-event span of a step, from its first launch to
                    # its last: the host paces it, so it is no device time
                    scalars["perf/step_event_ms"] = float(np.mean(
                        [a.elapsed_time(b) for a, b in events]))
                t_wait = t_dispatch = 0.0
                scalars.update(
                    {f"perf/{n}": v for n, v in timer.summary().items()})
                for i, fam in enumerate(FAMILIES):
                    if counts[i]:
                        scalars[f"loss/{fam}"] = float(sums[i] / counts[i])
                if lead:
                    writer.write(global_step, scalars)
                print(f"step {global_step} " + " ".join(
                    f"{n}={v:.4f}" for n, v in scalars.items()))
                window, events, t_start = [], [], time.time()

            if global_step % args.evaluate_interval == 0:
                acc, fam_means, preds_golds = evaluate_accuracy(
                    valid_batcher, eval_step, dev, dp=dp)
                scalars = {"valid/acc": acc}
                scalars.update({
                    f"valid/{n}": float(v) for n, v in fam_means.items()
                    if np.isfinite(v)
                })
                if lead:
                    writer.write(global_step, scalars)
                print(f"step {global_step} valid acc={acc:.4f}")
                if lead and args.result_filename:
                    with open(os.path.join(args.output, args.result_filename),
                              "w") as f:
                        json.dump(preds_golds, f)
                if acc > best_acc:
                    best_acc = acc
                    save("best_model")
                    print(f"saved best model (acc={acc:.4f})")
                save("latest")
    profile.close()

    # Final eval + save.
    acc, _, _ = evaluate_accuracy(valid_batcher, eval_step, dev, dp=dp)
    if lead:
        writer.write(global_step, {"valid/acc": acc})
    print(f"final valid acc={acc:.4f} (best={best_acc:.4f})")
    if acc >= best_acc:
        best_acc = acc
        save("best_model")
    save("latest")
    gc_timer.close()
    if lead:
        writer.close()
    return best_acc


if __name__ == "__main__":
    main()
