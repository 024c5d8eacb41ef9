"""Evaluation CLI (port of ``stair_tpu/train/evaluate.py``): test accuracy
and the Filter-output audit.

  * ``--evaluate-func acc`` — batched test accuracy (gold ``<UNK>`` counts
    as wrong) + predictions JSON {preds, golds, qa_ids};
  * ``--evaluate-func filter_text_result`` — for every Filter step of every
    question, the top-10 retrieval vocabulary strings by cosine similarity
    between the module's output and the text-encoded vocab, tagged with the
    module's tree level and its keyword argument. Output pickle:
    ``{qa_id: {source_idx: (level, keyword, top10)}}``.

Both go through the trainer's one eval step (``loop.make_eval_step``; the
audit reads the same step's vec register file). It reads the checkpoints
either package's trainer writes. ``--mesh-dp N`` evaluates the accuracy on
``N`` data-parallel ranks by the trainer's rule (``parallel/mesh.py
plan``): each rank runs its shard of every batch and the predictions are
gathered in example order; rank 0 writes the result file. The Filter audit
runs on one device, as the JAX CLI's does.

Run: ``python -m stair_tpu_torch.train.evaluate --model-ckpt DIR
--evaluate-func acc ... [--device cpu] [--mesh-dp N]``; without
``--device`` it runs on the first CUDA device, and exits where there is
none.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle

import numpy as np
import torch

from stair_tpu_torch.ir.lowering import Opcode
from stair_tpu_torch.models.modules import l2_normalize
from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
from stair_tpu_torch.parallel import mesh
from stair_tpu_torch.programs.parser import children_and_parents, module_levels
from stair_tpu_torch.train import checkpoint as ckpt
from stair_tpu_torch.train import loop
from stair_tpu_torch.utils.device import pick_device


def load_model(args, ds, device=None, executor="mega"):
    """The checkpoint's model with its trace geometry widened to cover the
    evaluation corpus (test programs may be deeper than train ones; the
    geometry does not change a parameter's shape)."""
    cfg_dict = ckpt.load_config(args.model_ckpt)
    s, v, f, a = ds.trace_geometry()
    cfg_dict["max_steps"] = max(cfg_dict["max_steps"], s)
    cfg_dict["num_vec"] = max(cfg_dict["num_vec"], v)
    cfg_dict["num_frames"] = max(cfg_dict["num_frames"], f)
    cfg_dict["num_attn"] = max(cfg_dict["num_attn"], a)
    model = VideoNMN(NMNConfig(**cfg_dict), device=device, executor=executor)
    ckpt.load_params(args.model_ckpt, model)
    return model


def _tables_and_batcher(args, model, ds, device):
    """Device tables when enabled, and a matching batcher."""
    tables = None
    if getattr(args, "device_tables", "auto") != "off":
        tables = loop.make_device_tables(ds, device)
    batcher = loop.make_batcher(args, ds, model,
                                device_tables=tables is not None)
    return tables, batcher


def evaluate_acc(args, model, ds, device, dp=None):
    id2w = ds.answer_vocab["id2word"]
    tables, batcher = _tables_and_batcher(args, model, ds, device)
    evaluable = len(batcher.indices)
    print(f"evaluable examples: {evaluable}/{len(ds)}"
          + (f" (unliftable programs: {ds.drop_reasons})"
             if ds.drop_reasons else ""))
    if evaluable == 0:
        print("nothing to evaluate: no example has a liftable program "
              "(check the parser output / --generated-format)")
        return 0.0
    # Multiple-choice datasets (STAR) predict through the choice head.
    multiple_choice = hasattr(ds, "candidates")

    def to_text(idx_val, rec):
        """Candidate text (multiple-choice) or vocab word (open-ended)."""
        if multiple_choice:
            cands = ds.candidates(rec)
            if 0 <= idx_val < len(cands):
                return cands[idx_val]
            return str(idx_val)
        return id2w.get(idx_val, str(idx_val))

    acc, _, preds_golds = loop.evaluate_accuracy(
        batcher, loop.make_eval_step(model, tables, dp=dp), device, to_text,
        dp=dp)
    total = len(preds_golds["qa_ids"])
    if args.result_filename and (dp is None or dp.rank == 0):
        out = os.path.join(args.output or ".", args.result_filename)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        payload = (star_format_test_output(preds_golds)
                   if args.dataset == "STAR" else preds_golds)
        with open(out, "w") as f:
            json.dump(payload, f)
    print(f"test acc: {acc:.4f} over {total} examples")
    return acc


def filter_text_results(args, model, ds, device):
    """Audit extraction: Filter-module retrievals against the answer vocab,
    from the vec register file of the eval step."""
    with open(args.filter_answer_vocab_filename) as f:
        filter_vocab = json.load(f)
    max_len = max(1, max(
        len(ds.embeddings.embed_sentence(a)) for a in filter_vocab))
    emb = np.zeros((len(filter_vocab), max_len, ds.embeddings.dim), np.float32)
    emb_mask = np.zeros((len(filter_vocab), max_len), np.float32)
    for i, ans in enumerate(filter_vocab):
        e = ds.embeddings.embed_sentence(ans)[:max_len]
        emb[i, : len(e)] = e
        emb_mask[i, : len(e)] = 1.0
    with torch.no_grad():
        vocab_reps = l2_normalize(model.encode_sentences(
            torch.from_numpy(emb).to(device),
            torch.from_numpy(emb_mask).to(device)), dim=-1)   # [V, H]
    vocab_np = vocab_reps.float().cpu().numpy()

    tables, batcher = _tables_and_batcher(args, model, ds, device)
    step = loop.make_eval_step(model, tables, keep_regs=True)
    results = {}
    for batch, bdict in loop._device_batches(batcher, device, shuffle=False):
        regs_vec = step(bdict)["regs_vec"].cpu().numpy()
        for b in range(batch.meta["real"]):
            idx = batch.meta["indices"][b]
            rec, tr = ds.records[idx], ds.traces[idx]
            program = rec["nmn_program"]
            levels = module_levels(program)
            kids, _ = children_and_parents(program)
            per_step = {}
            for ins in tr.instrs:
                if ins.opcode not in (Opcode.FILTER_V, Opcode.FILTER_K):
                    continue
                pred = regs_vec[b, ins.out_vec]
                norm = np.linalg.norm(pred) * np.linalg.norm(vocab_np, axis=1)
                sims = (vocab_np @ pred) / np.maximum(norm, 1e-8)
                top10 = [filter_vocab[i] for i in np.argsort(-sims)[:10]]
                pos = ins.token_pos
                keyword = program[kids[pos][1]].replace("_", " ")
                src = ins.src if ins.src >= 0 else pos
                per_step[src] = (levels[pos], keyword, top10)
            results[rec.get("qa_id", idx)] = per_step
    os.makedirs(os.path.dirname(args.result_filename) or ".", exist_ok=True)
    with open(args.result_filename, "wb") as f:
        pickle.dump(results, f)
    print(f"wrote filter results for {len(results)} questions")
    return results


def star_format_test_output(preds_golds: dict) -> dict:
    """Group STAR predictions by question type for the online evaluator.
    ref: evaluate.py:21-25"""
    out = {k: [] for k in ("Interaction", "Sequence", "Prediction",
                           "Feasibility")}
    for qa_id, pred in zip(preds_golds["qa_ids"], preds_golds["preds"]):
        key = str(qa_id).split("_")[0]
        out.setdefault(key, []).append({"question_id": qa_id, "answer": pred})
    return out


def main(args=None, *, device=None, executor=None):
    """Evaluate as ``python -m stair_tpu.train.evaluate`` does: on
    ``device`` (or ``--device``; default the first CUDA device), and for
    ``acc`` on ``--mesh-dp`` data-parallel ranks where it asks for more
    than one. ``args`` as ``loop.main``'s."""
    args = loop.parse_cli(args)
    dev = pick_device(device or getattr(args, "device", None))
    executor = executor or getattr(args, "executor", None) or "mega"
    print("EVALUATE:", datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    ranks = mesh.plan(args, dev)
    if ranks is not None and args.evaluate_func == "acc":
        dp, devices, backend = ranks
        return mesh.launch(_evaluate_rank, dp, devices, backend,
                           args=(args, executor))[0]
    return evaluate(args, dev, executor)


def _evaluate_rank(dp, args, executor):
    return evaluate(args, dp.device, executor, dp)


def evaluate(args, dev, executor="mega", dp=None):
    """The evaluate CLI's body on one device, or for ``acc`` on
    data-parallel rank ``dp``."""
    ds = loop.DATASET_CLASSES[args.dataset](
        loop.data_paths(args), "test", max_video_length=args.max_video_length,
        use_prog_word_embeddings=args.use_prog_word_embeddings,
    )
    # --start-index/--end-index: evaluate a slice (ref args.py:68-69).
    end = args.end_index if args.end_index >= 0 else len(ds.records)
    if args.start_index or end < len(ds.records):
        ds.records = ds.records[args.start_index:end]
        ds.traces = ds.traces[args.start_index:end]
        print(f"evaluating slice [{args.start_index}:{end}]")
    model = load_model(args, ds, dev, executor)
    if args.evaluate_func == "acc":
        return evaluate_acc(args, model, ds, dev, dp)
    if args.evaluate_func == "filter_text_result":
        return filter_text_results(args, model, ds, dev)
    raise ValueError(f"unknown evaluate func {args.evaluate_func}")


if __name__ == "__main__":
    main()
