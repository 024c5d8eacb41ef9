"""CLI: train/evaluate the video-prefix LM on AGQA records (port of
``stair_tpu/llm/with_video_lm.py``).

Records + npy video features + optional STAIR filter-output pickles in,
answer exact-match out. ``--lm-model VideoGPT`` uses the GPT-2-class
decoder, ``--lm-model Llama`` the Llama-class one (prompt template
'Question: %s Answer:'); ``--bert-path`` loads a local HF tokenizer when
given, otherwise a word-level tokenizer and fresh weights are used
(air-gapped mode). AdamW (weight decay 1e-4, optax's default) under a
linear schedule to 0; ``--llm-lora`` adds q/v adapters to the Llama
decoder; ``--gpt-video-loss-weight`` adds the next-frame regression, whose
forward and backward run the attention kernels with ``prefix_len > 0``.
The best epoch on the validation split is saved (``params.msgpack``,
``config.json``, ``tokenizer.json``) and ``--func test --model-ckpt DIR``
loads it.

Run: ``python -m stair_tpu_torch.llm.with_video_lm --func train ...`` (on
the first CUDA device unless ``--device cpu`` is given).
"""

from __future__ import annotations

import json
import os
import pickle
import time

import numpy as np
import torch

from stair_tpu_torch.data.dataset import load_video_features
from stair_tpu_torch.llm.decoder import DecoderConfig
from stair_tpu_torch.llm.optim import linear_schedule, make_adamw, make_step
from stair_tpu_torch.llm.video_prefix import (
    SimpleTokenizer,
    VideoPrefixConfig,
    VideoPrefixLM,
    answer_exact_match,
    load_tokenizer,
    pack_text_batch,
    splice_filter_outputs,
)
from stair_tpu_torch.runtime.loader import device_prefetch
from stair_tpu_torch.train.checkpoint import load_params, save_params
from stair_tpu_torch.utils.device import pick_device


def load_records(filename, novel_comp=None, more_steps=None):
    with open(filename, "rb") as f:
        records = pickle.load(f)
    if novel_comp is not None:
        records = [r for r in records if r.get("novel_comp") == novel_comp]
    if more_steps is not None:
        records = [r for r in records if r.get("more_steps") == more_steps]
    return records


def load_filter_outputs(path_template, split):
    """Shard-aware filter-result pickle loading."""
    if not path_template:
        return None
    merged = {}
    if "%d" in path_template:
        i = 0
        while True:
            path = path_template % (split, i)
            if not os.path.exists(path):
                break
            with open(path, "rb") as f:
                merged.update(pickle.load(f))
            i += 1
    else:
        path = path_template % split if "%s" in path_template else path_template
        if os.path.exists(path):
            with open(path, "rb") as f:
                merged.update(pickle.load(f))
    return merged or None


class VideoLMData:
    def __init__(self, args, split, tokenizer=None):
        self.args = args
        self.records = load_records(
            {"train": args.train_filename, "valid": args.valid_filename,
             "test": args.test_filename}[split],
            args.novel_comp, args.more_steps,
        )
        used = {r["video_id"] for r in self.records}
        self.video_feats = load_video_features(
            args.rgb_path, None, used, args.max_video_length
        )
        self.video_size = next(iter(self.video_feats.values())).shape[-1]
        self.filter_outputs = load_filter_outputs(
            args.gpt_filter_result_path, split
        )
        prompt = (
            "Question: %s Answer:" if args.lm_model == "Llama" else "%s"
        )
        self.questions = []
        self.answers = []
        for rec in self.records:
            q = splice_filter_outputs(
                prompt % rec["question"],
                (self.filter_outputs or {}).get(rec.get("qa_id")),
                max_per_module=args.gpt_max_per_filter_module,
                max_total=args.gpt_max_filter_output_list_length,
                by_level=args.gpt_filter_output_by_level,
            )
            self.questions.append(q)
            self.answers.append(str(rec["answer"]))
        self.tokenizer = tokenizer or load_tokenizer(
            args.bert_path, corpus_texts=self.questions + self.answers
        )

    def __len__(self):
        return len(self.records)

    def batches(self, batch_size, max_text_len, Fmax, shuffle=True, seed=0):
        order = np.arange(len(self.records))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        total_len = Fmax + max_text_len
        for i in range(0, len(order), batch_size):
            idx = list(order[i:i + batch_size])
            while len(idx) < batch_size:
                idx.append(idx[len(idx) % max(1, len(idx))])
            real = min(batch_size, len(order) - i)
            video = np.zeros((batch_size, Fmax, self.video_size), np.float32)
            video_len = np.zeros((batch_size,), np.int32)
            for b, j in enumerate(idx):
                v = self.video_feats[self.records[j]["video_id"]][:Fmax]
                video[b, : len(v)] = v
                video_len[b] = len(v)
            token_ids, text_len, labels = pack_text_batch(
                self.tokenizer,
                [self.questions[j] for j in idx],
                [self.answers[j] for j in idx],
                max_text_len, video_len, total_len,
            )
            yield {
                "video": video, "video_len": video_len,
                "token_ids": token_ids, "text_len": text_len,
                "labels": labels, "real": real,
                "qa_ids": [self.records[j].get("qa_id") for j in idx],
            }


def build_lm(args, video_size, vocab_size, generator=None, device=None):
    if args.lm_model == "Llama":
        dec = DecoderConfig.llama(
            vocab_size=vocab_size, d_model=args.hidden_size,
            num_heads=max(2, args.hidden_size // 64),
            num_layers=args.lm_layers, d_ff=args.hidden_size * 3,
            max_len=args.max_video_length + args.tokenizer_max_length,
            lora_rank=8 if args.llm_lora else 0,
        )
    else:
        dec = DecoderConfig.gpt2(
            vocab_size=vocab_size, d_model=args.hidden_size,
            num_heads=max(2, args.hidden_size // 64),
            num_layers=args.lm_layers, d_ff=args.hidden_size * 4,
            max_len=args.max_video_length + args.tokenizer_max_length,
        )
    cfg = VideoPrefixConfig(
        video_size=video_size, decoder=dec,
        max_video_length=args.max_video_length,
        max_text_length=args.tokenizer_max_length,
    )
    model = VideoPrefixLM(cfg, generator=generator)
    return model.to(device) if device is not None else model


def _device_batch(batch):
    return {k: batch[k] for k in
            ("video", "video_len", "token_ids", "text_len", "labels")}


def _adds_lora(args):
    return bool(args.llm_lora) and args.lm_model == "Llama"


@torch.no_grad()
def evaluate(model, data, args, Fmax, device):
    hits, losses = [], []
    batches = data.batches(args.batch_size, args.tokenizer_max_length, Fmax,
                           shuffle=False)
    for batch in device_prefetch(batches, device):
        loss, logits = model.reply_loss(batch)
        losses.append(float(loss))
        hits.extend(answer_exact_match(
            logits, batch["labels"].cpu().numpy())[: batch["real"]])
    acc = float(np.mean(hits)) if hits else 0.0
    return acc, float(np.mean(losses))


def make_lm_step(model, optimizer, video_loss_weight=0):
    """``step(batch) -> loss``: the reply loss, plus ``video_loss_weight``
    times the video loss when that is not 0; backward and one AdamW update
    (``optim.make_adamw``'s pair)."""
    def loss_fn(batch):
        loss, _ = model.reply_loss(batch)
        if video_loss_weight:
            loss = loss + video_loss_weight * model.video_loss(batch)
        return loss

    return make_step(loss_fn, optimizer)


def train(args):
    device = pick_device(getattr(args, "device", None))
    train_data = VideoLMData(args, "train")
    valid_data = VideoLMData(args, "valid", tokenizer=train_data.tokenizer)
    Fmax = args.max_video_length
    model = build_lm(
        args, train_data.video_size, len(train_data.tokenizer),
        generator=torch.Generator().manual_seed(args.rand_seed),
        device=device)
    if _adds_lora(args):
        # as in the JAX trainer the base is not frozen: adapters and base
        # train together
        model.decoder.add_lora(torch.Generator().manual_seed(1))

    steps_per_epoch = max(1, len(train_data) // args.batch_size)
    schedule = linear_schedule(args.lr, 0.0, steps_per_epoch * args.num_epochs)
    optimizer = make_adamw(model.parameters(), schedule, weight_decay=1e-4)
    train_step = make_lm_step(model, optimizer, args.gpt_video_loss_weight)

    os.makedirs(args.output, exist_ok=True)
    best_acc, step_i = 0.0, 0
    t0 = time.time()
    for epoch in range(args.num_epochs):
        for dbatch in device_prefetch(
            (_device_batch(batch) for batch in train_data.batches(
                args.batch_size, args.tokenizer_max_length, Fmax,
                shuffle=True, seed=args.rand_seed + epoch,
            )), device
        ):
            loss = train_step(dbatch)
            step_i += 1
            if step_i % args.report_interval == 0:
                print(f"step {step_i} loss {float(loss):.4f} "
                      f"({step_i / (time.time() - t0):.2f} it/s)")
        acc, vloss = evaluate(model, valid_data, args, Fmax, device)
        print(f"epoch {epoch}: valid acc {acc:.4f} loss {vloss:.4f}")
        if acc >= best_acc:
            best_acc = acc
            save(args.output, model, train_data.tokenizer, args)
    print(f"best valid acc {best_acc:.4f}")
    return best_acc


def save(out_dir, model, tokenizer, args):
    save_params(out_dir, model.param_tree())
    cfg = {
        "lm_model": args.lm_model, "hidden_size": args.hidden_size,
        "lm_layers": args.lm_layers,
        "max_video_length": args.max_video_length,
        "tokenizer_max_length": args.tokenizer_max_length,
        "video_size": model.config.video_size,
        "vocab_size": model.config.decoder.vocab_size,
        "llm_lora": int(_adds_lora(args)),
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    if hasattr(tokenizer, "word2id"):
        with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
            json.dump({"word2id": tokenizer.word2id,
                       "eos": tokenizer.eos_token_id,
                       "pad": tokenizer.pad_token_id}, f)


def test(args):
    device = pick_device(getattr(args, "device", None))
    with open(os.path.join(args.model_ckpt, "config.json")) as f:
        cfg = json.load(f)
    tok_path = os.path.join(args.model_ckpt, "tokenizer.json")
    tokenizer = None
    if os.path.exists(tok_path):
        with open(tok_path) as f:
            t = json.load(f)
        tokenizer = SimpleTokenizer(t["word2id"], t["eos"], t["pad"])
    for k in ("lm_model", "hidden_size", "lm_layers", "max_video_length",
              "tokenizer_max_length"):
        setattr(args, k, cfg[k])
    # a checkpoint trained with adapters has their leaves: build them too
    args.llm_lora = cfg.get("llm_lora", args.llm_lora)
    data = VideoLMData(args, "test", tokenizer=tokenizer)
    model = build_lm(args, cfg["video_size"], cfg["vocab_size"],
                     generator=torch.Generator().manual_seed(0),
                     device=device)
    if _adds_lora(args):
        model.decoder.add_lora(torch.Generator().manual_seed(1))
    load_params(args.model_ckpt, model)
    acc, loss = evaluate(model, data, args, cfg["max_video_length"], device)
    print(f"test acc {acc:.4f} loss {loss:.4f}")
    return acc


def main(argv=None):
    from stair_tpu_torch.train.args import build_parser

    p = build_parser()
    p.add_argument("--func", choices=["train", "test"], default="train")
    p.add_argument("--lm-layers", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; fails without one "
                        "unless 'cpu' is given)")
    args = p.parse_args(argv)
    if args.func == "train" and not args.gpt_test:
        return train(args)
    return test(args)


if __name__ == "__main__":
    main()
