"""Reformat AGQA questions (+ STAIR Filter outputs) for Video-ChatGPT eval.

Equivalent of yellow-binary-tree/STAIR
``video_chatgpt/utils/reformat_agqa_data.py``: sample a fraction of AGQA
questions and splice the auditable Filter-module retrievals into the prompt
("Possible useful information in video: <kw> <ans>. ... Question: ..."),
emitting the QA JSON the zero-shot inference CLI consumes.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random


def load_filter_data(filter_fname: str) -> dict:
    """Shard-aware filter-result loading (template with %d, or plain)."""
    merged = {}
    if filter_fname and "%d" in filter_fname:
        i = 0
        while os.path.isfile(filter_fname % i):
            with open(filter_fname % i, "rb") as f:
                merged.update(pickle.load(f))
            i += 1
    elif filter_fname:
        with open(filter_fname, "rb") as f:
            merged = pickle.load(f)
    return merged


def reformat(
    src_data: dict,
    filter_data: dict | None,
    sample_ratio: float = 0.01,
    seed: int = 0,
    max_modules: int = 3,
    answers_per_module: int = 1,
) -> list[dict]:
    rng = random.Random(seed)
    qids = rng.sample(sorted(src_data.keys()),
                      int(len(src_data) * sample_ratio))
    out = []
    for qid in qids:
        example = src_data[qid]
        texts = []
        if filter_data:
            entries = list(filter_data.get(qid, {}).values())
            entries.sort(key=lambda e: -e[0])
            for _level, kw, answers in entries:
                for ans in answers[:answers_per_module]:
                    texts.append(f"{kw} {ans}.")
                texts = texts[:max_modules]
        question = example["question"]
        if texts:
            question = (
                "Possible useful information in video: %s Question: %s"
                % (" ".join(texts), question)
            )
        out.append({
            "question": question,
            "answer": example["answer"],
            "question_id": qid,
            "video_name": example["video_id"],
        })
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample_ratio", type=float, default=0.01)
    p.add_argument("--input_fname", required=True)
    p.add_argument("--filter_fname", default=None)
    p.add_argument("--output_fname", required=True)
    args = p.parse_args(argv)
    with open(args.input_fname) as f:
        src = json.load(f)
    filt = load_filter_data(args.filter_fname) if args.filter_fname else None
    data = reformat(src, filt, args.sample_ratio, args.seed)
    with open(args.output_fname, "w") as f:
        json.dump(data, f)
    print("wrote %d examples to %s" % (len(data), args.output_fname))


if __name__ == "__main__":
    main()
