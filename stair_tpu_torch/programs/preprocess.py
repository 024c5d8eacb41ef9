"""Offline preprocessing: raw AGQA questions -> training records.

Converts AGQA question JSON/CSV plus scene-graph pickles into the per-example
record schema consumed by the datasets (and emitted, format-compatible, by the
reference pipeline — yellow-binary-tree/STAIR ``utils/agqa_lite.py:122-143``):

    {question, answer, video_id, program, qa_id, novel_comp, more_steps,
     nmn_program, nmn_program_idx, sg_program, sg_program_idx,
     sg_res_by_step, nmn_program_span_by_word, nmn_program_span_by_char}

The symbolic executor runs every example; an example whose symbolic answer
disagrees with the gold answer is dropped (``sg_res_by_step = None``), which
doubles as a data-quality gate on the program annotations.

Also provides the ``upgrade`` path that merges seq2seq-parser-generated
programs back into records (ref ``utils/agqa_lite.py:146-297``), and a
``convert`` CLI mirroring the reference's entry point.

The port's own copy of ``stair_tpu/programs/preprocess.py``. pandas is
imported only by the two functions that read CSV files
(``merge_json_records`` for NEXTQA, ``_cli_convert`` with a CSV key list),
so the module imports where pandas is not installed.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from multiprocessing import Pool

from stair_tpu_torch.programs import scene_graph as sg
from stair_tpu_torch.programs.parser import (
    parse_nmn_program,
    program_is_valid,
    repair_generated_program,
)
from stair_tpu_torch.programs.spans import link_program_spans

# A module-global executor so multiprocessing workers inherit it via fork.
_EXECUTOR: sg.SceneGraphExecutor | None = None


def set_executor(executor: sg.SceneGraphExecutor) -> None:
    global _EXECUTOR
    _EXECUTOR = executor


def symbolic_supervision(parsed, sg_tokens, sg_index, video_id, answer):
    """Run the symbolic program; return per-step gold results or None.

    None means the example failed validation (symbolic answer != gold, or the
    program crashed on this scene graph). Callable intermediate values
    (pending per-frame predicates) are dropped — they have no neural
    counterpart. ref: utils/agqa_lite.py:31-59
    """
    if _EXECUTOR is None:
        raise RuntimeError("call set_executor() before converting examples")
    frame_srcs = [
        src
        for tok, src in zip(parsed.tokens, parsed.source_index)
        if isinstance(tok, str) and "Frame" in tok
    ]
    try:
        sym_answer, steps, _meta = _EXECUTOR.run(
            video_id=video_id,
            tokens=sg_tokens,
            source_index=sg_index,
            frame_source_indices=frame_srcs,
            existsframe_to_filterframe=parsed.existsframe_to_filterframe,
        )
        if sym_answer != answer:
            return None
    except Exception:
        return None
    return {k: v for k, v in steps.items() if not callable(v)}


def convert_example(example: dict) -> dict:
    """One raw question record -> one training record."""
    record = {
        key: example[key]
        for key in (
            "question", "answer", "video_id", "program", "qa_id",
            "novel_comp", "more_steps",
        )
        if key in example
    }
    parsed = parse_nmn_program(example["program"])
    record["nmn_program"] = parsed.tokens
    record["nmn_program_idx"] = parsed.source_index
    sg_tokens, sg_index = sg.parse_sg_program(example["program"])
    record["sg_program"] = sg_tokens
    record["sg_program_idx"] = sg_index
    record["sg_res_by_step"] = symbolic_supervision(
        parsed, sg_tokens, sg_index, example["video_id"], example["answer"]
    )
    by_word, by_char = link_program_spans(parsed.tokens, example["question"])
    record["nmn_program_span_by_word"] = by_word
    record["nmn_program_span_by_char"] = by_char
    return record


def convert_split(examples: list[dict], num_workers: int = 1) -> list[dict]:
    # Forking more workers than cores only adds scheduler overhead (the
    # reference defaults to 20; this image may have a single core).
    num_workers = min(num_workers, os.cpu_count() or 1)
    if num_workers <= 1:
        return [convert_example(e) for e in examples]
    with Pool(num_workers) as pool:
        return pool.map(convert_example, examples)


# ---------------------------------------------------------------------------
# Generated-program merge ("upgrade")
# ---------------------------------------------------------------------------

def load_generated_programs_tsv(filename: str) -> dict[str, list[str]]:
    """Parse ``qa_id\\tquestion\\tprogram`` beam-output lines; first valid
    beam per qa_id wins. ref: utils/agqa_lite.py:169-188"""
    programs: dict[str, list[str]] = {}
    with open(filename) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 3:
                continue
            qa_id, _question, program = parts
            if qa_id in programs:
                continue
            fixed = repair_generated_program(program.split(" "))
            if fixed is not None:
                programs[qa_id] = fixed
    return programs


def load_generated_programs_fairseq(filename: str) -> dict[int, list[str] | None]:
    """Parse fairseq-style generate output (S-/D- lines, reversed programs).
    ref: utils/agqa_lite.py:146-166"""
    programs: dict[int, list[str] | None] = {}
    pending: int | None = None
    with open(filename) as f:
        for line in f:
            if line.startswith("S"):
                if pending is not None:
                    programs[pending] = None
                pending = int(line.split("\t")[0][2:])
            elif line.startswith("D") and pending is not None:
                tokens = line.strip().split("\t")[-1].split(" ")[::-1]
                if program_is_valid(tokens):
                    programs[pending] = tokens
                    pending = None
    return programs


def upgrade_records(
    records: list[dict], generated: dict[str, list[str] | None]
) -> list[dict]:
    """Swap gold programs for parser-generated ones, recomputing spans where
    the program changed. ref: utils/agqa_lite.py:191-230"""
    out = []
    for rec in records:
        new = {
            k: rec[k]
            for k in ("question", "answer", "video_id", "program", "qa_id")
            if k in rec
        }
        program = generated.get(new["qa_id"])
        if program == rec.get("nmn_program"):
            for k in ("nmn_program", "nmn_program_span_by_word",
                      "nmn_program_span_by_char"):
                new[k] = rec[k]
        else:
            new["nmn_program"] = program
            by_word, by_char = link_program_spans(program, new["question"])
            new["nmn_program_span_by_word"] = by_word
            new["nmn_program_span_by_char"] = by_char
        out.append(new)
    return out


def merge_json_records(
    src_data_filename: str,
    generated: dict,
    dataset: str = "STAR",
) -> list[dict]:
    """Attach parser-generated programs to STAR/MSRVTT/NEXTQA questions.

    ref: utils/agqa_lite.py:233-297 — questions whose parser output is
    invalid keep an empty program (datasets drop them for train/valid).
    """
    wanted = {
        "STAR": ["question_id", "question", "answer", "choices", "video_id",
                 "start", "end"],
        "MSRVTT": ["question_id", "question", "answer", "video",
                   "answer_type"],
        "NEXTQA": ["question_id", "question", "answer", "choices",
                   "video_id"],
    }[dataset]

    if dataset == "NEXTQA":
        import pandas as pd

        df = pd.read_csv(src_data_filename)
        src = [
            {
                "video_id": str(row["video"]),
                "question": row["question"],
                "answer": row["answer"],
                "question_id": str(idx),
                "choices": [{"choice": row["a%d" % i]} for i in range(5)],
            }
            for idx, row in df.iterrows()
        ]
    else:
        with open(src_data_filename) as f:
            src = json.load(f)

    out = []
    stats = {"no_program": 0, "no_span": 0, "spans": 0}
    for example in src:
        rec = {k: example[k] for k in wanted if k in example}
        if dataset == "STAR":
            rec["question"] = rec["question"].replace("/", " ")
            rec["choices"] = [
                {"choice_id": c.get("choice_id", i),
                 "choice": c["choice"].replace("/", " ")}
                for i, c in enumerate(rec.get("choices", []))
            ]
            if "answer" in rec and isinstance(rec["answer"], str):
                rec["answer"] = rec["answer"].replace("/", " ")
        program = generated.get(rec["question_id"])
        if program is None:
            stats["no_program"] += 1
            rec["nmn_program"] = []
            rec["nmn_program_span_by_word"] = None
            rec["nmn_program_span_by_char"] = None
        else:
            rec["nmn_program"] = program
            by_word, by_char = link_program_spans(program, rec["question"])
            rec["nmn_program_span_by_word"] = by_word
            rec["nmn_program_span_by_char"] = by_char
            stats["spans"] += len(by_word)
            stats["no_span"] += sum(
                1 for v in by_word.values() if None in v
            )
        out.append(rec)
    print("merge stats:", stats)
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli_convert(args: argparse.Namespace) -> None:
    os.makedirs(args.output_folder, exist_ok=True)
    sg_files = [f for f in (args.train_sg_filename, args.test_sg_filename) if f]
    set_executor(
        sg.SceneGraphExecutor(sg_files, args.id2word_filename,
                              args.word2id_filename)
    )

    def load_split(name, csv_filename):
        with open(os.path.join(args.input_folder, name)) as f:
            data = json.load(f)
        if csv_filename:
            import pandas as pd

            qa_ids = list(pd.read_csv(csv_filename, sep=",")["key"])
        else:
            qa_ids = list(data.keys())
        return [dict(data[q], qa_id=q) for q in qa_ids]

    train_valid = load_split("train_balanced.txt", args.train_csv_filename)
    cut = int(len(train_valid) * 0.9)
    for split_name, examples in (
        ("valid_balanced.pkl", train_valid[cut:]),
        ("train_balanced.pkl", train_valid[:cut]),
    ):
        converted = convert_split(examples, args.num_workers)
        with open(os.path.join(args.output_folder, split_name), "wb") as f:
            pickle.dump(converted, f)
        print("converted %d examples -> %s" % (len(converted), split_name))

    test = load_split("test_balanced.txt", args.test_csv_filename)
    converted = convert_split(test, args.num_workers)
    with open(os.path.join(args.output_folder, "test_balanced.pkl"), "wb") as f:
        pickle.dump(converted, f)
    print("converted %d examples -> test_balanced.pkl" % len(converted))


def _cli_upgrade(args: argparse.Namespace) -> None:
    if args.generated_format == "fairseq":
        generated = load_generated_programs_fairseq(args.generated_filename)
    else:
        generated = load_generated_programs_tsv(args.generated_filename)
    if args.dataset in ("STAR", "MSRVTT", "NEXTQA"):
        merged = merge_json_records(
            args.src_data_filename, generated, args.dataset
        )
        with open(args.dest_data_filename, "wb") as f:
            pickle.dump(merged, f)
        print("wrote %d merged records" % len(merged))
        return
    with open(args.src_data_filename, "rb") as f:
        records = pickle.load(f)
    upgraded = upgrade_records(records, generated)
    with open(args.dest_data_filename, "wb") as f:
        pickle.dump(upgraded, f)
    print("wrote %d upgraded records" % len(upgraded))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--func", choices=["convert", "upgrade"], required=True)
    p.add_argument("--train-sg-filename", default=None)
    p.add_argument("--test-sg-filename", default=None)
    p.add_argument("--id2word-filename")
    p.add_argument("--word2id-filename")
    p.add_argument("--num-workers", type=int, default=20)
    p.add_argument("--train-csv-filename", default=None)
    p.add_argument("--test-csv-filename", default=None)
    p.add_argument("--input-folder")
    p.add_argument("--output-folder")
    p.add_argument("--dataset", default="AGQA")
    p.add_argument("--generated-format", default="huggingface")
    p.add_argument("--src-data-filename")
    p.add_argument("--dest-data-filename")
    p.add_argument("--generated-filename")
    args = p.parse_args(argv)
    if args.func == "convert":
        _cli_convert(args)
    else:
        _cli_upgrade(args)


if __name__ == "__main__":
    main()
