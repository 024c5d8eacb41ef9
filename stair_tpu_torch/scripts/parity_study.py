"""The accuracy study on the parity world, run by the port (the port's
version of ``scripts/parity_study.py``'s ``build``, ``ours`` and
``parser_loop``).

Builds the synthetic AGQA-format world of the parity study (250 videos x
44 questions, seed 7: 11,000 questions), trains the port's NMN on it and
reports test accuracy with Wilson 95% intervals on ``all``, ``novel_comp``
and ``more_steps``; then trains the port's LSTM program parser on the same
world and measures it in the loop: exact match, validity rates, decode
throughput, and the NMN's test accuracy on the generated programs against
the gold ones (same checkpoint) with a paired difference.

    python -m stair_tpu_torch.scripts.parity_study --func build --root R
    python -m stair_tpu_torch.scripts.parity_study --func ours --root R \\
        --contrastive-window 32 --rand-seed 2
    python -m stair_tpu_torch.scripts.parity_study --func parser_loop --root R

Same flags and defaults as the JAX script, plus ``--device`` (default: the
first CUDA device; without one it exits unless ``--device cpu`` is
given). ``build`` writes the world in a child process under
``PYTHONHASHSEED=0``: ``make_world``'s questions follow the string-hash
seed (as the JAX original's do). It calls the port's
``train.loop.main``, ``train.evaluate.main``, ``programs.preprocess
--func upgrade`` and ``seq2seq.train``, and writes ``parity.json`` (the
``ours`` run) and ``parser_loop.json`` under ``--root``, nothing else.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from stair_tpu_torch.utils.device import pick_device


# ---------------------------------------------------------------------------
# World construction + splits
# ---------------------------------------------------------------------------

def build(args):
    """Run ``build_world`` in a child process under ``PYTHONHASHSEED=0``."""
    code = ("import json, sys\n"
            "from stair_tpu_torch.scripts.parity_study import build_world\n"
            "build_world(**json.loads(sys.argv[1]))\n")
    kw = {k: getattr(args, k) for k in (
        "root", "num_videos", "questions_per_video", "num_frames", "seed",
        "test_size", "valid_size", "num_workers")}
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONHASHSEED="0")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-c", code, json.dumps(kw)], check=True,
                   env=env)


def build_world(root, num_videos, questions_per_video, num_frames, seed,
                test_size, valid_size, num_workers):
    """The JAX script's ``build`` on the port's copies of ``make_world`` and
    ``preprocess``: the world, the train / valid / test split
    (``novel_comp`` questions never train, 80% of ``more_steps`` are held
    out, the rest of test filled at random) and the converted records
    ``out/{train,valid,test}.pkl``, ``labels.json`` and ``build_meta.json``."""
    from stair_tpu_torch.programs import preprocess
    from stair_tpu_torch.programs.scene_graph import SceneGraphExecutor
    from stair_tpu_torch.testing.synthetic import make_world

    t0 = time.time()
    w = make_world(root, num_videos=num_videos,
                   questions_per_video=questions_per_video,
                   num_frames=num_frames, seed=seed)
    with open(w["questions"]) as f:
        qs = json.load(f)
    print(f"world: {len(qs)} questions over {num_videos} videos "
          f"({time.time() - t0:.0f}s)")

    rng = random.Random(seed + 1)
    ids = sorted(qs)
    novel = [q for q in ids if qs[q]["novel_comp"]]
    deep = [q for q in ids if qs[q]["more_steps"] and not qs[q]["novel_comp"]]
    rest = [q for q in ids if q not in set(novel) | set(deep)]
    rng.shuffle(deep)
    rng.shuffle(rest)
    deep_test = deep[: int(0.8 * len(deep))]
    test = set(novel) | set(deep_test)
    want_test = max(test_size, len(test))
    fill = [q for q in rest if q not in test]
    test |= set(fill[: want_test - len(test)])
    remaining = [q for q in ids if q not in test]
    rng.shuffle(remaining)
    valid = set(remaining[:valid_size])
    train = [q for q in remaining[valid_size:]]
    print(f"split: train={len(train)} valid={len(valid)} test={len(test)} "
          f"(novel_comp={len(novel)}, more_steps-in-test={len(deep_test)})")

    preprocess.set_executor(
        SceneGraphExecutor(w["scene_graphs"], w["id2word"], w["word2id"]))
    out = os.path.join(root, "out")
    os.makedirs(out, exist_ok=True)
    splits = {"train": train, "valid": sorted(valid), "test": sorted(test)}
    meta = {}
    for name, qids in splits.items():
        t1 = time.time()
        recs = preprocess.convert_split(
            [dict(qs[q], qa_id=q) for q in qids], num_workers=num_workers)
        with open(os.path.join(out, f"{name}.pkl"), "wb") as f:
            pickle.dump(recs, f)
        print(f"{name}: {len(recs)}/{len(qids)} converted "
              f"({time.time() - t1:.0f}s)")
        meta[name] = len(recs)
    labels = {q: {"novel_comp": qs[q]["novel_comp"],
                  "more_steps": qs[q]["more_steps"]} for q in ids}
    with open(os.path.join(root, "labels.json"), "w") as f:
        json.dump(labels, f)
    with open(os.path.join(root, "build_meta.json"), "w") as f:
        json.dump(meta, f)


def _common_flags(args):
    out = os.path.join(args.root, "out")
    return [
        "--rgb-path", os.path.join(args.root, "features"),
        "--glove-filename", os.path.join(args.root, "glove.txt"),
        "--train-filename", os.path.join(out, "train.pkl"),
        "--valid-filename", os.path.join(out, "valid.pkl"),
        "--test-filename", os.path.join(out, "test.pkl"),
        "--video-secs-path", os.path.join(args.root, "video_secs.json"),
        "--word2id-filename", os.path.join(args.root, "IDX.json"),
        "--vocab-filename", os.path.join(out, "vocab.json"),
        "--hidden-size", str(args.hidden), "--text-size", "50",
        "--max-video-length", str(args.frames), "--video-size", "64",
        "--lr", str(args.lr),
    ]


def _variant_flags(args):
    """The ``ours`` run's model flags, which its evaluations repeat."""
    extra = []
    if args.encoder != "lstm":
        extra += ["--encoder", args.encoder]
    if args.filter_attention != "parity":
        extra += ["--filter-attention", args.filter_attention]
    if args.contrastive_window:
        extra += ["--contrastive-window", str(args.contrastive_window)]
    return extra


def args_count(args, split):
    with open(os.path.join(args.root, "build_meta.json")) as f:
        return json.load(f)[split]


# ---------------------------------------------------------------------------
# the port's NMN run
# ---------------------------------------------------------------------------

def ours(args, dev):
    from stair_tpu_torch.train import evaluate as eval_cli
    from stair_tpu_torch.train import loop
    from stair_tpu_torch.utils.device import card_identity

    run = os.path.join(args.root, args.ours_run)
    extra = _variant_flags(args)
    if args.rand_seed != 1:
        extra += ["--rand-seed", str(args.rand_seed)]
    steps_per_epoch = max(1, args_count(args, "train") // args.batch_size)
    t0 = time.time()
    best = loop.main(_common_flags(args) + extra + [
        "--output", run, "--num-epochs", str(args.ours_epochs),
        "--batch-size", str(args.batch_size),
        "--evaluate-interval", str(steps_per_epoch),
        "--report-interval", str(max(1, steps_per_epoch // 2)),
        "--scheduler-total-iters",
        str(steps_per_epoch * args.ours_epochs),
    ], device=dev)
    train_s = time.time() - t0
    print(f"ours: best valid acc {best:.4f} ({train_s:.0f}s)")

    acc = eval_cli.main(_common_flags(args) + extra + [
        "--output", run,
        "--model-ckpt", os.path.join(run, "best_model"),
        "--evaluate-func", "acc", "--result-filename", "test_preds.json",
        "--batch-size", str(args.batch_size),
    ], device=dev)
    print(f"ours: test acc {acc:.4f}")

    with open(os.path.join(args.root, "labels.json")) as f:
        labels = json.load(f)
    result = {
        "run": args.ours_run, "epochs": args.ours_epochs,
        "rand_seed": args.rand_seed,
        "contrastive_window": args.contrastive_window,
        "best_valid_acc": round(float(best), 4),
        "train_seconds": round(train_s, 1),
        "device": card_identity() if dev.type == "cuda" else str(dev),
        "accuracy": split_accuracies(
            _load_preds(os.path.join(run, "test_preds.json")), labels),
    }
    print("ours:", json.dumps(result, indent=1))
    with open(os.path.join(args.root, "parity.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def split_accuracies(preds, labels):
    """Accuracy with its Wilson 95% interval on ``all``, ``novel_comp`` and
    ``more_steps`` (the JAX script's ``report`` for one model)."""
    accs = {}
    for split in ("all", "novel_comp", "more_steps"):
        pairs = [(p, g) for qa, (p, g) in preds.items()
                 if split == "all" or labels.get(qa, {}).get(split)]
        c = sum(p == g for p, g in pairs)
        acc, lo, hi = wilson(c, len(pairs))
        accs[split] = {"n": len(pairs), "correct": c, "acc": round(acc, 4),
                       "ci95": [round(lo, 4), round(hi, 4)]}
    return accs


# ---------------------------------------------------------------------------
# the neural parser in the measured loop
# ---------------------------------------------------------------------------

def parser_loop(args, dev):
    """Train the port's seq2seq program parser on this world and measure it
    in the loop: (a) program exact match + validity rates, (b) the NMN's
    test accuracy with *generated* programs via the upgrade path (against
    gold programs, same checkpoint), (c) batched beam-decode throughput.
    Requires a finished ``ours`` run (the NMN checkpoint under
    ``<root>/<ours_run>``)."""
    from stair_tpu_torch.programs import preprocess as prep
    from stair_tpu_torch.seq2seq import train as parser_cli
    from stair_tpu_torch.train import evaluate as eval_cli
    from stair_tpu_torch.utils.device import card_identity

    out = os.path.join(args.root, "out")
    run = os.path.join(args.root, args.ours_run)
    parser_dir = os.path.join(args.root, f"parser_{args.parser_arch}")
    results = {"arch": args.parser_arch, "epochs": args.parser_epochs}

    t0 = time.time()
    parser_cli.main([
        "--func", "train", "--arch", args.parser_arch,
        "--train-filename", os.path.join(out, "train.pkl"),
        "--valid-filename", os.path.join(out, "valid.pkl"),
        "--output", parser_dir,
        "--num-epochs", str(args.parser_epochs),
        "--batch-size", "64", "--report-interval", "200",
        "--device", str(dev),
    ])
    results["train_seconds"] = round(time.time() - t0, 1)

    # --- (a) exact match + (c) decode throughput -------------------------
    model, sv, tv = parser_cli.load_parser(parser_dir, dev)
    pairs = parser_cli.load_pairs(os.path.join(out, "test.pkl"))
    da = SimpleNamespace(batch_size=256, beam_size=5,
                         max_src_len=32, max_tgt_len=48)
    # a warm pass first (allocator, library handles), then the timed pass
    list(parser_cli.decode_beams(model, sv, tv, pairs[:256], da))
    t0 = time.time()
    decoded = list(parser_cli.decode_beams(model, sv, tv, pairs, da))
    dt = time.time() - t0
    results["decode_qps"] = round(len(pairs) / dt, 1)
    n_em = sum(
        1 for (qa, _q, beams), (_, _, gold, _) in zip(decoded, pairs)
        if beams and beams[0] == gold
    )
    em, em_lo, em_hi = wilson(n_em, len(pairs))
    results["exact_match_top1"] = round(em, 4)
    results["exact_match_ci95"] = [round(em_lo, 4), round(em_hi, 4)]

    tsv = os.path.join(parser_dir, "gen_test.tsv")
    parser_cli.write_tsv(tsv, decoded)
    top1_valid, any_valid = parser_cli.check_valid(
        SimpleNamespace(result_filename=tsv))
    results["valid_top1"] = round(top1_valid, 4)
    results["valid_any_beam"] = round(any_valid, 4)

    # --- (b) NMN accuracy with generated programs ------------------------
    gen_pkl = os.path.join(out, "test_generated.pkl")
    prep.main([
        "--func", "upgrade", "--generated-format", "huggingface",
        "--src-data-filename", os.path.join(out, "test.pkl"),
        "--dest-data-filename", gen_pkl, "--generated-filename", tsv,
    ])

    def nmn_acc(test_pkl, result_name):
        return eval_cli.main(_common_flags(args) + [
            "--output", run,
            "--model-ckpt", os.path.join(run, "best_model"),
            "--evaluate-func", "acc",
            "--result-filename", result_name,
            "--batch-size", str(args.batch_size),
            "--test-filename", test_pkl,   # last --test-filename wins
        ] + _variant_flags(args), device=dev)

    acc_gold = float(
        nmn_acc(os.path.join(out, "test.pkl"), "test_preds_gold.json"))
    acc_gen = float(nmn_acc(gen_pkl, "test_preds_generated.json"))
    results["nmn_acc_gold_programs"] = round(acc_gold, 4)
    results["nmn_acc_generated_programs"] = round(acc_gen, 4)
    results["n_test"] = len(pairs)
    for key, acc in (("gold", acc_gold), ("generated", acc_gen)):
        c = int(round(acc * len(pairs)))
        _, lo, hi = wilson(c, len(pairs))
        results[f"nmn_acc_{key}_ci95"] = [round(lo, 4), round(hi, 4)]
    try:
        g = _load_preds(os.path.join(run, "test_preds_gold.json"))
        gen = _load_preds(os.path.join(run, "test_preds_generated.json"))
    except FileNotFoundError:  # no generated program could be lifted
        g = gen = {}
    shared = sorted(set(g) & set(gen))
    diffs = np.asarray(
        [int(gen[qa][0] == gen[qa][1]) - int(g[qa][0] == g[qa][1])
         for qa in shared], np.float64)
    if len(diffs) >= 2:
        mean = float(diffs.mean())
        se = float(diffs.std(ddof=1) / math.sqrt(len(diffs)))
        results["paired_generated_minus_gold"] = {
            "n": len(diffs), "mean": round(mean, 4),
            "ci95": [round(mean - 1.96 * se, 4), round(mean + 1.96 * se, 4)],
        }
    results["device"] = card_identity() if dev.type == "cuda" else str(dev)

    print("parser_loop:", json.dumps(results, indent=1))
    with open(os.path.join(args.root, "parser_loop.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def wilson(correct, n, z=1.96):
    if n == 0:
        return (0.0, 0.0, 1.0)
    p = correct / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (p, max(0.0, center - half), min(1.0, center + half))


def _load_preds(path):
    with open(path) as f:
        d = json.load(f)
    return {
        qa: (p, g) for qa, p, g in zip(d["qa_ids"], d["preds"], d["golds"])
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--func", required=True,
                    choices=["build", "ours", "parser_loop"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--num-videos", type=int, default=250)
    ap.add_argument("--questions-per-video", type=int, default=44)
    ap.add_argument("--num-frames", type=int, default=32,
                    help="frames per video; keep equal to --frames")
    ap.add_argument("--test-size", type=int, default=1500)
    ap.add_argument("--valid-size", type=int, default=800)
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--ours-epochs", type=int, default=40)
    ap.add_argument("--ours-run", default="ours",
                    help="run subdirectory for the port's NMN trainer")
    ap.add_argument("--encoder", default="lstm",
                    choices=["lstm", "transformer"])
    ap.add_argument("--filter-attention", default="parity",
                    choices=["parity", "softmax"])
    ap.add_argument("--contrastive-window", type=int, default=0)
    ap.add_argument("--rand-seed", type=int, default=1,
                    help="the NMN trainer's seed")
    ap.add_argument("--parser-arch", default="lstm",
                    choices=["lstm", "transformer", "t5"],
                    help="seq2seq arch for --func parser_loop")
    ap.add_argument("--parser-epochs", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)  # no card and no --device: exit here
    if args.func == "build":
        return build(args)
    if args.func == "ours":
        return ours(args, dev)
    return parser_loop(args, dev)


if __name__ == "__main__":
    main()
