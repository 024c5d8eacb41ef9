"""CLI flags, preserving the reference's argparse surface.

Mirrors yellow-binary-tree/STAIR ``video_nmn/args.py`` so existing run
commands keep working, plus TPU-native additions (batch size is real now;
mesh shape flags). Flags whose mechanism changed keep their names but are
documented (the port's own copy of ``stair_tpu/train/args.py``, with the
same options and defaults): ``--gradient-accumulation`` is subsumed by ``--batch-size``
(real batching), and scheduler iterations count batches, not examples.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # Input and output (ref args.py:7-22)
    p.add_argument("--dataset", type=str, default="AGQA")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--rgb-path", type=str, required=True)
    p.add_argument("--flow-path", type=str, default=None)
    p.add_argument("--str2num-path", type=str,
                   default="./data/AGQA/video_features/strID2numID.json")
    p.add_argument("--video-secs-path", type=str,
                   default="./data/AGQA/video_features/video_secs.json")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--result-filename", type=str, default=None)
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--vocab-filename", type=str, default="./data/AGQA/vocab.json")
    p.add_argument("--glove-filename", type=str, default="./data/glove.6B.300d.txt")
    p.add_argument("--train-filename", type=str, default="./data/AGQA/train_balanced.pkl")
    p.add_argument("--valid-filename", type=str, default="./data/AGQA/valid_balanced.pkl")
    p.add_argument("--test-filename", type=str, default="./data/AGQA/test_balanced.pkl")
    p.add_argument("--use-prog-word-embeddings", action="store_true")

    # Model (ref args.py:24-34)
    p.add_argument("--model-ckpt", type=str, default=None)
    p.add_argument("--config-filename", type=str, default=None)
    p.add_argument("--hidden-size", type=int, default=512)
    p.add_argument("--video-size", type=int, default=2048)
    p.add_argument("--text-size", type=int, default=300)
    p.add_argument("--max-video-length", type=int, default=150)
    p.add_argument("--dropout", type=float, default=0.25)
    p.add_argument("--init-method", type=str, default="default")
    p.add_argument("--layer-norm", type=int, default=1)
    p.add_argument("--encoder", type=str, default="lstm",
                   choices=["lstm", "transformer"],
                   help="question/video encoders: BiLSTM (reference parity) "
                        "or a parallel transformer encoder")
    p.add_argument("--filter-attention", type=str, default="parity",
                   choices=["parity", "softmax"],
                   help="'parity' replicates the reference Filter pooling; "
                        "'softmax' is the corrected masked attention")

    # Training (ref args.py:36-46)
    p.add_argument("--num-epochs", type=int, default=10)
    p.add_argument("--rand-seed", type=int, default=1)
    p.add_argument("--report-interval", type=int, default=1000)
    p.add_argument("--evaluate-interval", type=int, default=200000)
    p.add_argument("--gradient-accumulation", type=int, default=1,
                   help="kept for CLI compatibility; real batching via "
                        "--batch-size replaces accumulation-as-batching")
    p.add_argument("--contrastive-window", type=int, default=32,
                   help="restrict contrastive negatives to classes within "
                        "each N-example group (parity with the reference's "
                        "32-step accumulation-window negatives, "
                        "train_module.py:360-406); 0 = in-batch negatives. "
                        "Default 32: the round-3 study (9 retrains) showed "
                        "window-32 beats in-batch on every split within "
                        "every seed and closes ~2pp of the deep-program "
                        "(more_steps) gap vs the reference")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--scheduler-start-factor", type=float, default=1.0)
    p.add_argument("--scheduler-end-factor", type=float, default=0.1)
    p.add_argument("--scheduler-total-iters", type=float, default=200000)

    # Generalization splits (ref args.py:48-50)
    p.add_argument("--novel-comp", type=int, default=None)
    p.add_argument("--more-steps", type=int, default=None)

    # Module supervision (ref args.py:52-62)
    p.add_argument("--train-sg-filename", type=str, default=None)
    p.add_argument("--valid-sg-filename", type=str, default=None)
    p.add_argument("--test-sg-filename", type=str, default=None)
    p.add_argument("--id2word-filename", type=str, default=None)
    p.add_argument("--word2id-filename", type=str, default=None)
    p.add_argument("--module-loss-weight", type=float, default=1.0)
    p.add_argument("--decoder-loss-weight", type=float, default=1.0)
    p.add_argument("--train-module-before-iters", type=float, default=1e10)
    p.add_argument("--train-decoder-after-iters", type=float, default=0)
    p.add_argument("--modules-no-intermediate-train", type=str, nargs="+",
                   default=["FilterFrame"])

    # Evaluate (ref args.py:64-70)
    p.add_argument("--evaluate-func", type=str, default="acc")
    p.add_argument("--modules-to-check", nargs="+", type=str, default=None)
    p.add_argument("--module-to-check", type=str, default="Filter")
    p.add_argument("--start-index", type=int, default=0)
    p.add_argument("--end-index", type=int, default=-1)
    p.add_argument("--filter-answer-vocab-filename", type=str,
                   default="./data/AGQA/filter_answers.json")

    # Pretrained-LM paths (ref args.py:72-87)
    p.add_argument("--lm-model", type=str, default="VideoGPT")
    p.add_argument("--bert-path", type=str, default=None)
    p.add_argument("--llm-lora", action="store_true")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--tokenizer-max-length", type=int, default=64)
    p.add_argument("--gpt-video-loss-weight", type=int, default=1)
    p.add_argument("--gpt-max-per-filter-module", type=int, default=1)
    p.add_argument("--gpt-max-filter-output-list-length", type=int, default=5)
    p.add_argument("--gpt-filter-result-path", type=str, default=None)
    p.add_argument("--gpt-gold-filter-output", type=int, default=0)
    p.add_argument("--gpt-filter-output-by-level", type=int, default=0)
    p.add_argument("--gpt-test", type=int, default=0)

    # Video feature tests (ref args.py:89-91)
    p.add_argument("--feat-dim-reduce", type=str, default="mean")
    p.add_argument("--shuffle-video", type=int, default=0)

    # TPU-native additions
    p.add_argument("--profile-dir", type=str, default=None,
                   help="capture an XLA profiler trace of steps "
                        "[profile-start, profile-start+profile-steps)")
    p.add_argument("--profile-start", type=int, default=10)
    p.add_argument("--profile-steps", type=int, default=5)
    p.add_argument("--prng", default="rbg",
                   choices=["threefry2x32", "rbg", "unsafe_rbg"],
                   help="JAX PRNG implementation; rbg generates dropout "
                        "masks ~15%% faster on TPU (threefry2x32 for "
                        "bit-exact round-1 reproducibility)")
    p.add_argument("--mesh-dp", type=int, default=0,
                   help="data-parallel mesh size (0 = all local devices)")
    p.add_argument("--mesh-tp", type=int, default=1,
                   help="tensor-parallel mesh size")
    p.add_argument("--max-question-len", type=int, default=32)
    p.add_argument("--device-tables", default="auto",
                   choices=["auto", "off"],
                   help="keep video features + word embeddings resident on "
                        "device and ship int32 indices per batch (auto: on "
                        "whenever the dataset has a feature arena)")
    return p


def get_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.modules_no_intermediate_train is None:
        args.modules_no_intermediate_train = []
    return args
