"""Program-parser train/predict CLI (port of ``stair_tpu/seq2seq/train.py``).

Trains a seq2seq model on (question -> space-joined nmn_program) pairs from
converted record pickles, then beam-decodes test questions into the TSV
format (``qa_id\\tquestion\\tprogram``, n-best rows per question) that
``stair_tpu_torch.programs.preprocess --func upgrade`` merges back into
records. Functions: ``train``, ``predict``, ``check_valid`` (validity-rate
report, ref hf_program_parser.py:207-222).

    python -m stair_tpu_torch.seq2seq.train --func train --arch lstm \\
        --train-filename out/train.pkl --valid-filename out/valid.pkl \\
        --output parser [--device cpu]

The options are the JAX CLI's, plus ``--device`` (default: the first CUDA
device; without one the CLI exits unless ``--device cpu`` is given). A
parser directory holds ``params.msgpack`` (``train/checkpoint.py``: the
bytes flax's ``to_bytes`` writes for the same tree), ``src_vocab.json``,
``tgt_vocab.json`` and ``parser_config.json``, so a directory written by
either package loads in the other. The optimizer is Adam with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8); batches come in the order of
``np.random.RandomState(seed).permutation``, as in JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from types import SimpleNamespace

import numpy as np
import torch

from stair_tpu_torch.programs.parser import (
    program_is_valid,
    repair_generated_program,
)
from stair_tpu_torch.seq2seq.beam import beam_search
from stair_tpu_torch.seq2seq.lstm import LSTMSeq2Seq, LSTMSeq2SeqConfig
from stair_tpu_torch.seq2seq.t5 import T5Config, T5Seq2Seq
from stair_tpu_torch.seq2seq.transformer import (
    TransformerSeq2Seq,
    TransformerSeq2SeqConfig,
)
from stair_tpu_torch.seq2seq.vocab import BOS, EOS, PAD, Vocab, question_tokens
from stair_tpu_torch.train import checkpoint as ckpt
from stair_tpu_torch.utils.device import pick_device


class HFTokenizerVocab:
    """Vocab-protocol adapter over a sentencepiece tokenizer (the pretrained
    Flan-T5 path, ref hf_program_parser.py:45-70: questions and space-joined
    programs are both plain text to the tokenizer)."""

    def __init__(self, tokenizer, vocab_size):
        self.tokenizer = tokenizer
        self.vocab_size = vocab_size

    def __len__(self):
        return self.vocab_size

    def encode(self, tokens, max_len, add_eos=True):
        return self.encode_text(" ".join(tokens), max_len, add_eos)

    def encode_text(self, text, max_len, add_eos=True):
        ids = self.tokenizer(
            text, add_special_tokens=add_eos
        )["input_ids"][:max_len]
        return ids + [self.tokenizer.pad_token_id] * (max_len - len(ids))

    def decode(self, ids):
        text = self.tokenizer.decode(
            [int(i) for i in ids], skip_special_tokens=True
        )
        return text.split()


def specials_for(arch):
    """(bos, eos, pad) decode ids: T5 decodes from the pad id."""
    if arch in ("t5", "t5-pretrained"):
        return 0, 1, 0
    return BOS, EOS, PAD


def load_pairs(filename):
    with open(filename, "rb") as f:
        records = pickle.load(f)
    pairs = []
    for rec in records:
        if not rec.get("nmn_program"):
            continue
        pairs.append((
            rec.get("qa_id"),
            question_tokens(rec["question"]),
            list(rec["nmn_program"]),
            rec["question"],
        ))
    return pairs


def encode_pairs(pairs, src_vocab, tgt_vocab, max_src, max_tgt):
    """(src [N, max_src] int32, src_mask float32, tgt [N, max_tgt] int32),
    padded at the end."""
    if isinstance(src_vocab, HFTokenizerVocab):
        # The pretrained path tokenizes the RAW question text (the reference
        # feeds the untokenized question, hf_program_parser.py:45-58).
        src = np.array(
            [src_vocab.encode_text(raw, max_src) for _, _, _, raw in pairs],
            np.int32,
        )
    else:
        src = np.array(
            [src_vocab.encode(q, max_src, add_eos=False)
             for _, q, _, _ in pairs],
            np.int32,
        )
    tgt = np.array(
        [tgt_vocab.encode(p, max_tgt) for _, _, p, _ in pairs], np.int32
    )
    src_mask = (src != PAD).astype(np.float32)
    return src, src_mask, tgt


def build_model(arch, src_vocab_size, tgt_vocab_size, args, device=None,
                generator=None):
    """The parser of ``arch`` at ``args``' widths, on ``device``, drawn from
    ``generator`` (default: seed 0)."""
    kw = dict(generator=generator, device=device)
    if arch == "lstm":
        cfg = LSTMSeq2SeqConfig(
            src_vocab=src_vocab_size, tgt_vocab=tgt_vocab_size,
            embed_dim=args.embed_dim, hidden=args.hidden,
            max_src_len=args.max_src_len, max_tgt_len=args.max_tgt_len,
        )
        return LSTMSeq2Seq(cfg, **kw)
    if arch in ("t5", "t5-pretrained"):
        # T5 shares one embedding table between source and target.
        cfg = T5Config(
            vocab_size=max(src_vocab_size, tgt_vocab_size),
            d_model=args.embed_dim, d_kv=args.embed_dim // 4, num_heads=4,
            num_layers=args.num_layers, num_decoder_layers=args.num_layers,
            d_ff=args.embed_dim * 2, feed_forward="gated-gelu",
            tie_word_embeddings=True,
            max_src_len=args.max_src_len, max_tgt_len=args.max_tgt_len,
        )
        return T5Seq2Seq(cfg, **kw)
    cfg = TransformerSeq2SeqConfig(
        src_vocab=src_vocab_size, tgt_vocab=tgt_vocab_size,
        d_model=args.embed_dim, num_heads=4,
        num_layers=args.num_layers, d_ff=args.embed_dim * 2,
        max_src_len=args.max_src_len, max_tgt_len=args.max_tgt_len,
    )
    return TransformerSeq2Seq(cfg, **kw)


def load_pretrained_t5(path, args, device=None):
    """Local HF Flan-T5 checkpoint -> (model, tokenizer vocab). Runs the
    reference's exact parser recipe (hf_program_parser.py:142-205) when the
    released weights are on disk; reads nothing but ``path``."""
    from transformers import AutoTokenizer, T5ForConditionalGeneration

    from stair_tpu_torch.llm.import_weights import import_t5, t5_config_from_hf
    from stair_tpu_torch.weights import params_from_numpy

    tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)
    hf = T5ForConditionalGeneration.from_pretrained(path,
                                                    local_files_only=True)
    cfg = t5_config_from_hf(
        hf.config, max_src_len=args.max_src_len, max_tgt_len=args.max_tgt_len
    )
    params = params_from_numpy(import_t5(hf.state_dict()))
    vocab = HFTokenizerVocab(tokenizer, cfg.vocab_size)
    return T5Seq2Seq(cfg, params, device=device), vocab


def build_vocabs(args, train_pairs):
    """(src_vocab, tgt_vocab): word-level for from-scratch archs; a joint
    vocabulary for from-scratch t5 (shared embedding)."""
    if args.arch == "t5":
        joint = Vocab.build(
            [q for _, q, _, _ in train_pairs]
            + [p for _, _, p, _ in train_pairs]
        )
        return joint, joint
    return (
        Vocab.build([q for _, q, _, _ in train_pairs]),
        Vocab.build([p for _, _, p, _ in train_pairs]),
    )


def parser_loss(logits, tgt_out):
    """Mean cross-entropy over the non-PAD target positions."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tgt_out[..., None])[..., 0]
    mask = (tgt_out != PAD).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp(min=1.0)


def make_optimizer(model, lr):
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def make_step(model, optimizer):
    """``step(src, src_mask, tgt_in, tgt_out) -> loss`` (a 0-d tensor, not
    fetched): the teacher-forced loss, its gradient and one Adam update,
    as the JAX CLI's jitted step. A parameter the loss did not reach gets
    a zero gradient, as ``jax.grad`` gives, so that its moments decay as
    under optax."""
    params = list(model.parameters())

    def step(s, sm, ti, to):
        optimizer.zero_grad(set_to_none=True)
        loss = parser_loss(model.logits(s, sm, ti), to)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    return step


def train_arrays(pairs, src_vocab, tgt_vocab, args, bos_id, device):
    """The encoded training pairs on ``device``: (src, src_mask, tgt_in,
    tgt) with tgt_in the BOS-shifted target."""
    src, src_mask, tgt = encode_pairs(
        pairs, src_vocab, tgt_vocab, args.max_src_len, args.max_tgt_len
    )
    bos = np.full((len(src), 1), bos_id, np.int32)
    tgt_in = np.concatenate([bos, tgt[:, :-1]], axis=1)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (src.astype(np.int64), src_mask,
                           tgt_in.astype(np.int64), tgt.astype(np.int64)))


def epoch_batches(rng, n, bs):
    """One epoch's batches of row indices: ``rng.permutation(n)`` cut into
    whole batches of ``bs`` (the remainder is dropped), as the JAX CLI."""
    order = rng.permutation(n)
    return [order[i:i + bs] for i in range(0, n - bs + 1, bs)]


def train(args):
    dev = pick_device(args.device)
    train_pairs = load_pairs(args.train_filename)
    valid_pairs = load_pairs(args.valid_filename) if args.valid_filename else []
    print(f"train pairs: {len(train_pairs)}, valid: {len(valid_pairs)}")
    if args.hf_t5_path:
        args.arch = "t5-pretrained"
        model, vocab = load_pretrained_t5(args.hf_t5_path, args, dev)
        src_vocab = tgt_vocab = vocab
    else:
        src_vocab, tgt_vocab = build_vocabs(args, train_pairs)
        model = build_model(args.arch, len(src_vocab), len(tgt_vocab), args,
                            dev, torch.Generator().manual_seed(args.seed))
    print(f"src vocab {len(src_vocab)}, tgt vocab {len(tgt_vocab)}")
    step = make_step(model, make_optimizer(model, args.lr))

    bos_id, _eos, _pad = specials_for(args.arch)
    data = train_arrays(train_pairs, src_vocab, tgt_vocab, args, bos_id, dev)
    rng = np.random.RandomState(args.seed)
    n = len(data[0])
    bs = min(args.batch_size, n)
    t0 = time.time()
    it = 0
    for epoch in range(args.num_epochs):
        for idx in epoch_batches(rng, n, bs):
            idx = torch.from_numpy(idx).to(dev)
            loss = step(*(a[idx] for a in data))
            it += 1
            if it % args.report_interval == 0:
                print(f"epoch {epoch} it {it} loss {float(loss):.4f} "
                      f"({it / (time.time() - t0):.1f} it/s)")

    save_parser(args, model, src_vocab, tgt_vocab)
    print("saved parser to", args.output)

    if valid_pairs:
        acc = exact_match(args, model, src_vocab, tgt_vocab, valid_pairs)
        print(f"valid exact-match (top beam): {acc:.4f}")
    return model


def save_parser(args, model, src_vocab, tgt_vocab):
    """The four files of a parser directory under ``args.output``."""
    ckpt.save_params(args.output, model.param_tree())
    if not args.hf_t5_path:
        src_vocab.save(os.path.join(args.output, "src_vocab.json"))
        tgt_vocab.save(os.path.join(args.output, "tgt_vocab.json"))
    with open(os.path.join(args.output, "parser_config.json"), "w") as f:
        json.dump({
            "arch": args.arch, "embed_dim": args.embed_dim,
            "hidden": args.hidden, "num_layers": args.num_layers,
            "max_src_len": args.max_src_len, "max_tgt_len": args.max_tgt_len,
            "hf_t5_path": args.hf_t5_path,
        }, f)


def load_parser(model_dir, device=None):
    """A parser directory (either package's) -> (model on ``device``,
    src_vocab, tgt_vocab). Raises if ``params.msgpack`` does not hold
    exactly the model's leaves."""
    with open(os.path.join(model_dir, "parser_config.json")) as f:
        cfg = json.load(f)
    a = SimpleNamespace(**cfg)
    if cfg.get("hf_t5_path"):
        model, vocab = load_pretrained_t5(cfg["hf_t5_path"], a, device)
        src_vocab = tgt_vocab = vocab
    else:
        src_vocab = Vocab.load(os.path.join(model_dir, "src_vocab.json"))
        tgt_vocab = Vocab.load(os.path.join(model_dir, "tgt_vocab.json"))
        model = build_model(cfg["arch"], len(src_vocab), len(tgt_vocab), a,
                            device)
    missing, extra = ckpt.load_params(model_dir, model)
    if missing or extra:
        raise ValueError(f"{model_dir}/params.msgpack does not fit the "
                         f"parser: missing {missing}, extra {extra}")
    return model, src_vocab, tgt_vocab


def decode_beams(model, src_vocab, tgt_vocab, pairs, args):
    """Beam-decode all pairs in chunks of ``args.batch_size``; yields
    (qa_id, question, [program tokens] x K)."""
    dev = next(model.parameters()).device
    src, src_mask, _ = encode_pairs(
        pairs, src_vocab, tgt_vocab, args.max_src_len, args.max_tgt_len
    )
    bs = min(args.batch_size, len(pairs))
    bos_id, eos_id, pad_id = specials_for(
        "t5" if isinstance(model, T5Seq2Seq) else "word"
    )
    for i in range(0, len(pairs), bs):
        chunk = pairs[i:i + bs]
        s = src[i:i + bs]
        sm = src_mask[i:i + bs]
        if len(chunk) < bs:  # pad to the chunk shape
            pad = bs - len(chunk)
            s = np.concatenate([s, np.zeros((pad, s.shape[1]), np.int32)])
            sm = np.concatenate([sm, np.zeros((pad, sm.shape[1]), np.float32)])
            # a padding row keeps one valid position, so that its
            # attention softmax never meets a fully masked row
            sm[len(chunk):, 0] = 1.0
        tokens, _scores = beam_search(
            model, torch.from_numpy(s.astype(np.int64)).to(dev),
            torch.from_numpy(sm).to(dev), beam_size=args.beam_size,
            max_len=args.max_tgt_len, bos=bos_id, eos=eos_id, pad=pad_id,
        )
        tokens = tokens.cpu().numpy()
        for b, (qa_id, _, _, question) in enumerate(chunk):
            beams = [tgt_vocab.decode(tokens[b, k])
                     for k in range(tokens.shape[1])]
            yield qa_id, question, beams


def write_tsv(filename, decoded):
    """The n-best TSV rows (``qa_id\\tquestion\\tprogram``) of
    ``decode_beams``' output."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w") as f:
        for qa_id, question, beams in decoded:
            for beam in beams:
                f.write("%s\t%s\t%s\n" % (qa_id, question, " ".join(beam)))


def predict(args):
    model, src_vocab, tgt_vocab = load_parser(args.model_dir,
                                              pick_device(args.device))
    pairs = load_pairs(args.test_filename)
    print(f"decoding {len(pairs)} questions (beam {args.beam_size})")
    write_tsv(args.result_filename,
              decode_beams(model, src_vocab, tgt_vocab, pairs, args))
    print("wrote", args.result_filename)


def check_valid(args):
    """Validity rate of generated programs (ref hf_program_parser.py:207-222)."""
    total = valid_first = valid_any = 0
    by_qa: dict[str, list] = {}
    with open(args.result_filename) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 3:
                continue
            by_qa.setdefault(parts[0], []).append(parts[2].split(" "))
    for qa_id, beams in by_qa.items():
        total += 1
        if beams and program_is_valid(beams[0]):
            valid_first += 1
        if any(
            repair_generated_program(b) is not None for b in beams
        ):
            valid_any += 1
    print(f"{total} questions: top-beam valid {valid_first / max(total,1):.4f},"
          f" any-beam valid (after repair) {valid_any / max(total,1):.4f}")
    return valid_first / max(total, 1), valid_any / max(total, 1)


def exact_match(args, model, src_vocab, tgt_vocab, pairs):
    hits = 0
    decoded = decode_beams(model, src_vocab, tgt_vocab, pairs, args)
    for (qa_id, _question, beams), (_, _, gold, _) in zip(decoded, pairs):
        if beams and beams[0] == gold:
            hits += 1
    return hits / max(len(pairs), 1)


def cli_parser() -> argparse.ArgumentParser:
    """The JAX CLI's options (``stair_tpu/seq2seq/train.py:369-401``) plus
    ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--func", choices=["train", "predict", "check_valid"],
                   required=True)
    p.add_argument("--arch", choices=["lstm", "transformer", "t5"],
                   default="transformer")
    p.add_argument("--hf-t5-path", default=None,
                   help="local HF Flan-T5 checkpoint dir: run the "
                        "reference's pretrained-parser recipe "
                        "(hf_program_parser.py:142-205)")
    p.add_argument("--train-filename")
    p.add_argument("--valid-filename", default=None)
    p.add_argument("--test-filename")
    p.add_argument("--output", default="parser_out")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--result-filename", default="generated_programs.tsv")
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--max-src-len", type=int, default=32)
    p.add_argument("--max-tgt-len", type=int, default=48)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--report-interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device; "
                        "'cpu' runs the kernels' plain versions)")
    return p


def main(argv=None):
    args = cli_parser().parse_args(argv)
    args.model_dir = args.model_dir or args.output
    pick_device(args.device)  # no card and no --device: exit here
    if args.func == "train":
        return train(args)
    if args.func == "predict":
        return predict(args)
    return check_valid(args)


if __name__ == "__main__":
    main()
