"""The port's parity study (stair_tpu_torch/scripts/parity_study.py) end to
end on the CPU at a tiny size: ``build`` (the world under
``PYTHONHASHSEED=0`` in a child process) -> ``ours`` (the port's NMN
trainer and evaluate CLIs) -> ``parser_loop`` (the port's parser CLI,
decode, ``preprocess --func upgrade``, evaluate on the generated programs).
``parser_loop.json`` carries every key the JAX script writes, and the
script refuses to run without a card unless ``--device cpu`` is given.
"""

import json
import os
import re

import pytest
import torch

from stair_tpu_torch.scripts import parity_study as PS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_parser_loop_keys():
    """The keys ``scripts/parity_study.py parser_loop`` writes."""
    with open(os.path.join(REPO, "scripts", "parity_study.py")) as f:
        src = f.read()
    body = src[src.index("def parser_loop"):src.index("def _prepare_reference")]
    keys = set(re.findall(r'results\["(\w+)"\]', body))
    keys |= {f"nmn_acc_{k}_ci95" for k in ("gold", "generated")}
    keys |= set(re.findall(r'results = \{"(\w+)": [^,]+, "(\w+)"', body)[0])
    return keys


def test_build_ours_parser_loop_on_the_cpu(tmp_path, monkeypatch):
    root = str(tmp_path / "parity")
    common = ["--root", root, "--device", "cpu"]
    PS.main(["--func", "build", *common, "--num-videos", "4",
             "--questions-per-video", "5", "--num-frames", "16",
             "--test-size", "4", "--valid-size", "4", "--num-workers", "1"])
    with open(os.path.join(root, "build_meta.json")) as f:
        meta = json.load(f)
    assert meta["train"] > 0 and meta["valid"] > 0 and meta["test"] > 0
    small = [*common, "--hidden", "32", "--frames", "16", "--batch-size",
             "8", "--ours-epochs", "1", "--parser-epochs", "1",
             "--contrastive-window", "4"]
    ours = PS.main(["--func", "ours", *small])
    with open(os.path.join(root, "parity.json")) as f:
        assert json.load(f) == ours
    acc = ours["accuracy"]
    assert set(acc) == {"all", "novel_comp", "more_steps"}
    assert acc["all"]["n"] == meta["test"]
    res = PS.main(["--func", "parser_loop", *small])
    with open(os.path.join(root, "parser_loop.json")) as f:
        written = json.load(f)
    assert written == res
    # a parser of one epoch on 12 questions writes no liftable program, so
    # there is no paired difference (as in the JAX script)
    missing = _jax_parser_loop_keys() - set(written)
    assert missing <= {"paired_generated_minus_gold"}, missing
    assert written["n_test"] == meta["test"]
    assert 0.0 <= written["exact_match_top1"] <= 1.0
    assert os.path.exists(os.path.join(root, "out", "test_generated.pkl"))

    # with an oracle decode (every beam the gold program) the whole loop
    # runs: exact match and validity 1, the NMN's accuracy on the merged
    # programs equal to gold's, a paired difference of 0
    from stair_tpu_torch.seq2seq import train as parser_cli

    def oracle(model, sv, tv, pairs, args):
        for qa_id, _, gold, question in pairs:
            yield qa_id, question, [list(gold)] * args.beam_size

    monkeypatch.setattr(parser_cli, "decode_beams", oracle)
    res = PS.main(["--func", "parser_loop", *small])
    missing = _jax_parser_loop_keys() - set(res)
    assert not missing, missing
    assert res["exact_match_top1"] == res["valid_top1"] == 1.0
    assert res["valid_any_beam"] == 1.0
    assert res["nmn_acc_generated_programs"] == res["nmn_acc_gold_programs"]
    assert res["paired_generated_minus_gold"]["mean"] == 0.0
    assert res["paired_generated_minus_gold"]["n"] == meta["test"]
    assert not os.path.exists(os.path.join(root, "PARITY.json"))


def test_parity_study_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the study would run on it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        PS.main(["--func", "build", "--root", str(tmp_path / "w")])
    assert not os.path.exists(tmp_path / "w")
