"""Export parser training data in fairseq plain-text format (copy of
``stair_tpu/seq2seq/export.py``).

Equivalent of yellow-binary-tree/STAIR ``utils/get_fairseq_data_from_pkl.py``:
writes parallel ``<split>.question`` / ``<split>.program`` files from
converted record pickles, with programs written REVERSED (the fairseq LSTM
workflow trains on reversed postfix programs and the loader re-reverses,
ref agqa_lite.py:160, get_fairseq_data_from_pkl.py:14-15).
"""

from __future__ import annotations

import argparse
import pickle


def export_split(records_pkl: str, out_prefix: str) -> int:
    with open(records_pkl, "rb") as f:
        records = pickle.load(f)
    n = 0
    with open(out_prefix + ".question", "w") as fq, \
            open(out_prefix + ".program", "w") as fp:
        for rec in records:
            if not rec.get("nmn_program"):
                continue
            fq.write(rec["question"].strip() + "\n")
            fp.write(" ".join(reversed(rec["nmn_program"])) + "\n")
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--records", required=True, nargs="+",
                   help="record pickle(s), one per split")
    p.add_argument("--out-prefixes", required=True, nargs="+",
                   help="matching output prefixes (e.g. data/train)")
    args = p.parse_args(argv)
    for pkl, prefix in zip(args.records, args.out_prefixes):
        n = export_split(pkl, prefix)
        print(f"{pkl} -> {prefix}.{{question,program}} ({n} pairs)")


if __name__ == "__main__":
    main()
