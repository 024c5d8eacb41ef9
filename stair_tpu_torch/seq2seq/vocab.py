"""Source/target vocabularies for the program parsers (copy of
``stair_tpu/seq2seq/vocab.py``)."""

from __future__ import annotations

import json
from dataclasses import dataclass

from stair_tpu_torch.programs.text import tokenize

PAD, BOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]


@dataclass
class Vocab:
    word2id: dict
    id2word: list

    @classmethod
    def build(cls, token_lists, min_count: int = 1) -> "Vocab":
        from collections import Counter

        counts = Counter()
        for toks in token_lists:
            counts.update(toks)
        id2word = list(SPECIALS)
        for word, c in sorted(counts.items(), key=lambda x: (-x[1], x[0])):
            if c >= min_count:
                id2word.append(word)
        return cls({w: i for i, w in enumerate(id2word)}, id2word)

    def encode(self, tokens, max_len: int, add_eos: bool = True):
        ids = [self.word2id.get(t, UNK) for t in tokens]
        if add_eos:
            ids = ids[: max_len - 1] + [EOS]
        else:
            ids = ids[:max_len]
        return ids + [PAD] * (max_len - len(ids))

    def decode(self, ids):
        out = []
        for i in ids:
            i = int(i)
            if i == EOS:
                break
            if i > UNK:
                out.append(self.id2word[i])
        return out

    def __len__(self):
        return len(self.id2word)

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.id2word, f)

    @classmethod
    def load(cls, path) -> "Vocab":
        with open(path) as f:
            id2word = json.load(f)
        return cls({w: i for i, w in enumerate(id2word)}, id2word)


def question_tokens(question: str) -> list[str]:
    return [w.lower() for w in tokenize(question)]
