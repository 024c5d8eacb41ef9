"""Link free-text program arguments to token spans in the question.

A neural program's free-text arguments (action phrases, object names, ...)
are not embedded in isolation: the executor represents them as the mean of
the question encoder's token features over the matching span, so the string
is contextualized by the question. This module finds those spans by
lemmatized sub-sequence matching, mirroring the reference semantics
(yellow-binary-tree/STAIR ``utils/agqa_lite.py:62-119``): both the question
and the program words are normalized (hand-written inflection rules, then
POS-informed lemmatization, with every ``-ing`` form treated as a verb), and
the first exact sub-sequence match wins.

Returns spans both by word index (used by the model) and by char offset
(used for audits/visualization).
"""

from __future__ import annotations

from stair_tpu_torch.programs import text
from stair_tpu_torch.programs.parser import ALL_RESERVED

# Inflection fixups applied before lemmatization. ref: utils/agqa_lite.py:25-26
QUESTION_WORD_RULES = {
    "consume": "eat", "consuming": "eat", "ate": "eat", "taking": "take",
    "sneezing": "sneeze", "drank": "drink", "wiping": "wipe",
    "drinking": "drink", "closing": "close", "lay": "lie",
}
PROGRAM_WORD_RULES = {
    "opening": "open", "closing": "close", "sitting on": "sit",
    "playing on": "play", "drinking": "drink", "putting down": "put",
    "consuming": "eat",
}


def _normalize_question_words(words: list[str]) -> list[str]:
    words = [QUESTION_WORD_RULES.get(w, w) for w in words]
    tagged = text.pos_tag(words)
    tagged = [(w, "V") if w.endswith("ing") else (w, pos) for w, pos in tagged]
    out = []
    for word, pos in tagged:
        p = pos[0].lower()
        if p in ("v", "n") and word != "clothes":
            out.append(text.lemmatize(word, p))
        else:
            out.append(word)
    return out


def _normalize_program_words(phrase: str) -> list[str]:
    phrase = phrase.replace("_", " ")
    phrase = PROGRAM_WORD_RULES.get(phrase, phrase)
    words = [PROGRAM_WORD_RULES.get(w, w) for w in text.tokenize(phrase)]
    out = []
    for word, pos in text.pos_tag(words):
        if pos[0] in ("V", "N"):
            out.append(text.lemmatize(word, pos[0].lower()))
        else:
            out.append(word)
    return out


def _find_subsequence(haystack: list[str], needle: list[str]) -> int | None:
    for i in range(len(haystack) - len(needle)):
        if haystack[i:i + len(needle)] == needle:
            return i
    return None


def link_program_spans(tokens: list[str] | None, question: str):
    """Map each free-text program token to its (start, end) question span.

    Returns ``(span_by_word, span_by_char)`` dicts keyed by program-token
    position; unmatched tokens map to ``(None, None)``. Returns
    ``(None, None)`` if ``tokens`` is None.
    """
    if tokens is None:
        return None, None

    question_words = text.tokenize(question)
    # Char offsets of each question token (scanning left to right).
    char_spans: list[tuple[int, int]] = []
    cursor = 0
    for word in question_words:
        start = question.index(word, cursor)
        char_spans.append((start, start + len(word)))
        cursor = start
    normalized_question = _normalize_question_words(question_words)

    span_by_word: dict[int, tuple] = {}
    span_by_char: dict[int, tuple] = {}
    for pos, tok in enumerate(tokens):
        if tok in ALL_RESERVED:
            continue
        needle = _normalize_program_words(tok)
        start = _find_subsequence(normalized_question, needle)
        if start is None:
            span_by_word[pos] = (None, None)
            span_by_char[pos] = (None, None)
        else:
            end = start + len(needle)
            span_by_word[pos] = (start, end)
            span_by_char[pos] = (char_spans[start][0], char_spans[end - 1][1])
    return span_by_word, span_by_char
