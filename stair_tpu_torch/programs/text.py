"""Host-side text processing with an nltk backend and a pure-Python fallback.

The reference preprocessing (yellow-binary-tree/STAIR ``utils/agqa_lite.py:81-119``,
``video_nmn/dataset.py:14-17``) relies on nltk's punkt tokenizer, perceptron
POS tagger and WordNet lemmatizer. Those models need downloaded data files;
in an air-gapped environment they may be absent. This module exposes the same
three primitives — ``tokenize``, ``pos_tag``, ``lemmatize`` — and uses real
nltk when its data is installed, falling back to deterministic pure-Python
approximations otherwise (a regex word tokenizer, a suffix-heuristic tagger
and a small rule-based English lemmatizer). The fallback is exact for the
restricted vocabulary that appears in AGQA questions/programs far more often
than not, and — crucially — is deterministic, so preprocessing stays
reproducible either way.
"""

from __future__ import annotations

import re
from functools import lru_cache

# ---------------------------------------------------------------------------
# Backend detection
# ---------------------------------------------------------------------------


def _probe_nltk():
    try:
        import nltk
        from nltk.stem import WordNetLemmatizer
        from nltk.tokenize import word_tokenize

        word_tokenize("probe sentence")
        nltk.pos_tag(["probe"])
        WordNetLemmatizer().lemmatize("running", "v")
        return True
    except Exception:
        return False


HAVE_NLTK = _probe_nltk()

# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------

# Treebank-style contraction handling for the fallback tokenizer.
_CONTRACTIONS = re.compile(r"(?i)\b(\w+)(n't|'ll|'re|'ve|'s|'m|'d)\b")
_TOKEN_RE = re.compile(r"\w+|[^\w\s]")


def tokenize(sentence: str) -> list[str]:
    """Split a sentence into word tokens."""
    if HAVE_NLTK:
        from nltk.tokenize import word_tokenize

        return word_tokenize(sentence)
    out: list[str] = []
    for chunk in sentence.split():
        m = _CONTRACTIONS.match(chunk)
        if m:
            out.append(m.group(1))
            out.append(m.group(2))
            rest = chunk[m.end():]
            if rest:
                out.extend(_TOKEN_RE.findall(rest))
        else:
            out.extend(_TOKEN_RE.findall(chunk))
    return out


# ---------------------------------------------------------------------------
# POS tagging
# ---------------------------------------------------------------------------

# Closed-class words the fallback tagger should never call nouns/verbs.
_FUNCTION_WORDS = {
    "the": "DT", "a": "DT", "an": "DT", "some": "DT", "this": "DT",
    "that": "DT", "these": "DT", "those": "DT",
    "they": "PRP", "he": "PRP", "she": "PRP", "it": "PRP", "i": "PRP",
    "we": "PRP", "you": "PRP", "person": "NN",
    "in": "IN", "on": "IN", "at": "IN", "of": "IN", "to": "TO",
    "before": "IN", "after": "IN", "while": "IN", "between": "IN",
    "and": "CC", "or": "CC", "but": "CC",
    "did": "VBD", "do": "VB", "does": "VBZ", "was": "VBD", "were": "VBD",
    "is": "VBZ", "are": "VBP", "be": "VB", "been": "VBN",
    "which": "WDT", "what": "WP", "who": "WP", "how": "WRB", "when": "WRB",
    "where": "WRB", "why": "WRB",
    "first": "JJ", "last": "JJ", "longest": "JJS", "shortest": "JJS",
    "not": "RB", "no": "DT", "yes": "UH",
    "their": "PRP$", "his": "PRP$", "her": "PRP$", "its": "PRP$",
    "?": ".", ".": ".", ",": ",",
}

# Common irregular past forms seen in activity questions.
_IRREGULAR_VERBS = {
    "took", "held", "ate", "sat", "stood", "threw", "put", "ran", "lay",
    "went", "drank", "began", "got", "left", "made", "opened", "closed",
}


def pos_tag(words: list[str]) -> list[tuple[str, str]]:
    """Tag each word with a Penn-Treebank-style POS tag."""
    if HAVE_NLTK:
        import nltk

        return nltk.pos_tag(words)
    tags = []
    for w in words:
        lw = w.lower()
        if lw in _FUNCTION_WORDS:
            tags.append((w, _FUNCTION_WORDS[lw]))
        elif lw in _IRREGULAR_VERBS:
            tags.append((w, "VBD"))
        elif lw.endswith("ing"):
            tags.append((w, "VBG"))
        elif lw.endswith("ed"):
            tags.append((w, "VBD"))
        elif lw.endswith("ly"):
            tags.append((w, "RB"))
        elif lw.endswith("est"):
            tags.append((w, "JJS"))
        else:
            tags.append((w, "NN"))
    return tags


# ---------------------------------------------------------------------------
# Lemmatization
# ---------------------------------------------------------------------------

# Irregular verb lemmas common in AGQA/Charades activity language.
_VERB_LEMMAS = {
    "took": "take", "taken": "take", "taking": "take",
    "held": "hold", "holding": "hold",
    "ate": "eat", "eaten": "eat", "eating": "eat",
    "sat": "sit", "sitting": "sit",
    "stood": "stand", "standing": "stand",
    "threw": "throw", "thrown": "throw", "throwing": "throw",
    "putting": "put", "ran": "run", "running": "run",
    "lay": "lie", "lying": "lie", "laying": "lay",
    "went": "go", "going": "go", "gone": "go",
    "drank": "drink", "drunk": "drink", "drinking": "drink",
    "began": "begin", "begun": "begin", "beginning": "begin",
    "got": "get", "gotten": "get", "getting": "get",
    "left": "leave", "leaving": "leave",
    "made": "make", "making": "make",
    "was": "be", "were": "be", "is": "be", "are": "be", "been": "be",
    "did": "do", "done": "do", "doing": "do",
    "had": "have", "has": "have", "having": "have",
    "grasping": "grasp", "snuggling": "snuggle", "smiling": "smile",
    "sneezing": "sneeze", "washing": "wash", "watching": "watch",
    "opening": "open", "closing": "close", "tidying": "tidy",
    "wiping": "wipe", "pouring": "pour", "playing": "play",
    "touching": "touch", "turning": "turn", "walking": "walk",
    "working": "work", "dressing": "dress", "fixing": "fix",
    "awakening": "awaken", "laughing": "laugh", "cooking": "cook",
    "reaching": "reach", "leaning": "lean", "carrying": "carry",
    "covering": "cover", "undressing": "undress", "photographing":
    "photograph", "talking": "talk", "looking": "look", "starting": "start",
}

# Nouns whose plural is irregular or that look plural but are not.
_NOUN_LEMMAS = {
    "dishes": "dish", "boxes": "box", "glasses": "glass", "shoes": "shoe",
    "clothes": "clothes", "groceries": "grocery", "shelves": "shelf",
    "feet": "foot", "children": "child", "people": "person",
}

_VOWELS = set("aeiou")


def _strip_verb_suffix(word: str) -> str:
    if word.endswith("ing") and len(word) > 5:
        stem = word[:-3]
        if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            return stem[:-1]          # running -> run
        if stem.endswith(("at", "iv", "ak", "in", "id", "os", "ut", "ap")):
            return stem + "e"         # making -> make (approximate)
        return stem
    if word.endswith("ied") and len(word) > 4:
        return word[:-3] + "y"        # tidied -> tidy
    if word.endswith("ed") and len(word) > 4:
        stem = word[:-2]
        if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            return stem[:-1]
        if stem.endswith(("at", "iv", "os", "ut")):
            return stem + "e"
        return stem
    if word.endswith("s") and not word.endswith(("ss", "us", "is")):
        return word[:-1]              # opens -> open
    return word


def _strip_noun_suffix(word: str) -> str:
    if word.endswith("ies") and len(word) > 4:
        return word[:-3] + "y"
    if word.endswith(("ses", "xes", "zes", "ches", "shes")):
        return word[:-2]
    if word.endswith("s") and not word.endswith(("ss", "us", "is")):
        return word[:-1]
    return word


@lru_cache(maxsize=65536)
def lemmatize(word: str, pos: str = "n") -> str:
    """Lemmatize ``word`` with WordNet semantics; ``pos`` in {'n', 'v'}."""
    if HAVE_NLTK:
        from nltk.stem import WordNetLemmatizer

        return WordNetLemmatizer().lemmatize(word, pos)
    lw = word.lower()
    if pos == "v":
        if lw in _VERB_LEMMAS:
            return _VERB_LEMMAS[lw]
        return _strip_verb_suffix(lw)
    if lw in _NOUN_LEMMAS:
        return _NOUN_LEMMAS[lw]
    return _strip_noun_suffix(lw)


def stopword_set() -> set[str]:
    """The English stopword set (nltk's when available)."""
    if HAVE_NLTK:
        try:
            from nltk.corpus import stopwords

            return set(stopwords.words("english"))
        except Exception:
            pass
    return {
        "i", "me", "my", "we", "our", "you", "your", "he", "him", "his",
        "she", "her", "it", "its", "they", "them", "their", "what", "which",
        "who", "this", "that", "these", "those", "am", "is", "are", "was",
        "were", "be", "been", "being", "have", "has", "had", "do", "does",
        "did", "a", "an", "the", "and", "but", "if", "or", "as", "of", "at",
        "by", "for", "with", "about", "to", "from", "in", "on", "off",
        "over", "under", "again", "then", "once", "here", "there", "when",
        "where", "why", "how", "all", "any", "both", "each", "few", "more",
        "most", "other", "some", "such", "no", "nor", "not", "only", "own",
        "same", "so", "than", "too", "very", "can", "will", "just", "don",
        "should", "now", "while", "before", "after", "between", "during",
    }
