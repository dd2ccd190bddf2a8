"""Self-contained Penn-Treebank-style word tokenizer (copy of
``style_seqcvae_tpu/data/tokenizer.py:1-95``).

The reference tokenizes captions with ``nltk.word_tokenize`` and strips a
fixed punctuation list (updown-baseline/updown/data/readers.py:148-152,
var_updown/scripts/build_vocabulary.py:40-43). NLTK's tokenizer needs the
"punkt" model download, which is unavailable offline, so this module provides
a deterministic treebank-style tokenizer reproducing ``word_tokenize``
behavior on caption-style text (lowercased single sentences). If NLTK with
punkt data is installed it is used instead, keeping bit-parity where the
reference environment exists.
"""

from __future__ import annotations

import re
from typing import List

# Same fixed list as the reference.
PUNCTUATIONS: List[str] = [
    "''", "'", "``", "`", "(", ")", "{", "}",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]

_CONTRACTIONS2 = [
    re.compile(r"\b(can)(?#X)(not)\b", re.IGNORECASE),
    re.compile(r"\b(d)(?#X)('ye)\b", re.IGNORECASE),
    re.compile(r"\b(gim)(?#X)(me)\b", re.IGNORECASE),
    re.compile(r"\b(gon)(?#X)(na)\b", re.IGNORECASE),
    re.compile(r"\b(got)(?#X)(ta)\b", re.IGNORECASE),
    re.compile(r"\b(lem)(?#X)(me)\b", re.IGNORECASE),
    re.compile(r"\b(mor)(?#X)('n)\b", re.IGNORECASE),
    re.compile(r"\b(wan)(?#X)(na)(?=\s)", re.IGNORECASE),
]
_CONTRACTIONS3 = [
    re.compile(r"(?<=\s)('t)(?#X)(is)\b", re.IGNORECASE),
    re.compile(r"(?<=\s)('t)(?#X)(was)\b", re.IGNORECASE),
]


def _treebank_tokenize(text: str) -> List[str]:
    """A faithful re-implementation of NLTK's TreebankWordTokenizer rules."""
    # Starting quotes
    text = re.sub(r"^\"", r"``", text)
    text = re.sub(r"(``)", r" \1 ", text)
    text = re.sub(r'([ (\[{<])(")', r"\1 `` ", text)

    # Punctuation
    text = re.sub(r"([:,])([^\d])", r" \1 \2", text)
    text = re.sub(r"([:,])$", r" \1 ", text)
    text = re.sub(r"\.\.\.", r" ... ", text)
    text = re.sub(r"[;@#$%&]", r" \g<0> ", text)
    text = re.sub(r'([^\.])(\.)([\]\)}>"\']*)\s*$', r"\1 \2\3 ", text)
    text = re.sub(r"[?!]", r" \g<0> ", text)
    text = re.sub(r"([^'])' ", r"\1 ' ", text)

    # Parens, brackets, etc.
    text = re.sub(r"[\]\[\(\)\{\}<>]", r" \g<0> ", text)
    text = re.sub(r"--", r" -- ", text)

    # Add extra space to make things easier
    text = " " + text + " "

    # Ending quotes
    text = re.sub(r'"', " '' ", text)
    text = re.sub(r"(\S)('')", r"\1 \2 ", text)
    text = re.sub(r"([^' ])('[sS]|'[mM]|'[dD]|') ", r"\1 \2 ", text)
    text = re.sub(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) ", r"\1 \2 ", text)

    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)

    return text.split()


try:  # pragma: no cover - environment-dependent
    import nltk

    nltk.word_tokenize("probe sentence .")

    def word_tokenize(text: str) -> List[str]:
        return nltk.word_tokenize(text)

except Exception:  # punkt data unavailable → deterministic fallback

    def word_tokenize(text: str) -> List[str]:
        return _treebank_tokenize(text)


def tokenize_caption(caption: str) -> List[str]:
    """Lowercase, tokenize and strip punctuation — the exact preprocessing
    applied to every caption in the reference (readers.py:156-160)."""
    tokens = word_tokenize(caption.lower().strip())
    return [t for t in tokens if t not in PUNCTUATIONS]
