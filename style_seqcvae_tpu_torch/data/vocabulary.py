"""Vocabulary with the AllenNLP on-disk format (copy of
``style_seqcvae_tpu/data/vocabulary.py:1-140``).

A directory with ``tokens.txt`` (one token per line; ``@@UNKNOWN@@`` and
``@@BOUNDARY@@`` first) and ``non_padded_namespaces.txt`` holding
``tokens``. The namespace is non-padded, so index 0 is ``@@UNKNOWN@@``,
which doubles as the padding token. :func:`add_constraint_words_to_vocabulary`
adds every wordform of a constraint TSV.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

UNK_TOKEN = "@@UNKNOWN@@"
BOUNDARY_TOKEN = "@@BOUNDARY@@"


class Vocabulary:
    def __init__(self, tokens: List[str]):
        self._index_to_token: List[str] = list(tokens)
        self._token_to_index: Dict[str, int] = {t: i for i, t in enumerate(self._index_to_token)}
        if UNK_TOKEN not in self._token_to_index:
            raise ValueError(f"Vocabulary must contain {UNK_TOKEN}")

    # ------------------------------------------------------------------ io
    @classmethod
    def from_files(cls, directory: str) -> "Vocabulary":
        with open(os.path.join(directory, "tokens.txt")) as f:
            tokens = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(tokens)

    def save_to_files(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "tokens.txt"), "w") as f:
            for t in self._index_to_token:
                f.write(t + "\n")
        with open(os.path.join(directory, "non_padded_namespaces.txt"), "w") as f:
            f.write("tokens")

    # ------------------------------------------------------------- queries
    def get_vocab_size(self) -> int:
        return len(self._index_to_token)

    def get_token_index(self, token: str) -> int:
        return self._token_to_index.get(token, self._token_to_index[UNK_TOKEN])

    def get_token_from_index(self, index: int) -> str:
        return self._index_to_token[index]

    def get_token_to_index_vocabulary(self) -> Dict[str, int]:
        return dict(self._token_to_index)

    @property
    def unk_index(self) -> int:
        return self._token_to_index[UNK_TOKEN]

    @property
    def boundary_index(self) -> int:
        return self._token_to_index[BOUNDARY_TOKEN]

    # ----------------------------------------------------------- mutation
    def add_token(self, token: str) -> int:
        """Add a token if absent; return its index (AllenNLP
        ``add_token_to_namespace`` semantics — duplicates are no-ops)."""
        if token not in self._token_to_index:
            self._token_to_index[token] = len(self._index_to_token)
            self._index_to_token.append(token)
        return self._token_to_index[token]


def add_constraint_words_to_vocabulary(vocabulary: Vocabulary, wordforms_tsvpath: str) -> Vocabulary:
    """Expand the vocabulary with all wordform tokens from a constraint TSV.

    Mirrors updown-baseline/updown/utils/constraints.py:19-53: each TSV row is
    ``class_name<TAB>comma,separated,wordforms``; multi-word forms contribute
    each token separately.
    """
    with open(wordforms_tsvpath) as wordforms_file:
        reader = csv.DictReader(wordforms_file, delimiter="\t", fieldnames=["class_name", "words"])
        for row in reader:
            for word in row["words"].split(","):
                for w in word.split():
                    vocabulary.add_token(w)
    return vocabulary


def build_caption_vocabulary(
    coco_annotations: List[dict],
    senticap_images: List[dict],
    word_count_threshold: int = 5,
    senticap_word_count_threshold: int = 2,
) -> List[str]:
    """Vocabulary construction mirroring
    var_updown/scripts/build_vocabulary.py:55-106: COCO tokens at count ≥ 5
    plus Senticap tokens whose combined (COCO+Senticap) count ≥ 2; specials
    first, rest sorted.

    Known divergence (deliberate): the reference gates Senticap words on the
    senticap image id being in a set built from caption ANNOTATION ids
    (build_vocabulary.py:69 ``image_ids.add(item["id"])`` vs the
    ``senti_coco_id`` filename parse at :82) — an annotation-id/image-id
    confusion that only "works" on real COCO because the two id ranges
    happen to overlap; on any corpus where they don't, every sentiment word
    silently drops out of the vocabulary (this bit round 4's synthetic 70k
    run: its decodes could never emit a sentiment token). We gate on the
    true ``image_id``, the evident intent.
    """
    from style_seqcvae_tpu_torch.data.tokenizer import tokenize_caption

    word_counts: Dict[str, int] = {}
    image_ids = set()
    for item in coco_annotations:
        image_ids.add(item["image_id"])
        for token in tokenize_caption(item["caption"]):
            word_counts[token] = word_counts.get(token, 0) + 1

    word_counts2: Dict[str, int] = {}
    for item in senticap_images:
        senti_coco_id = int(item["filename"].split(".")[0].split("_")[2])
        if senti_coco_id in image_ids:
            for c in item["sentences"]:
                for token in tokenize_caption(c["raw"]):
                    word_counts2[token] = word_counts2.get(token, 0) + 1

    all_tokens = [k for k, v in word_counts.items() if v >= word_count_threshold]
    kept = set(all_tokens)
    for key, count in word_counts2.items():
        combined = count + word_counts.get(key, 0)
        if combined >= senticap_word_count_threshold and key not in kept:
            all_tokens.append(key)
            kept.add(key)

    return [UNK_TOKEN, BOUNDARY_TOKEN] + sorted(all_tokens)
