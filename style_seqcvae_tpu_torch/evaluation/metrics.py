"""CIDEr for caption sets, pure Python (a copy of ``CiderCorpus``, ``Cider``
and ``_ngram_counts`` from ``style_seqcvae_tpu/evaluation/metrics.py``,
which the port may not import).

The pycocoevalcap algorithm the reference imports (eval/eval.py:10-13), with
its quirks: tf-idf over 1-4-grams with document frequency from the
references, ``ref_len = log(#images)``, clipped similarity, a Gaussian
length penalty (sigma 6), ×10, and a sentence "length" counted from bigram
totals. :class:`CiderCorpus` holds the reference side once for scoring many
candidate sets (the oracle re-score of BASELINE.json config 4).

BLEU, ROUGE-L and METEOR come with the inference CLI (ROADMAP A5).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngram_counts(words: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class CiderCorpus:
    """Precomputed reference-side state for repeated CIDEr scoring.

    Oracle re-scoring (reference ``eval/eval.py:350-437``) and the config-4
    bench score the SAME reference corpus against many candidate sets (one
    per z-sample). Document frequency and the per-image reference TF-IDF
    vectors depend only on ``gts`` — build them once here and reuse across
    calls; ``compute_score`` then only vectorizes the hypotheses."""

    def __init__(self, gts: Dict, n: int, sigma: float):
        self.image_ids = list(gts.keys())
        self.n = n
        self.sigma = sigma
        doc_freq: Dict[tuple, float] = defaultdict(float)
        for i in self.image_ids:
            seen = set()
            for ref in gts[i]:
                seen.update(_ngram_counts(ref.split(), n).keys())
            for ng in seen:
                doc_freq[ng] += 1
        self.doc_freq = doc_freq
        self.ref_len = math.log(float(len(self.image_ids)))
        # per-image list of vectorized references
        self.ref_vecs = {
            i: [self.counts2vec(_ngram_counts(ref.split(), n))
                for ref in gts[i]]
            for i in self.image_ids
        }

    def counts2vec(self, counts):
        n, doc_freq, ref_len = self.n, self.doc_freq, self.ref_len
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ng, tf in counts.items():
            # .get, NOT [] — doc_freq is a defaultdict shared across calls;
            # indexing would insert a 0.0 for every hypothesis n-gram and
            # grow the reused corpus without bound
            df = math.log(max(1.0, doc_freq.get(ng, 0.0)))
            k = len(ng) - 1
            vec[k][ng] = float(tf) * (ref_len - df)
            norm[k] += vec[k][ng] ** 2
            if k == 1:  # pycocoevalcap quirk: length from bigram totals
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def sim(self, vh, vr, nh, nr, lh, lr):
        n, sigma = self.n, self.sigma
        delta = float(lh - lr)
        val = [0.0] * n
        for k in range(n):
            vrk = vr[k]
            acc = 0.0
            for ng, h in vh[k].items():
                r = vrk.get(ng, 0.0)  # .get: don't grow the shared ref dict
                acc += (h if h < r else r) * r
            if nh[k] != 0 and nr[k] != 0:
                acc /= nh[k] * nr[k]
            val[k] = acc * math.exp(-(delta ** 2) / (2 * sigma ** 2))
        return val


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma

    def make_corpus(self, gts: Dict) -> CiderCorpus:
        """Precompute reference-side state; pass to ``compute_score`` when
        scoring many candidate sets against the same references."""
        return CiderCorpus(gts, self._n, self._sigma)

    def compute_score(self, gts: Dict, res: Dict,
                      corpus: CiderCorpus = None) -> Tuple[float, List[float]]:
        n = self._n
        if corpus is None:
            corpus = CiderCorpus(gts, n, self._sigma)
        elif set(corpus.image_ids) != set(gts.keys()):
            raise ValueError(
                "CiderCorpus was built from different gts than this call's "
                f"({len(corpus.image_ids)} vs {len(gts)} images)")

        scores: List[float] = []
        for i in corpus.image_ids:
            vh, nh, lh = corpus.counts2vec(_ngram_counts(res[i][0].split(), n))
            refs = corpus.ref_vecs[i]
            score = [0.0] * n
            for vr, nr, lr in refs:
                s = corpus.sim(vh, vr, nh, nr, lh, lr)
                score = [a + b for a, b in zip(score, s)]
            score_avg = sum(score) / n / len(refs) * 10.0
            scores.append(score_avg)
        return float(sum(scores) / len(scores)), scores
