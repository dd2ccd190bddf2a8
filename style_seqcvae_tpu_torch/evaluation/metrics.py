"""Caption metrics, pure Python: BLEU-1..4, ROUGE-L, CIDEr and METEOR (a copy
of ``style_seqcvae_tpu/evaluation/metrics.py``, which the port may not
import).

The pycocoevalcap algorithms the reference imports (eval/eval.py:10-13),
with their quirks:

* BLEU: corpus-level with the "closest" reference length, the 1e-15 / 1e-9
  smoothing constants and the brevity penalty of pycocoevalcap's
  ``bleu_scorer.py``.
* ROUGE-L: beta 1.2, the largest precision and the largest recall taken over
  the references separately before the F-measure. Always the pure-Python
  LCS dynamic programme: the JAX package batches the same LCS lengths
  through its native library, whose scores are identical.
* CIDEr: tf-idf over 1-4-grams with document frequency from the
  references, ``ref_len = log(#images)``, clipped similarity, a Gaussian
  length penalty (sigma 6), ×10, and a sentence "length" counted from bigram
  totals. :class:`CiderCorpus` holds the reference side once for scoring
  many candidate sets (the oracle re-score).
* METEOR: :class:`Meteor` runs the meteor-1.5 JVM jar when ``METEOR_JAR``
  points at it and java is on the path, else the pure-Python exact + stem
  :class:`MeteorPy`, which stems with nltk's Porter stemmer when nltk
  imports and with the identity otherwise.

``compute_score(gts, res) -> (corpus_score, per_image_scores)`` is
pycocoevalcap's contract.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngram_counts(words: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class Bleu:
    def __init__(self, n: int = 4):
        self._n = n

    def make_corpus(self, gts: Dict) -> Dict:
        """Precompute reference-side BLEU state (split lengths + clipped
        max n-gram counts per image). Pass to ``compute_score`` when scoring
        many candidate sets (per-z / oracle loops) against the same refs."""
        n = self._n
        corpus = {}
        for image_id in gts:
            ref_lens = [len(r.split()) for r in gts[image_id]]
            maxcounts: Dict[tuple, int] = defaultdict(int)
            for r in gts[image_id]:
                for ng, c in _ngram_counts(r.split(), n).items():
                    maxcounts[ng] = max(maxcounts[ng], c)
            corpus[image_id] = (ref_lens, maxcounts)
        return corpus

    def compute_score(self, gts: Dict, res: Dict,
                      corpus: Dict = None) -> Tuple[List[float], List[List[float]]]:
        n = self._n
        small, tiny = 1e-9, 1e-15
        total_testlen = 0
        total_reflen = 0
        total_guess = [0] * n
        total_correct = [0] * n
        per_image: List[List[float]] = [[] for _ in range(n)]

        for image_id in gts:
            hyp = res[image_id][0].split()
            testlen = len(hyp)
            if corpus is not None:
                ref_lens, maxcounts = corpus[image_id]
            else:
                refs = [r.split() for r in gts[image_id]]
                ref_lens = [len(r) for r in refs]
                maxcounts = defaultdict(int)
                for r in refs:
                    for ng, c in _ngram_counts(r, n).items():
                        maxcounts[ng] = max(maxcounts[ng], c)
            # closest reference length (ties → shorter, per pycocoevalcap)
            reflen = min((abs(rl - testlen), rl) for rl in ref_lens)[1]
            hyp_counts = _ngram_counts(hyp, n)
            guess = [max(0, testlen - k) for k in range(n)]
            correct = [0] * n
            for ng, c in hyp_counts.items():
                correct[len(ng) - 1] += min(c, maxcounts.get(ng, 0))

            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            # per-segment scores (used by the oracle argmax)
            bleu = 1.0
            for k in range(n):
                bleu *= (correct[k] + tiny) / (guess[k] + small)
                b = bleu ** (1.0 / (k + 1))
                ratio = (testlen + tiny) / (reflen + small)
                if ratio < 1:
                    b *= math.exp(1 - 1 / ratio)
                per_image[k].append(b)

        corpus_scores: List[float] = []
        bleu = 1.0
        for k in range(n):
            bleu *= (total_correct[k] + tiny) / (total_guess[k] + small)
            b = bleu ** (1.0 / (k + 1))
            ratio = (total_testlen + tiny) / (total_reflen + small)
            if ratio < 1:
                b *= math.exp(1 - 1 / ratio)
            corpus_scores.append(b)
        return corpus_scores, per_image


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self._beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        hyp = candidate[0].split()
        prec, rec = [], []
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            b2 = self._beta ** 2
            return ((1 + b2) * prec_max * rec_max) / (rec_max + b2 * prec_max)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        scores = [self.calc_score(res[i], gts[i]) for i in gts]
        return float(sum(scores) / len(scores)), scores


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


def _porter_stem(word: str) -> str:
    """Porter stem via nltk when importable (pure Python, no downloads),
    identity otherwise."""
    global _STEMMER
    if _STEMMER is None:
        try:
            from nltk.stem.porter import PorterStemmer

            _STEMMER = PorterStemmer().stem
        except Exception:
            _STEMMER = lambda w: w  # noqa: E731
    return _STEMMER(word)


_STEMMER = None


# Closed-class English function words for meteor-1.5's δ weighting
# (meteor ships a frequency-derived list; this is the standard
# closed-class inventory — articles, prepositions, conjunctions,
# pronouns, auxiliaries/modals, common particles).
METEOR_FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every either neither no
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves themselves who whom whose which what
in on at by for with about against between into through during before
after above below to from up down out off over under again further of
and or but nor so yet if then else when while because although though
since unless until whether as than
be am is are was were been being have has had having do does did doing
will would shall should may might must can could ought
not n't there here all both few more most other such only own same just
""".split())


class MeteorPy:
    """Pure-Python METEOR — the offline replacement for the meteor-1.5 JVM
    jar the reference's eval spawns (eval/eval.py:13,317-320 via
    pycocoevalcap).

    Implements the meteor-1.5 scoring formula (Denkowski & Lavie 2014,
    English task parameters): matcher stages **exact** (weight 1.0) then
    **Porter-stem** (weight 0.6), content/function-word weighting δ=0.75
    in weighted precision/recall, F-mean ``P·R / (α·P + (1-α)·R)`` with
    α=0.85, fragmentation penalty ``γ·(chunks/m)^β`` with β=0.2, γ=0.6,
    score = Fmean·(1-penalty), max over references; corpus score = mean
    over images.

    Documented divergences from the jar (no JVM/WordNet offline): the
    synonym and paraphrase stages are absent; the alignment is
    position-greedy per stage rather than the jar's chunk-minimizing beam
    search; the function-word list is the closed-class inventory above
    rather than the jar's corpus-frequency-derived list."""

    alpha, beta, gamma, delta = 0.85, 0.2, 0.6, 0.75
    stage_weights = (1.0, 0.6)           # exact, stem (meteor-1.5 en)

    @staticmethod
    def _align(hyp: List[str], ref: List[str]) -> List[Tuple[int, int, int]]:
        """(hyp_idx, ref_idx, stage) matches: exact stage then stem stage,
        each greedy by hypothesis position over still-unmatched words."""
        matches: List[Tuple[int, int, int]] = []
        used_h = [False] * len(hyp)
        used_r = [False] * len(ref)
        for stage, key in enumerate((lambda w: w, _porter_stem)):
            ref_keys = [key(w) for w in ref]
            for i, hw in enumerate(hyp):
                if used_h[i]:
                    continue
                hk = key(hw)
                for j, rk in enumerate(ref_keys):
                    if not used_r[j] and hk == rk:
                        matches.append((i, j, stage))
                        used_h[i] = used_r[j] = True
                        break
        return sorted(matches)

    @classmethod
    def _count_chunks(cls, matches: List[Tuple[int, int, int]]) -> int:
        chunks = 0
        prev = None
        for i, j, _ in matches:
            if prev is None or i != prev[0] + 1 or j != prev[1] + 1:
                chunks += 1
            prev = (i, j)
        return chunks

    @classmethod
    def _word_weight(cls, word: str) -> float:
        return (1 - cls.delta if word in METEOR_FUNCTION_WORDS
                else cls.delta)

    @classmethod
    def sentence_score(cls, hyp_words: List[str], ref_words: List[str]) -> float:
        matches = cls._align(hyp_words, ref_words)
        m = len(matches)
        if m == 0 or not hyp_words or not ref_words:
            return 0.0
        p_den = sum(cls._word_weight(w) for w in hyp_words)
        r_den = sum(cls._word_weight(w) for w in ref_words)
        p_num = sum(cls.stage_weights[s] * cls._word_weight(hyp_words[i])
                    for i, _, s in matches)
        r_num = sum(cls.stage_weights[s] * cls._word_weight(ref_words[j])
                    for _, j, s in matches)
        p = p_num / p_den
        r = r_num / r_den
        fmean = (p * r) / (cls.alpha * p + (1 - cls.alpha) * r)
        frag = cls._count_chunks(matches) / m
        return fmean * (1 - cls.gamma * frag ** cls.beta)

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        scores = []
        for i in gts:
            hyp = res[i][0].split()
            scores.append(max(self.sentence_score(hyp, ref.split())
                              for ref in gts[i]))
        return float(sum(scores) / len(scores)), scores


class MeteorJava:
    """JVM METEOR wrapper (pycocoevalcap protocol). Requires java and the
    meteor-1.5.jar (env ``METEOR_JAR``)."""

    def __init__(self):
        jar = os.environ.get("METEOR_JAR", "")
        if not (jar and os.path.exists(jar) and shutil.which("java")):
            raise RuntimeError(
                "METEOR requires java + METEOR_JAR pointing at meteor-1.5.jar")
        self._proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en", "-norm"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def close(self) -> None:
        """Terminate the JVM (a 2 GB-heap java process otherwise lives
        until interpreter exit — one leaked per instantiation)."""
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        image_ids = list(gts.keys())
        eval_line = "EVAL"
        for i in image_ids:
            stat_line = "SCORE ||| " + " ||| ".join(gts[i]) + " ||| " + res[i][0]
            self._proc.stdin.write(stat_line.replace("\n", " ") + "\n")
            self._proc.stdin.flush()
            eval_line += " ||| " + self._proc.stdout.readline().strip()
        self._proc.stdin.write(eval_line + "\n")
        self._proc.stdin.flush()
        scores = [float(self._proc.stdout.readline().strip()) for _ in image_ids]
        final = float(self._proc.stdout.readline().strip())
        return final, scores


class Meteor:
    """METEOR with the pycocoevalcap ``compute_score`` protocol: the
    meteor-1.5 jar when java + ``METEOR_JAR`` are present (exact parity with
    the reference, eval/eval.py:317-320), the pure-Python :class:`MeteorPy`
    otherwise — so the metric and its oracle column always compute."""

    def __init__(self):
        self._impl = MeteorJava() if _jvm_meteor_available() else MeteorPy()

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        return self._impl.compute_score(gts, res)


def _jvm_meteor_available() -> bool:
    jar = os.environ.get("METEOR_JAR", "")
    return bool(jar and os.path.exists(jar) and shutil.which("java"))


def meteor_available() -> bool:
    """Always true now that MeteorPy backs the jar-less case."""
    return True
