"""The port's offline evaluation (``evaluation/metrics.py``,
``evaluation/eval.py``, ``scripts/eval.py``) against the JAX package's, on
seeded caption sets: every score within 1e-12 absolute.

* ``Bleu`` (with and without its reference corpus), ``Rouge`` (the port's
  pure-Python LCS against JAX's, which batches the same LCS lengths through
  its native library when it loads), ``MeteorPy`` and ``Meteor``: corpus and
  per-image scores, on sets with empty hypotheses, repeated n-grams,
  several references an image and hypotheses whose best ROUGE precision and
  best recall come from different references. METEOR twice: with nltk's
  Porter stemmer, and with the stemmer pinned to the identity on both sides
  (what runs where nltk is absent).
* ``evaluate`` over five z-samples an image with wordforms (the oracle, the
  top-5 diversity and the style numbers): the same keys and values.
* The eval CLI: the same JSON and printed lines as the JAX CLI on the same
  files, with and without ``--id-map`` and ``--wordforms``; ``python -m``.
"""

import importlib.util
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from style_seqcvae_tpu.evaluation import eval as jeval
from style_seqcvae_tpu.evaluation import metrics as jmetrics
from style_seqcvae_tpu_torch.evaluation import eval as teval
from style_seqcvae_tpu_torch.evaluation import metrics as tmetrics
from style_seqcvae_tpu_torch.scripts import eval as P

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_eval_cli", ROOT / "scripts" / "eval.py")
J = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(J)

ATOL = 1e-12
WORDS = ("a man dog cat sitting running runs jumped jumping on the of with in red "
         "happy sad beautiful ugly street grass table ball playing").split()
FORMS = {"pos": ["happy", "beautiful"], "neg": ["sad", "ugly"]}
N_Z = 5


def _caption(rng, lo=0, hi=12):
    return " ".join(rng.choice(WORDS, rng.randint(lo, hi + 1)))


def _caption_sets(seed, images=12):
    """``gts`` (1-4 references an image) and ``res`` (one hypothesis an
    image) with an empty hypothesis, a repeated n-gram, an exact match and
    ROUGE's separate-max case."""
    rng = np.random.RandomState(seed)
    gts = {i: [_caption(rng, 1) for _ in range(rng.randint(1, 5))] for i in range(images)}
    res = {i: [_caption(rng)] for i in range(images)}
    res[0] = [""]                                            # empty hypothesis
    res[1] = ["the dog the dog the dog on the grass"]        # repeated n-grams
    gts[1] = ["the dog on the grass", "a dog the dog running"]
    res[2] = [gts[2][0]]                                     # exact match
    # best precision from the long reference, best recall from the short one
    res[3] = ["a man sitting on a table"]
    gts[3] = ["a man", "a man sitting with a red ball on the table in the street"]
    return gts, res


def _assert_scores(got, want):
    corpus_got, per_got = got
    corpus_want, per_want = want
    np.testing.assert_allclose(np.asarray(corpus_got, float), np.asarray(corpus_want, float),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(per_got, float), np.asarray(per_want, float),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_bleu_and_rouge_match_jax(seed):
    gts, res = _caption_sets(seed)
    _assert_scores(tmetrics.Bleu().compute_score(gts, res),
                   jmetrics.Bleu().compute_score(gts, res))
    corpus = tmetrics.Bleu().make_corpus(gts)
    _assert_scores(tmetrics.Bleu().compute_score(gts, res, corpus=corpus),
                   jmetrics.Bleu().compute_score(gts, res))
    got, want = tmetrics.Rouge().compute_score(gts, res), jmetrics.Rouge().compute_score(gts, res)
    _assert_scores(got, want)
    assert got[1][0] == 0.0 and got[1][2] == 1.0
    # the separate-max case: max precision 5/6 from the long reference (LCS
    # "a man sitting on table"), max recall 2/2 from the short one
    b2 = 1.2 ** 2
    p, r = 5 / 6, 1.0
    assert got[1][3] == pytest.approx((1 + b2) * p * r / (r + b2 * p), abs=ATOL)
    assert tmetrics._lcs_len("a b c d".split(), "b x d".split()) == \
        jmetrics._lcs_len("a b c d".split(), "b x d".split()) == 2


@pytest.fixture(params=["nltk", "identity"])
def stemmer(request, monkeypatch):
    """METEOR's stem stage on both sides: nltk's Porter stemmer, or the
    identity (where nltk is absent)."""
    for mod in (jmetrics, tmetrics):
        monkeypatch.setattr(mod, "_STEMMER",
                            None if request.param == "nltk" else (lambda w: w))
    want = "run" if request.param == "nltk" else "running"
    assert tmetrics._porter_stem("running") == jmetrics._porter_stem("running") == want
    return request.param


@pytest.mark.parametrize("seed", [0, 1])
def test_meteor_matches_jax(seed, stemmer, monkeypatch):
    monkeypatch.delenv("METEOR_JAR", raising=False)
    gts, res = _caption_sets(seed)
    _assert_scores(tmetrics.MeteorPy().compute_score(gts, res),
                   jmetrics.MeteorPy().compute_score(gts, res))
    meteor = tmetrics.Meteor()
    assert isinstance(meteor._impl, tmetrics.MeteorPy)
    _assert_scores(meteor.compute_score(gts, res), jmetrics.Meteor().compute_score(gts, res))
    # the stem stage matches "runs"/"running" only with a stemmer
    s = tmetrics.MeteorPy.sentence_score("a dog runs".split(), "a dog running".split())
    assert s == jmetrics.MeteorPy.sentence_score("a dog runs".split(), "a dog running".split())
    assert (s > tmetrics.MeteorPy.sentence_score("a dog".split(), "a dog running".split())) \
        == (stemmer == "nltk")


def test_meteor_java_needs_the_jar(monkeypatch, tmp_path):
    monkeypatch.delenv("METEOR_JAR", raising=False)
    for mod in (jmetrics, tmetrics):
        with pytest.raises(RuntimeError, match="METEOR_JAR"):
            mod.MeteorJava()
        assert not mod._jvm_meteor_available() and mod.meteor_available()
    monkeypatch.setenv("METEOR_JAR", str(tmp_path / "missing.jar"))
    with pytest.raises(RuntimeError, match="METEOR_JAR"):
        tmetrics.MeteorJava()
    assert isinstance(tmetrics.Meteor()._impl, tmetrics.MeteorPy)


def _predictions(seed, images=6, id_of=lambda i: i):
    rng = np.random.RandomState(seed)
    preds = [{"image_id": id_of(i), "caption": _caption(rng)} for i in range(images)
             for _ in range(N_Z)]
    preds[3]["caption"] = ""
    preds[7]["caption"] = "happy happy dog on the grass"
    return preds


def _annotations(seed, images=8, id_of=lambda i: i):
    """COCO-style references, with punctuation and capitals for the tokenizer."""
    rng = np.random.RandomState(seed + 100)
    anns, k = [], 0
    for i in range(images):
        for _ in range(rng.randint(2, 5)):
            anns.append({"id": k, "image_id": id_of(i),
                         "caption": _caption(rng, 2).capitalize() + "."})
            k += 1
    return {"annotations": anns}


def test_evaluate_matches_jax(monkeypatch):
    monkeypatch.delenv("METEOR_JAR", raising=False)
    annots = _annotations(3)
    gts = teval.preprocess_coco_annots(annots)
    assert gts == jeval.preprocess_coco_annots(annots)
    preds = _predictions(4)
    want = jeval.evaluate(preds, gts, wordforms=FORMS)
    got = teval.evaluate(preds, gts, wordforms=FORMS)
    assert list(got) == list(want)
    assert {"top5 Div-1", "top5 Div-2", "meteor", "senti_prec", "has_anp"} <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=ATOL, rel=0), k
    for k in ("B1", "B4", "rouge", "cider", "meteor"):
        assert got[k] >= got[f"mean {k}"] - ATOL, k
    # the pieces on their own
    res, g = teval.preprocess_updown_output(preds, gts)
    jres, jg = jeval.preprocess_updown_output(preds, gts)
    assert res == jres and g == jg and len(res) == N_Z
    assert teval.eval_style(g, res, FORMS) == jeval.eval_style(jg, jres, FORMS)
    for n in (1, 2):
        assert teval.n_gram_diversity(preds, n) == jeval.n_gram_diversity(preds, n)
    no_meteor = teval.evaluate(preds, gts, do_meteor=False)
    assert "meteor" not in no_meteor and no_meteor["cider"] == got["cider"]


def _files(tmp_path, id_map):
    """Predictions, references, wordforms and (with ``id_map``) the pickled
    reference → prediction id map."""
    ref_id = (lambda i: 500 + i) if id_map else (lambda i: i)
    (tmp_path / "preds.json").write_text(json.dumps(_predictions(5)))
    (tmp_path / "refs.json").write_text(json.dumps(_annotations(6, id_of=ref_id)))
    (tmp_path / "forms.tsv").write_text("".join(f"{k}\t{','.join(v)}\n"
                                                for k, v in FORMS.items()))
    args = ["--predictions", str(tmp_path / "preds.json"),
            "--references", str(tmp_path / "refs.json")]
    if id_map:
        with open(tmp_path / "map.pkl", "wb") as f:
            pickle.dump({500 + i: i for i in range(8)}, f)
        args += ["--id-map", str(tmp_path / "map.pkl")]
    return args


@pytest.mark.parametrize("variant", ["plain", "id_map_wordforms"])
def test_eval_cli_matches_jax_cli(tmp_path, capsys, monkeypatch, variant):
    monkeypatch.delenv("METEOR_JAR", raising=False)
    args = _files(tmp_path, id_map=variant != "plain")
    if variant != "plain":
        args += ["--wordforms", str(tmp_path / "forms.tsv")]
        assert teval.read_wordforms(str(tmp_path / "forms.tsv")) == FORMS
    monkeypatch.setattr(sys, "argv", ["eval.py", *args, "--output", str(tmp_path / "j.json")])
    J.main()
    want_out = capsys.readouterr().out
    assert P.main([*args, "--output", str(tmp_path / "t.json")]) == 0
    got_out = capsys.readouterr().out
    assert got_out == want_out and len(got_out.splitlines()) >= 18
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=ATOL, rel=0), k
    assert ("senti_prec" in got) == (variant != "plain")


def test_eval_cli_runs_as_a_module(tmp_path):
    args = _files(tmp_path, id_map=False)
    res = subprocess.run([sys.executable, "-m", "style_seqcvae_tpu_torch.scripts.eval", *args,
                          "--output", str(tmp_path / "o.json")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads((tmp_path / "o.json").read_text())
    assert res.stdout.splitlines()[0] == f"Div-1: {round(out['Div-1'], 4)}"
    assert all(np.isfinite(v) for v in out.values())
