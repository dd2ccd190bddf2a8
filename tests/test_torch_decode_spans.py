"""The port's decode spans (``style_seqcvae_tpu_torch/utils/tracing.py``)
under ``torch.profiler`` on the CPU, at tiny widths: how many of each a
decode opens, how they nest, that the decode's outputs do not move, that
nothing is recorded with the profiler off, and that the benchmark's
readers (``benchmark/spans.py``) look for the names the port emits."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spans as bench_spans
from style_seqcvae_tpu_torch.decoding.cbs_fast import SELECTIONS, fsm_to_tables
from style_seqcvae_tpu_torch.decoding.harness import DecodeHarness
from style_seqcvae_tpu_torch.models.captioner import CaptionerConfig, init_captioner
from style_seqcvae_tpu_torch.utils import tracing

torch.set_num_threads(1)

V, B, NZ, S, BEAM, T, NBOX, F, Z = 40, 2, 2, 4, 4, 5, 5, 12, 4
CFG = CaptionerConfig(vocab_size=V, image_feature_size=F, embedding_size=300, hidden_size=10,
                      attention_projection_size=6, z_space=Z, sentiment_vae=1,
                      simple_vae=False, max_caption_length=T, beam_size=BEAM)


def _fsm(rng):
    """Two single-word constraints of two wordforms each over S = 4 states."""
    f = np.zeros((S, S, V), np.uint8)
    for s in range(S):
        f[s, s, :] = 1
    toks = rng.choice(np.arange(2, V), (2, 2), replace=False)
    for c in range(2):
        for s in range(S):
            if not s & (1 << c):
                for t in toks[c]:
                    f[s, s | (1 << c), t] = 1
                    f[s, s, t] = 0
    return f


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    harness = DecodeHarness(init_captioner(CFG, seed=3, device="cpu"), CFG, device="cpu")
    feats = rng.randn(B, NBOX, F).astype(np.float32)
    sentiment = rng.choice([-1.0, 1.0], (B, 1)).astype(np.float32)
    tables = [[fsm_to_tables(_fsm(rng)) for _ in range(NZ)] for _ in range(B)]
    noise = rng.randn(NZ, T, B, 1, 1, Z).astype(np.float32)
    return harness, feats, sentiment, tables, noise


def _cbs(case, selection="prehead"):
    harness, feats, sentiment, tables, noise = case
    return harness.decode_cbs(feats, sentiment, None, tables, 2, noise, NZ, selection=selection)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("ssc.")]


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p.name
        p = p.cpu_parent


@pytest.mark.parametrize("selection", SELECTIONS)
def test_one_cbs_decode_opens_each_span_as_often_as_it_does_the_work(case, selection):
    _, events = _profiled(lambda: _cbs(case, selection))
    got = Counter(e.name for e in events)
    assert got[tracing.DECODE_CBS] == 1 and got[tracing.CBS_FINISH] == 1
    assert got[tracing.STEP] == T and got[tracing.STEP_ATTENTION] == T
    assert got[tracing.CBS_SELECT] == T - 1 and got[tracing.CBS_SEARCH] == T - 1
    assert got[tracing.CBS_SETUP] >= 1
    assert set(got) == set(tracing.NAMES)


def test_the_spans_nest_under_the_decode(case):
    _, events = _profiled(lambda: _cbs(case))
    for e in events:
        up = list(_ancestors(e))
        if e.name != tracing.DECODE_CBS:
            assert tracing.DECODE_CBS in up, e.name
        if e.name == tracing.STEP_ATTENTION:
            assert up[0] == tracing.STEP
    first = min((e for e in events if e.name == tracing.STEP), key=lambda e: e.time_range.start)
    assert first.cpu_parent.name == tracing.CBS_SETUP


@pytest.mark.parametrize("method", ["beam", "multinomial"])
def test_beam_search_and_the_samplers_open_a_step_span_a_step(case, method):
    harness, feats, sentiment, _, _ = case
    gen = torch.Generator().manual_seed(5)
    if method == "beam":
        def run():
            return harness.decode_beam(feats, sentiment, None, gen, NZ)
    else:
        def run():
            return harness.decode_sample(feats, sentiment, None, gen, NZ, method)
    _, events = _profiled(run)
    got = Counter(e.name for e in events)
    assert got == {tracing.STEP: T, tracing.STEP_ATTENTION: T}


def test_outputs_are_bit_equal_with_the_profiler_on_and_off(case):
    best, lp = _cbs(case)
    (best_p, lp_p), _ = _profiled(lambda: _cbs(case))
    assert torch.equal(best, best_p) and torch.equal(lp, lp_p)


def test_no_range_is_opened_with_the_profiler_off(case, monkeypatch):
    entered = []

    def spy(name, *args, **kwargs):
        entered.append(name)
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    _cbs(case)
    assert entered == []
    assert tracing.span(tracing.STEP) is tracing.span(tracing.CBS_SEARCH)


def test_the_readers_look_for_the_names_the_port_emits():
    assert bench_spans.NAMES == tracing.NAMES
    assert (bench_spans.DECODE, bench_spans.SETUP, bench_spans.STEP, bench_spans.ATTENTION,
            bench_spans.SELECT, bench_spans.SEARCH, bench_spans.FINISH) == \
        (tracing.DECODE_CBS, tracing.CBS_SETUP, tracing.STEP, tracing.STEP_ATTENTION,
         tracing.CBS_SELECT, tracing.CBS_SEARCH, tracing.CBS_FINISH)
