"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped), its result line, and the run with the timed path broken
underneath."""

import time

import pytest
import torch

from benchmark import core

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(spec, tiny, name, trace=False, seed=2 ** 31 + 99):
    cell, cfg, traffic = tiny[name]
    return core.run_cell(spec, cell, cfg, traffic, seed, 0.5, trace, torch.device("cpu"),
                         time.time())


@pytest.mark.parametrize("name", ["ssc_cbs_f32", "ssc_cbs_bf16"])
def test_the_result_line(spec, tiny, name):
    out = run(spec, tiny, name)
    assert list(out)[:5] == KEYS and list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"captions_per_s", "setup_s"}
    assert set(out["compared"]) == set(tiny[name][2]["limits"])
    assert all(set(v) == {"value", "limit"} for v in out["compared"].values())


def test_the_traced_line(spec, tiny):
    out = run(spec, tiny, "ssc_cbs_f32", trace=True)
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    # no card: the device's readers find nothing; the counted share stays
    assert set(out["metrics"]) == {"mfu.captions"}
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("name", ["ssc_cbs_f32", "ssc_cbs_bf16"])
def test_a_token_altered_where_it_is_produced(spec, tiny, name, monkeypatch):
    """Kernel A's (here its plain version's) best and second-best tokens
    trade places: the captions keep their log-probs, but not their
    tokens."""
    from style_seqcvae_tpu_torch.decoding import cbs_fast

    real = cbs_fast.matmul_top_k_with_lse

    def altered(x, emb, k):
        vals, idx, lse = real(x, emb, k)
        return vals, idx[:, [1, 0] + list(range(2, k))], lse

    monkeypatch.setattr(cbs_fast, "matmul_top_k_with_lse", altered)
    assert run(spec, tiny, name)["correct"] is False
