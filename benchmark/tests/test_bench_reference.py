"""The plain reference against the port on the CPU at a tiny size, and the
traffic's two FSM forms against each other."""

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.drivers import cbs_decode
from benchmark.reference import captioner as ref

SEED = 2 ** 31 + 12345


def decoded(cfg, traffic, units=2):
    d = cbs_decode.Driver(cfg, traffic, SEED, torch.device("cpu"))
    d.start()
    for i in range(units):
        d.unit(i)
    d.release()
    return d


def test_port_matches_the_reference_in_f32(tiny):
    _, cfg, traffic = tiny["ssc_cbs_f32"]
    got = decoded(cfg, traffic).readings(2, ["program"], ["lp_gap", "mismatch", "score_drop"])
    assert got["program"]["mismatch"] == 0.0
    assert got["program"]["lp_gap"] < 1e-4
    assert abs(got["program"]["score_drop"]) < 1e-4


def test_the_reference_scores_its_own_captions(tiny):
    _, cfg, traffic = tiny["ssc_cbs_f32"]
    x = generate.cbs_groups(traffic, cfg, SEED, 0, torch.device("cpu"))
    w = ref.make_weights(cfg, 7, "cpu", torch.float32)
    best, lp = cbs_decode.reference_best(w, cfg, traffic, x, "float32", "f32")
    forced = cbs_decode.reference_scores(w, cfg, traffic, x, best, "float32")
    assert torch.allclose(forced, lp, atol=1e-4)


def test_exception_tables_are_the_dense_fsm(tiny):
    _, cfg, traffic = tiny["ssc_cbs_f32"]
    x = generate.cbs_groups(traffic, cfg, SEED, 3, torch.device("cpu"))
    S, V = 2 ** traffic["constraints_per_image"], cfg["vocab_size"]
    dense = ref.dense_fsm(torch.from_numpy(x["wordforms"]), S, V).numpy()
    default, tok, dest, valid = (t[0] for t in x["tables"])        # z = 0
    for b in range(dense.shape[0]):
        for s in range(S):
            want = np.zeros((S, V), bool)
            want[default[b, s]] = True
            for t, d, v in zip(tok[b, s], dest[b, s], valid[b, s]):
                if v:
                    want[default[b, s], t] = False
                    want[d, t] = True
            assert (dense[b, s] == want).all()


def test_inputs_repeat_from_the_seed(tiny):
    _, cfg, traffic = tiny["ssc_cbs_f32"]
    a = generate.cbs_groups(traffic, cfg, SEED, 5, torch.device("cpu"))
    b = generate.cbs_groups(traffic, cfg, SEED, 5, torch.device("cpu"))
    c = generate.cbs_groups(traffic, cfg, SEED + 1, 5, torch.device("cpu"))
    assert torch.equal(a["feats"], b["feats"]) and torch.equal(a["noise"], b["noise"])
    assert (a["wordforms"] == b["wordforms"]).all()
    assert not torch.equal(a["feats"], c["feats"])
    assert generate.sub_seed(2 ** 40 + 3, 1, 2) < 2 ** 63


@pytest.mark.parametrize("precision", ["tf32", "bf16", "fp8"])
def test_lower_precisions_stay_near_f32(precision):
    a = torch.randn(16, 32, generator=torch.Generator().manual_seed(0))
    b = torch.randn(32, 8, generator=torch.Generator().manual_seed(1))
    exact = ref.matmul(a, b, "f32")
    err = (ref.matmul(a, b, precision) - exact).abs().max().item() / exact.abs().max().item()
    # a relative rounding of 2^-4 (e4m3) or 2^-8 (bf16) an operand
    assert err < (0.1 if precision == "fp8" else 0.01)
    if precision != "tf32":          # TF32 changes nothing on the CPU
        assert err > 0
