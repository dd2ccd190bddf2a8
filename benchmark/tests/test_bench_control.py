"""The control on the card: the plain reference at the cell's lower
precision, put in the program's place, at the cell's own widths on one
group a seed, must come out not correct on every seed. Runs on a card:
``python -m pytest benchmark/tests -m cuda``."""

import pytest

from benchmark import core

SEEDS = (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ssc_cbs_f32", "ssc_cbs_bf16"])
def test_the_control_fails(spec, name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.drivers import cbs_decode

    cell, cfg, traffic = core.cell_files(spec, name)
    traffic = {**traffic, "check_units": 1}
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in SEEDS:
        d = cbs_decode.Driver(cfg, traffic, seed, torch.device("cuda", 0))
        d.release()
        control = cbs_decode.CONTROL[traffic["dtype"]]
        got = d.readings(1, [control], list(traffic["limits"]))[control]
        assert any(got[k] > v for k, v in traffic["limits"].items()), (seed, got)
