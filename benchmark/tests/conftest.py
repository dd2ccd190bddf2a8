"""The benchmark's own tests (not collected by the repository's ``pytest
tests/``): ``python -m pytest benchmark/tests`` from the checkout's root.
Tests marked ``cuda`` run on a card and skip without one."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


# widths small enough for the CPU, the structure of the published model
TINY = dict(vocab_size=300, image_feature_size=32, embedding_size=300, hidden_size=24,
            attention_projection_size=16, z_space=8, max_caption_length=8)
TINY_TRAFFIC = dict(images_per_group=3, boxes=5, n_z=4, check_units=2)


@pytest.fixture
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny(spec):
    """The cells at a tiny size: (cell, config, traffic) by cell name."""
    from benchmark import core

    out = {}
    for w in spec["workloads"]:
        cell, cfg, traffic = core.cell_files(spec, w["name"])
        out[w["name"]] = (cell, {**cfg, **TINY}, {**traffic, **TINY_TRAFFIC})
    return copy.deepcopy(out)
