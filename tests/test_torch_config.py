"""The port's configuration (``config.py``, no PyYAML) against the JAX
package's ``Config`` and ``yaml.safe_load``: equal trees, equal scalars,
the same errors, and the YAML outside the subset refused."""

import math
from pathlib import Path

import pytest
import torch
import yaml

from style_seqcvae_tpu import config as j_config
from style_seqcvae_tpu_torch import config as t_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = str(ROOT / "configs" / "style_seqcvae_senticap.yml")

# the YAML that tests/test_cli_smoke.py writes (its paths made up)
CLI_SMOKE_YAML = """
DATA:
  VOCABULARY: /tmp/cli/vocab
  TRAIN_FEATURES: /tmp/cli/features.h5
  INFER_FEATURES: /tmp/cli/features.h5
  TRAIN_CAPTIONS: /tmp/cli/captions.json
  INFER_CAPTIONS: /tmp/cli/captions.json
  MAX_CAPTION_LENGTH: 8
MODEL:
  IMAGE_FEATURE_SIZE: 32
  EMBEDDING_SIZE: 16
  HIDDEN_SIZE: 24
  ATTENTION_PROJECTION_SIZE: 12
  Z_SPACE: 10
OPTIM:
  BATCH_SIZE: 4
  NUM_ITERATIONS: 30
  LR: 0.05
"""

# every kind of value the subset holds, and the scalars YAML 1.1 resolves
SUBSET_YAML = """
# a comment
RANDOM_SEED: 0x1A   # hex
DATA:
  SENTICAP_SENTIMENT: 'neg'
  VOCABULARY: "data/v # not a comment"
  MAX_BOXES: 0o7
  DO_LOAD_COCO: off
  ATT_PRED_THRESH: .5
  SENTIGLOVE: ~
  CBS:
    NMS_THRESHOLD: 8.5e-1
MODEL:
  KLD_WEIGHT: 1_000
  PRIOR_STD: 1e-3
  LATENT_EMBEDDING: senti_word_net
DET:
  ANCHOR_SCALES: [2, 4, 8,]
  ANCHOR_RATIOS:
  - 0.5
  - 1
  PIXEL_MEANS:
    - 1.0e+2
    - 110
    - 120.5
OPTIM:
  LR: 1.0e-3
"""

OVERRIDES = [
    ["MODEL.Z_SPACE", "100", "OPTIM.LR", "1e-3", "MODEL.USE_CBS", "no"],
    ["MODEL.EMBEDDING_SIZE", 300, "OPTIM.MOMENTUM", 1, "DATA.SENTICAP_SENTIMENT", "neg",
     "MODEL.SIMPLE_VAE", "True", "DATA.DO_LOAD_COCO", "0"],
    ["DET.ANCHOR_SCALES", "[2, 4]", "DET.TRAIN.SCALES", "[800]", "MODEL.PRIOR_STD", "0",
     "DATA.SENTIGLOVE", "x.pkl", "DATA.MAX_BOXES", "036"],
    ["MODEL.LATENT_EMBEDDING", "007", "DATA.VOCABULARY", "'quoted'",
     "OPTIM.CLIP_GRADIENTS", ".inf", "PARALLEL.SHARD_PARAMS", "yes"],
]

SCALARS = ["1e-3", "1.0e-3", "1.0e3", "1.e-3", ".5", "-.inf", ".NaN", "yes", "No", "on",
           "OFF", "y", "n", "~", "null", "NULL", "", "007", "08", "0x1A", "0b101", "0o7",
           "1_000", "190:20:30", "1:30.5", "+12", "-0", "0", "3.", "0.", "-1.5e+3",
           "12e-3", "True", "abc", "data/vocabulary", "a b"]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalar_resolver_equals_yaml(scalar):
    assert _same(t_config.resolve_scalar(scalar), yaml.safe_load(scalar))
    assert _same(t_config.safe_load(scalar), yaml.safe_load(scalar))


@pytest.mark.parametrize("text", ["'007'", '"a\\tb\\x41"', "'it''s'", "[1, 'x', 2.5e-3, yes]",
                                  "[]", "- a\n- 1\n", "---\na: 1\n", CLI_SMOKE_YAML,
                                  SUBSET_YAML, "a:\nb: [x]\nc:\n  d:\n    e: 1\n"])
def test_safe_load_equals_yaml(text):
    assert t_config.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x",
                                  "a: {b: 1}", "a: b\n  c", "a: 'x\n  y'", "a: 2001-12-14",
                                  "a: [[1]]", "a:\n  - b: 1", "a: 1\n---\nb: 2", "a: b: c"])
def test_safe_load_refuses_outside_subset(text):
    with pytest.raises(ValueError):
        t_config.safe_load(text)


@pytest.mark.parametrize("case", ["published", "cli_smoke", "subset"] +
                         [f"overrides{i}" for i in range(len(OVERRIDES))])
def test_config_equals_jax(tmp_path, case):
    path, overrides = PUBLISHED, []
    if case == "cli_smoke":
        (tmp_path / "c.yml").write_text(CLI_SMOKE_YAML)
        path = str(tmp_path / "c.yml")
    elif case == "subset":
        (tmp_path / "c.yml").write_text(SUBSET_YAML)
        path = str(tmp_path / "c.yml")
    elif case.startswith("overrides"):
        overrides = OVERRIDES[int(case[-1])]
    want = j_config.Config(path, list(overrides)).to_dict()
    got = t_config.Config(path, list(overrides)).to_dict()
    assert got == want
    flat_w, flat_g = yaml.safe_dump(want), yaml.safe_dump(got)
    assert flat_g == flat_w                         # same types, not only equal values


def test_dump_loads_back_equal(tmp_path):
    c = t_config.Config(PUBLISHED, ["OPTIM.LR", "1e-5", "OPTIM.CLIP_GRADIENTS", "-.inf",
                                    "DATA.VOCABULARY", "it's: #here"])
    c.dump(str(tmp_path / "d.yml"))
    text = (tmp_path / "d.yml").read_text()
    assert t_config.safe_load(text) == c.to_dict()
    assert yaml.safe_load(text) == c.to_dict()
    assert t_config.Config(str(tmp_path / "d.yml")).to_dict() == c.to_dict()
    assert str(c) == text


def test_config_errors_equal_jax(tmp_path):
    for mod in (j_config, t_config):
        with pytest.raises(KeyError):
            mod.Config(PUBLISHED, ["MODEL.NOT_A_KEY", "1"])
        (tmp_path / "bad.yml").write_text("MODEL:\n  NOT_A_KEY: 1\n")
        with pytest.raises(KeyError):
            mod.Config(str(tmp_path / "bad.yml"))
        c = mod.Config(PUBLISHED)
        with pytest.raises(AttributeError):
            c.MODEL.Z_SPACE = 3
        with pytest.raises(AttributeError):
            c.MODEL["Z_SPACE"] = 3
        with pytest.raises(AssertionError, match="EMBEDDING_SIZE"):
            mod.Config(PUBLISHED, ["MODEL.EMBEDDING_SIZE", "1000"])
        with pytest.raises(AssertionError):
            mod.Config(PUBLISHED, ["MODEL.MIN_CONSTRAINTS_TO_SATISFY", "4"])
        with pytest.raises(TypeError):
            mod.Config(PUBLISHED).MODEL.merge_from_dict({"Z_SPACE": {"a": 1}})
