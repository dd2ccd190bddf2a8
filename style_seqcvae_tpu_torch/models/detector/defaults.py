"""The detector constants that the inference path reads.

Copied from the JAX package's ``config.py::detector_defaults`` (the ``DET``
tree), which imports PyYAML; each value names its line there.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

PIXEL_MEANS = (102.9801, 115.9465, 122.7717)     # BGR; config.py:301
POOLING_MODE = "align"                           # config.py:237
POOLING_SIZE = 7                                 # config.py:238
ANCHOR_SCALES = (4, 8, 16, 32)                   # config.py:240
ANCHOR_RATIOS = (0.5, 1.0, 2.0)                  # config.py:241
FEAT_STRIDE = 16                                 # config.py:242


class InferenceConfig(NamedTuple):
    """The settings of one extraction run (``DET.TEST.*`` and the box
    normalization of ``DET.TRAIN.*``), read by
    ``extract.extract_device_features``."""
    rpn_pre_nms_top_n: int = 6000                                  # config.py:290
    rpn_post_nms_top_n: int = 300                                  # config.py:291
    rpn_nms_thresh: float = 0.7                                    # config.py:289
    nms_thresh: float = 0.3                      # per-class NMS, config.py:288
    score_thresh: float = 0.05                   # device selection, bench.py:629
    max_per_image: int = 100                                       # config.py:294
    bbox_normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)  # config.py:264
    bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)   # config.py:265
