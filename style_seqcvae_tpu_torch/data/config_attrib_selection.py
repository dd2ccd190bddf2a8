"""COCO-Attributes whitelist (copy of
``style_seqcvae_tpu/data/config_attrib_selection.py:1-16`` and its
``static/attrib_selection.json``).

A 204-entry {attribute name -> bool} dict loaded into the module-level
``attrib_selection``. Its insertion order is kept: the readers align
``attrib_selection.values()`` with the sorted attribute ids.
"""

import json
import os

_path = os.path.join(os.path.dirname(__file__), "static", "attrib_selection.json")
with open(_path) as _f:
    attrib_selection = json.load(_f)
