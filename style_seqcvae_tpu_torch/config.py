"""Unified configuration (copy of ``style_seqcvae_tpu/config.py:1-347``),
without PyYAML.

``ConfigNode``, ``_coerce``, ``captioner_defaults``, ``detector_defaults``
and ``Config`` (with ``_validate``) are the JAX package's. The YAML files
are read by :func:`safe_load`, a reader for the subset of YAML that the
repository's configs use, which resolves scalars as ``yaml.safe_load``
does (YAML 1.1); :func:`safe_dump` writes the same subset.

The subset: block mappings by indentation, comments, plain and quoted
(single or double) scalars, block (``- x``) and flow (``[a, b]``)
sequences of scalars, and an optional leading ``---``. Anything else
raises ``ValueError``: anchors, aliases, tags, block or multi-line
scalars, flow mappings, nested sequences, timestamps.
"""

from __future__ import annotations

import copy
import math
import re
from typing import Any, Dict, List, Optional, Tuple

# ------------------------------------------------------------ YAML subset

# yaml.resolver.Resolver's implicit resolvers (YAML 1.1)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_KEY = re.compile(r"^([A-Za-z0-9_][^:#'\"]*?)\s*:(?:\s+(.*))?$")
_DOUBLE_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
                   "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
                   "\\": "\\"}


def _sexagesimal(value: str) -> float:
    total = 0.0
    for part in value.split(":"):
        total = total * 60 + float(part)
    return total


def resolve_scalar(text: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` resolves it: null, bool, int
    (binary, octal, hex, base 60), float, else the string itself.
    Timestamps, which it would turn into dates, raise."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * int(_sexagesimal(v))
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamp scalar {text!r} is outside the YAML subset read here")
    return text


def _strip_comment(line: str) -> str:
    """The line without its comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    quote, i = None, 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1                                  # an escaped character
            elif ch == quote and quote == "'" and line[i + 1:i + 2] == "'":
                i += 1                                  # '' inside single quotes
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _quoted(text: str) -> Tuple[str, str]:
    """(the quoted scalar at the start of ``text``, what follows it)."""
    q, out, i = text[0], [], 1
    while i < len(text):
        ch = text[i]
        if ch == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc in ("x", "u"):
                n = 2 if esc == "x" else 4
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if esc not in _DOUBLE_ESCAPES:
                raise ValueError(f"escape \\{esc} in {text!r} is outside the YAML subset")
            out.append(_DOUBLE_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    raise ValueError(f"quoted scalar {text!r} does not end on its line (multi-line "
                     "scalars are outside the YAML subset)")


def _scalar(text: str) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text)
        if rest.strip():
            raise ValueError(f"text after a quoted scalar: {text!r}")
        return value
    indicator = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
                 ">": "a block scalar", "{": "a flow mapping", "[": "a nested sequence"}
    if text[:1] in indicator:
        raise ValueError(f"{indicator[text[0]]} ({text!r}) is outside the YAML subset")
    if text[:1] in ("}", "]", "@", "`", "%") or ": " in text or text.endswith(":"):
        raise ValueError(f"{text!r} is outside the YAML subset (a reserved indicator or "
                         "a nested mapping)")
    return resolve_scalar(text)


def _value(text: str) -> Any:
    """A value on its key's line: a flow sequence of scalars or a scalar."""
    text = text.strip()
    if not text.startswith("["):
        return _scalar(text)
    if not text.endswith("]"):
        raise ValueError(f"flow sequence {text!r} does not end on its line")
    items, cur, quote = [], "", None
    for ch in text[1:-1]:
        if quote:
            cur += ch
            quote = None if ch == quote else quote
        elif ch in "'\"" and not cur.strip():
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        elif ch in "[]{}":
            raise ValueError(f"a nested flow collection in {text!r} is outside the "
                             "YAML subset")
        else:
            cur += ch
    items.append(cur)
    if not items[-1].strip():
        items.pop()                                 # "[]" or a trailing comma
    if any(not it.strip() for it in items):
        raise ValueError(f"an empty entry in the flow sequence {text!r}")
    return [_scalar(it) for it in items]


def _lines(text: str) -> List[Tuple[int, str]]:
    """(indentation, content) of each line that holds more than a comment."""
    out = []
    for n, raw in enumerate(text.splitlines(), start=1):
        body = _strip_comment(raw).rstrip()
        stripped = body.lstrip(" ")
        if not stripped:
            continue
        if stripped[0] == "\t":
            raise ValueError(f"line {n}: a tab in the indentation")
        if not out and stripped == "---":
            continue
        if stripped in ("---", "...") or stripped.startswith("%"):
            raise ValueError(f"line {n}: document markers and directives are outside "
                             "the YAML subset")
        out.append((len(body) - len(stripped), stripped))
    return out


def _is_entry(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    """The block node whose lines start at ``lines[i]`` at ``indent``;
    returns it and the index of the line after it."""
    text = lines[i][1]
    if _is_entry(text):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_entry(lines[i][1]):
            item = lines[i][1][1:].strip()
            if not item or _is_entry(item) or _KEY.match(item):
                raise ValueError(f"block sequence entry {lines[i][1]!r}: only scalars "
                                 "are read in sequences")
            out.append(_value(item))
            i += 1
        return out, i
    if not _KEY.match(text):
        if i + 1 < len(lines) and lines[i + 1][0] >= indent:
            raise ValueError(f"{text!r} continues over lines, which is outside the "
                             "YAML subset")
        return _value(text), i + 1
    mapping: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        m = _KEY.match(lines[i][1])
        if not m:
            raise ValueError(f"expected 'key: value' at {lines[i][1]!r}")
        key, rest = m.group(1), m.group(2)
        i += 1
        if rest:
            mapping[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent
                                 or (lines[i][0] == indent and _is_entry(lines[i][1]))):
            mapping[key], i = _block(lines, i, lines[i][0])
        else:
            mapping[key] = None
        if i < len(lines) and lines[i][0] > indent:
            raise ValueError(f"{lines[i][1]!r} continues a scalar over lines, which is "
                             "outside the YAML subset")
    return mapping, i


def safe_load(text: str) -> Any:
    """``yaml.safe_load`` for the YAML subset of the module docstring."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return value


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:         # 1e-05 would load as a string
            text = text.replace("e", ".0e")
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"a {type(v).__name__} value ({v!r}) is outside the YAML subset")


def safe_dump(data: Dict[str, Any], indent: int = 0) -> str:
    """A nested dict of scalars and lists of scalars as YAML that
    :func:`safe_load` reads back equal (keys sorted, as ``yaml.safe_dump``
    sorts them)."""
    out = []
    for key in sorted(data):
        v, pad = data[key], " " * indent
        if isinstance(v, dict):
            if not v:
                raise ValueError(f"the empty mapping under {key!r} is outside the YAML subset")
            out.append(f"{pad}{key}:\n" + safe_dump(v, indent + 2))
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{key}: [" + ", ".join(_dump_scalar(x) for x in v) + "]\n")
        else:
            out.append(f"{pad}{key}: {_dump_scalar(v)}\n")
    return "".join(out)


# ----------------------------------------------------------- configuration

class ConfigNode(dict):
    """A dict with attribute access, nesting and freeze support (yacs-like)."""

    __frozen_key = "__frozen__"

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {name}")
        self[name] = ConfigNode(value) if isinstance(value, dict) else value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {name}")
        super().__setitem__(name, value)

    def freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()

    def clone(self) -> "ConfigNode":
        return ConfigNode(self.to_dict())

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v))
            for k, v in self.items()
        }

    def merge_from_dict(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if k not in self:
                raise KeyError(f"Unknown config key: {k}")
            if isinstance(v, dict):
                if not isinstance(self[k], ConfigNode):
                    raise TypeError(f"Cannot merge dict into non-dict key {k}")
                self[k].merge_from_dict(v)
            else:
                self[k] = _coerce(v, self[k])

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = safe_load(f.read()) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, kv_list: List[Any]) -> None:
        assert len(kv_list) % 2 == 0, "Override list must have even length"
        for key, value in zip(kv_list[0::2], kv_list[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"Unknown config key: {key}")
            node[parts[-1]] = _coerce(value, node[parts[-1]])

    def dump(self, stream=None) -> str:
        text = safe_dump(self.to_dict())
        if stream is not None:
            stream.write(text)
        return text


def _coerce(value: Any, old: Any) -> Any:
    """Coerce a YAML/CLI value toward the type of the existing default."""
    if isinstance(value, str) and not isinstance(old, str):
        s = value.strip()
        if isinstance(old, bool):
            if s.lower() in ("true", "1", "yes"):
                return True
            if s.lower() in ("false", "0", "no"):
                return False
        try:
            return type(old)(safe_load(s)) if old is not None else safe_load(s)
        except Exception:
            return safe_load(s)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    return value


def captioner_defaults() -> ConfigNode:
    """Default tree for the captioning stack.

    Key set and defaults mirror updown-baseline/updown/config.py:8-104 (plus
    var_updown/configs/config.yaml keys); behavior-defining values such as
    KLD_WEIGHT=750, PRIOR_STD=1.0, CBS.MAX_GIVEN_CONSTRAINTS=3 are preserved.
    """
    _C = ConfigNode()
    _C.LOG_TO_FILE = True
    _C.CHECKPOINT_EVERY_N_EPOCHS = 10
    _C.PRINT_EVERY_N_BATCHES = 100
    _C.RANDOM_SEED = 0

    _C.DATA = ConfigNode()
    _C.DATA.VOCABULARY = "data/vocabulary"
    _C.DATA.TRAIN_FEATURES = "data/coco_train2017_vg_detector_features_adaptive.h5"
    _C.DATA.INFER_FEATURES = "data/nocaps_val_vg_detector_features_adaptive.h5"
    _C.DATA.TRAIN_CAPTIONS = "data/coco/captions_train2017.json"
    _C.DATA.INFER_CAPTIONS = "data/nocaps/nocaps_val_image_info.json"
    _C.DATA.SENTICAP_CAPTIONS = ""
    _C.DATA.DO_LOAD_COCO = True
    _C.DATA.DO_LOAD_SENTICAP = False
    _C.DATA.SENTICAP_SENTIMENT = ""
    _C.DATA.EXPERT_CAPTIONS = ""
    _C.DATA.COCO_ATTRIBS_OBJS = ""
    _C.DATA.REMOVE_SAMPLES_WITHOUT_ATTRIBS = False
    _C.DATA.USE_OBJ_ATT_PREDS = False
    _C.DATA.ATT_PRED_THRESH = 0.3
    _C.DATA.MAX_CAPTION_LENGTH = 20
    # TPU-native additions: fixed shapes are mandatory under XLA.
    _C.DATA.MAX_BOXES = 100
    _C.DATA.GLOVE_CACHE = ""           # path to GloVe cache dir ("" → hashed random fallback)
    _C.DATA.SENTIGLOVE = ""            # path to sentiglove10.pkl
    _C.DATA.SWN_SCORES = ""            # path to wordform_swd_scores.json

    _C.DATA.CBS = ConfigNode()
    _C.DATA.CBS.INFER_BOXES = "data/nocaps_val_oi_detector_boxes.json"
    _C.DATA.CBS.CLASS_HIERARCHY = "data/cbs/class_hierarchy.json"
    _C.DATA.CBS.WORDFORMS = ""
    _C.DATA.CBS.WORDFORMS_ATTRIBS = ""
    _C.DATA.CBS.NMS_THRESHOLD = 0.85
    _C.DATA.CBS.MAX_GIVEN_OBJECTS = 2
    _C.DATA.CBS.MAX_GIVEN_CONSTRAINTS = 3
    _C.DATA.CBS.MAX_WORDS_PER_CONSTRAINT = 3

    _C.MODEL = ConfigNode()
    _C.MODEL.IMAGE_FEATURE_SIZE = 2048
    _C.MODEL.EMBEDDING_SIZE = 1000
    _C.MODEL.HIDDEN_SIZE = 1200
    _C.MODEL.ATTENTION_PROJECTION_SIZE = 768
    _C.MODEL.BEAM_SIZE = 5
    _C.MODEL.USE_CBS = False
    _C.MODEL.CBS_SIMPLE = True
    _C.MODEL.MIN_CONSTRAINTS_TO_SATISFY = 2
    _C.MODEL.PRIOR_MODE = "AG"
    _C.MODEL.DO_USE_CLUSTER_VECTOR = True
    _C.MODEL.FC_LAYER_PER_ATTRIB = True
    _C.MODEL.NUM_LSTM_LAYERS = 1
    _C.MODEL.LSTM_DROPOUT = 0.1
    _C.MODEL.Z_SPACE = 150
    _C.MODEL.SENTIMENT_VAE = 0
    _C.MODEL.SENTI_PRIOR_MULTIP = 1.0
    _C.MODEL.LATENT_EMBEDDING_MULTIP = 1.0
    _C.MODEL.KLD_WEIGHT = 750
    _C.MODEL.N_Z_SAMPLES = 0
    _C.MODEL.STATE_MACHINE_PER_Z_SAMPLE = False
    _C.MODEL.LATENT_EMBEDDING = "glove"
    _C.MODEL.PRIOR_STD = 1.0
    _C.MODEL.SIMPLE_VAE = True
    _C.MODEL.DO_USE_KLD_ANNEALING = False
    _C.MODEL.KLD_DECREASING = False
    _C.MODEL.KLD_INITIAL_WEIGHT = 2.0
    _C.MODEL.KLD_ANNEALING_PER_EPOCH = 0.25
    _C.MODEL.KLD_N_EPOCHS_BEFORE_RESET = 4
    # TPU-native additions.
    _C.MODEL.DTYPE = "float32"         # compute dtype for the decoder ("bfloat16" on TPU)

    _C.OPTIM = ConfigNode()
    _C.OPTIM.BATCH_SIZE = 150
    _C.OPTIM.NUM_ITERATIONS = 70000
    _C.OPTIM.LR = 0.015
    _C.OPTIM.MOMENTUM = 0.9
    _C.OPTIM.LR_DECAY_EVERY_N = 7
    _C.OPTIM.LR_DECAY = 0.5
    _C.OPTIM.LR_DECAY_START_EPOCH = 10
    _C.OPTIM.WEIGHT_DECAY = 0.001
    _C.OPTIM.CLIP_GRADIENTS = 12.5
    _C.OPTIM.EPOCH_START_DECODER_TRAINING = 40000
    _C.OPTIM.BEFORE_UPDATE_DECODER_EVERY = 30

    # Parallelism (TPU-native, no reference equivalent beyond DataParallel).
    _C.PARALLEL = ConfigNode()
    _C.PARALLEL.DATA_AXIS = "data"
    _C.PARALLEL.MODEL_AXIS = "model"
    _C.PARALLEL.NUM_DATA = -1          # -1 → all devices on the data axis
    _C.PARALLEL.NUM_MODEL = 1
    _C.PARALLEL.SHARD_PARAMS = False   # FSDP-style parameter sharding over data axis
    return _C


def detector_defaults() -> ConfigNode:
    """Default tree for the detection stack.

    Mirrors the behavior-relevant keys of frcnn/lib/model/utils/config.py
    (TRAIN.* at :19-119, TEST.*, POOLING_MODE :283, ANCHOR_SCALES :292,
    RNG_SEED :260) with the YAML preset values of frcnn/cfgs/res101.yml
    noted where they override.
    """
    D = ConfigNode()
    D.RNG_SEED = 3
    D.POOLING_MODE = "align"          # cfgs/res101.yml:17 overrides default "crop"
    D.POOLING_SIZE = 7
    D.CROP_RESIZE_WITH_MAX_POOL = False
    D.ANCHOR_SCALES = [4, 8, 16, 32]  # res101.yml uses [4,8,16,32] for COCO
    D.ANCHOR_RATIOS = [0.5, 1, 2]
    D.FEAT_STRIDE = 16
    D.MAX_NUM_GT_BOXES = 20
    D.CLASS_AGNOSTIC = False
    D.ATT_LOSS_WEIGHT = 0.5           # frcnn/trainval_net.py:345-346

    D.TRAIN = ConfigNode()
    D.TRAIN.LEARNING_RATE = 0.001
    D.TRAIN.MOMENTUM = 0.9
    D.TRAIN.WEIGHT_DECAY = 0.0001
    D.TRAIN.GAMMA = 0.1
    D.TRAIN.BATCH_SIZE = 128          # RoIs per image
    D.TRAIN.FG_FRACTION = 0.25
    D.TRAIN.FG_THRESH = 0.5
    D.TRAIN.BG_THRESH_HI = 0.5
    D.TRAIN.BG_THRESH_LO = 0.0
    D.TRAIN.SCALES = [600]
    D.TRAIN.MAX_SIZE = 1000
    D.TRAIN.IMS_PER_BATCH = 1
    D.TRAIN.USE_FLIPPED = True
    D.TRAIN.BBOX_REG = True
    D.TRAIN.BBOX_THRESH = 0.5
    D.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED = True
    D.TRAIN.BBOX_NORMALIZE_MEANS = [0.0, 0.0, 0.0, 0.0]
    D.TRAIN.BBOX_NORMALIZE_STDS = [0.1, 0.1, 0.2, 0.2]
    D.TRAIN.BBOX_INSIDE_WEIGHTS = [1.0, 1.0, 1.0, 1.0]
    D.TRAIN.RPN_POSITIVE_OVERLAP = 0.7
    D.TRAIN.RPN_NEGATIVE_OVERLAP = 0.3
    D.TRAIN.RPN_CLOBBER_POSITIVES = False
    D.TRAIN.RPN_FG_FRACTION = 0.5
    D.TRAIN.RPN_BATCHSIZE = 256
    D.TRAIN.RPN_NMS_THRESH = 0.7
    D.TRAIN.RPN_PRE_NMS_TOP_N = 12000
    D.TRAIN.RPN_POST_NMS_TOP_N = 2000
    D.TRAIN.RPN_MIN_SIZE = 8
    D.TRAIN.RPN_BBOX_INSIDE_WEIGHTS = [1.0, 1.0, 1.0, 1.0]
    D.TRAIN.RPN_POSITIVE_WEIGHT = -1.0
    D.TRAIN.TRUNCATED = False
    D.TRAIN.DOUBLE_BIAS = False       # res101.yml
    D.TRAIN.BIAS_DECAY = False
    D.TRAIN.USE_GT = False
    D.TRAIN.DISPLAY = 20
    D.TRAIN.CLIP_GRADIENTS = 0.0   # 0 = off (reference clips only VGG)

    D.TEST = ConfigNode()
    D.TEST.SCALES = [600]
    D.TEST.MAX_SIZE = 1000
    D.TEST.NMS = 0.3
    D.TEST.RPN_NMS_THRESH = 0.7
    D.TEST.RPN_PRE_NMS_TOP_N = 6000
    D.TEST.RPN_POST_NMS_TOP_N = 300
    D.TEST.RPN_MIN_SIZE = 16
    D.TEST.BBOX_REG = True
    D.TEST.MAX_PER_IMAGE = 100        # frcnn/test_net.py:232
    D.TEST.FEAT_EXTRACT_THRESH = 0.5  # frcnn/test_net.py:379-414

    D.RESNET = ConfigNode()
    D.RESNET.FIXED_BLOCKS = 1
    D.RESNET.MAX_POOL = False

    D.PIXEL_MEANS = [102.9801, 115.9465, 122.7717]  # BGR means
    D.SENTICAP = False
    D.COCOATTS = False
    return D


class Config:
    """Frozen merged configuration (captioner tree + ``DET`` detector tree).

    Usage parity with updown-baseline/updown/config.py:
    ``Config(yaml_path, ["MODEL.Z_SPACE", 100])``.
    """

    def __init__(self, config_file: Optional[str] = None, config_override: Optional[List[Any]] = None):
        _C = captioner_defaults()
        _C.DET = detector_defaults()
        self._C = _C
        if config_file is not None:
            self._C.merge_from_file(config_file)
        if config_override:
            self._C.merge_from_list(list(config_override))
        self._validate()
        self._C.freeze()

    def _validate(self) -> None:
        if self._C.MODEL.USE_CBS:
            assert self._C.MODEL.EMBEDDING_SIZE in (300, 600), (
                "Word embeddings must be initialized with fixed GloVe embeddings "
                "(300/600 dim) for CBS decoding; found "
                f"MODEL.EMBEDDING_SIZE={self._C.MODEL.EMBEDDING_SIZE}."
            )
        assert (
            self._C.MODEL.MIN_CONSTRAINTS_TO_SATISFY <= self._C.DATA.CBS.MAX_GIVEN_CONSTRAINTS
        ), "Satisfying more constraints than maximum specified is not possible."

    def dump(self, file_path: str) -> None:
        with open(file_path, "w") as f:
            self._C.dump(stream=f)

    def __getattr__(self, attr: str) -> Any:
        return getattr(self._C, attr)

    def __str__(self) -> str:
        return self._C.dump()

    def __repr__(self) -> str:
        return f"Config({self._C!r})"
