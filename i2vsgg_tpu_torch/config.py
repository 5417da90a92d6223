"""Frozen configuration tree — the port's own copy of ``i2vsgg_tpu/config.py``.

The dataclasses and their defaults are the JAX package's, field for field
(the reference's ``lib/model/utils/config.py`` keys). Unlike the original this
copy does not use PyYAML: ``cfg_from_list`` parses each override value with
``ast.literal_eval`` and keeps the raw string where that fails, and
``cfg_from_file`` reads ``cfgs/*.yml`` with a small reader of the YAML subset
those files use (nested mappings by indent, scalars, inline lists, ``#``
comments), so the module imports with the standard library alone.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence, Tuple


def _freplace(obj, **kw):
    return dataclasses.replace(obj, **kw)


@dataclass(frozen=True)
class TrainConfig:
    # Reference defaults: lib/model/utils/config.py:40-160
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    TRUNCATED: bool = False
    # RoI minibatch sampling (proposal-target layer)
    BATCH_SIZE: int = 128            # rois per image
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.1
    USE_FLIPPED: bool = True
    BBOX_REG: bool = True
    BBOX_THRESH: float = 0.5
    BBOX_NORMALIZE_TARGETS: bool = True
    BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    BBOX_NORMALIZE_TARGETS_PRECOMPUTED: bool = True
    BBOX_NORMALIZE_MEANS: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    # RPN anchor-target assignment
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_CLOBBER_POSITIVES: bool = False
    RPN_FG_FRACTION: float = 0.5
    RPN_BATCHSIZE: int = 256
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_POST_NMS_TOP_N_TARGET: int = 128   # target-domain batches cap
    RPN_MIN_SIZE: int = 8
    RPN_BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    RPN_POSITIVE_WEIGHT: float = -1.0
    # Optimization
    LEARNING_RATE: float = 0.001
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0005
    GAMMA: float = 0.1
    DOUBLE_BIAS: bool = True
    BIAS_DECAY: bool = False
    # Static-shape padding (replaces the reference's MAX_NUM_GT_BOXES
    # roibatchLoader padding, lib/roi_data_layer/roibatchLoader.py:199-203)
    MAX_NUM_GT_BOXES: int = 30


@dataclass(frozen=True)
class TestConfig:
    # Reference defaults: lib/model/utils/config.py:165-210
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    NMS: float = 0.3
    BBOX_REG: bool = True
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 6000
    RPN_POST_NMS_TOP_N: int = 300
    RPN_MIN_SIZE: int = 16
    RPN_TOP_N: int = 5000
    MAX_DETECTIONS_PER_IMAGE: int = 100   # top-100 cap in test drivers
    # per-class NMS keep cap in the on-device decode (serve.py). 0 = tie to
    # MAX_DETECTIONS_PER_IMAGE (the reference keeps every survivor per
    # class, then applies only the image-level cap — a static per-class
    # bound >= the image cap is behaviorally identical). A smaller value is
    # a SERVING capacity cut; gate it with tools/capacity_ab.py rows.
    MAX_PER_CLASS: int = 0


@dataclass(frozen=True)
class ResNetConfig:
    FIXED_BLOCKS: int = 1
    MAX_POOL: bool = False


@dataclass(frozen=True)
class Config:
    """Top-level config. Mirrors the reference's global ``cfg``."""

    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    RESNET: ResNetConfig = field(default_factory=ResNetConfig)
    # Caffe-convention BGR pixel means (lib/model/utils/config.py:264)
    PIXEL_MEANS: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)
    RNG_SEED: int = 3
    POOLING_MODE: str = "align"
    POOLING_SIZE: int = 7
    ANCHOR_SCALES: Tuple[int, ...] = (8, 16, 32)
    ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
    FEAT_STRIDE: Tuple[int, ...] = (16,)
    CROP_RESIZE_WITH_MAX_POOL: bool = True
    EPS: float = 1e-14
    # compute and parameter dtypes (bf16 on the card, fp32 in the tests)
    COMPUTE_DTYPE: str = "bfloat16"   # backbone compute dtype
    PARAM_DTYPE: str = "float32"

    @property
    def num_anchors(self) -> int:
        return len(self.ANCHOR_SCALES) * len(self.ANCHOR_RATIOS)

    def replace(self, **kw) -> "Config":
        return _freplace(self, **kw)


# Reference config keys with no equivalent here (GPU/caffe/snapshot knobs,
# dead options); silently skipped when loading reference YAMLs so
# ``cfgs/*.yml`` written for the PyTorch tree load unchanged.
LEGACY_KEYS = frozenset({
    "HAS_RPN", "IMS_PER_BATCH", "PROPOSAL_METHOD", "DISPLAY",
    "SNAPSHOT_PREFIX", "SNAPSHOT_ITERS", "SNAPSHOT_KEPT", "EXP_DIR",
    "USE_GPU_NMS", "GPU_ID", "DATA_DIR", "ROOT_DIR", "MATLAB", "USE_FLIPPED",
    "ASPECT_GROUPING", "SUMMARY_INTERVAL", "TRIM_HEIGHT", "TRIM_WIDTH",
    "USE_ALL_GT", "PRETRAIN_PATH", "RESNET_PATH", "VGG_PATH", "DEDUP_BOXES",
    "PROPOSAL_LIMIT", "MODE", "SVM", "BBOX_VOTE", "AGNOSTIC",
})


def _merge_into(dc, src: Mapping[str, Any], strict: bool = True):
    """Recursively merge a dict into a frozen dataclass, returning a copy."""
    kw = {}
    names = {f.name: f for f in dataclasses.fields(dc)}
    for key, value in src.items():
        if key not in names:
            if not strict or key in LEGACY_KEYS:
                continue
            raise KeyError(f"Unknown config key: {key!r} for {type(dc).__name__}")
        cur = getattr(dc, key)
        if dataclasses.is_dataclass(cur) and isinstance(value, Mapping):
            kw[key] = _merge_into(cur, value)
        else:
            if isinstance(cur, tuple) and isinstance(value, (list, tuple)):
                value = tuple(value)
            elif cur is not None and not isinstance(value, type(cur)):
                # mirror the reference's type coercion (config.py:322-341)
                if isinstance(cur, float) and isinstance(value, int):
                    value = float(value)
                elif isinstance(cur, bool) and isinstance(value, int):
                    value = bool(value)
                else:
                    raise ValueError(
                        f"Type mismatch for {key}: {type(value)} vs {type(cur)}")
            kw[key] = value
    return _freplace(dc, **kw)


def _parse_value(raw: str):
    """Override value: a Python literal (``128``, ``0.7``, ``(8, 16)``,
    ``True``), else the raw string (``bfloat16``)."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def cfg_from_list(pairs: Sequence[str], base: Config | None = None) -> Config:
    """Apply ``["TEST.RPN_PRE_NMS_TOP_N", "512", ...]`` style overrides
    (reference ``cfg_from_list``, config.py:386-407)."""
    base = base or Config()
    if len(pairs) % 2:
        raise ValueError("set_cfgs must be key/value pairs")
    cfg = base
    for key, raw in zip(pairs[0::2], pairs[1::2]):
        parts = key.split(".")
        tree: dict = {}
        node = tree
        for p in parts[:-1]:
            node[p] = {}
            node = node[p]
        node[parts[-1]] = _parse_value(raw)
        cfg = _merge_into(cfg, tree)
    return cfg


# PyYAML's (YAML 1.1) resolvers for the plain scalars the subset admits
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                           "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:(?:\s+(.*))?$")


class YamlSubsetError(ValueError):
    """A line of a config file outside the YAML subset ``cfg_from_file``
    reads."""


def _yaml_scalar(text: str, where: str):
    """One plain or quoted scalar, resolved as PyYAML's ``safe_load``
    resolves it; a plain scalar that starts like a number but is none of
    the forms read here (octal, hex, sexagesimal) is refused."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise YamlSubsetError(f"{where}: escapes in double-quoted scalars "
                                  "are outside the subset")
        return body
    if text[:1] in "'\"[]{}&*!|>%@`" or text.startswith("- "):
        raise YamlSubsetError(f"{where}: {text!r} is outside the subset")
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if text.lower() in (".inf", "+.inf", "-.inf", ".nan"):
        return float(text.lower().replace(".", ""))
    if re.match(r"[-+]?\.?[0-9]", text):
        raise YamlSubsetError(f"{where}: numeric form {text!r} is outside "
                              "the subset")
    return text


def _yaml_value(text: str, where: str):
    """A value after ``key:``: an inline list ``[a, b]`` of scalars, or one
    scalar."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"{where}: unclosed inline list")
        body = text[1:-1].strip()
        if any(c in body for c in "[]{}"):
            raise YamlSubsetError(f"{where}: nested collections are outside "
                                  "the subset")
        return [_yaml_scalar(v.strip(), where)
                for v in body.split(",")] if body else []
    return _yaml_scalar(text, where)


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one that starts the line or follows
    whitespace, outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml_subset(path: str) -> dict:
    """Parse a config file in the YAML subset of ``cfgs/*.yml``: block
    mappings nested by space indentation, plain or quoted scalars, inline
    lists of scalars and ``#`` comments. Anything else (block sequences,
    flow mappings, anchors, tags, multi-line scalars, documents, tabs,
    duplicate keys) raises ``YamlSubsetError`` naming the file and line."""
    root: dict = {}
    stack = [(0, root)]                  # (indent, mapping) of open blocks
    pending = None                       # (indent, key, parent): "key:" alone
    with open(path) as f:
        lines = f.read().splitlines()
    for no, raw in enumerate(lines, 1):
        where = f"{path}:{no}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise YamlSubsetError(f"{where}: tab indentation")
        indent = len(line) - len(line.lstrip(" "))
        text = line.strip()
        if text in ("---", "...") or text.startswith("%"):
            raise YamlSubsetError(f"{where}: documents and directives are "
                                  "outside the subset")
        if pending is not None:
            p_indent, p_key, p_parent = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                p_parent[p_key] = child
                stack.append((indent, child))
            else:
                p_parent[p_key] = None   # "key:" with nothing under it
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise YamlSubsetError(f"{where}: indentation does not match an "
                                  "open mapping")
        m = _KEY.match(text)
        if not m:
            raise YamlSubsetError(f"{where}: {text!r} is not a 'key: value' "
                                  "line of the subset")
        key, value = m.group(1), (m.group(2) or "").strip()
        mapping = stack[-1][1]
        if key in mapping:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        if value:
            mapping[key] = _yaml_value(value, where)
        else:
            pending = (indent, key, mapping)
            mapping[key] = None
    return root


def cfg_from_file(path: str, base: Config | None = None) -> Config:
    """Load a config file (reference ``cfgs/*.yml`` format) over defaults,
    as the JAX ``cfg_from_file`` does with PyYAML: top-level keys that are
    not ``Config`` fields are dropped, and the rest merge through the same
    rules as ``cfg_from_list``."""
    base = base or Config()
    data = read_yaml_subset(path)
    data = {k: v for k, v in data.items()
            if k in {f.name for f in dataclasses.fields(Config)}}
    return _merge_into(base, data)
