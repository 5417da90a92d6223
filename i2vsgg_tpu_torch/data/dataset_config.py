"""Dataset root paths — the port's own copy of
``i2vsgg_tpu/data/dataset_config.py``.

Replaces ``lib/datasets/config_dataset.py`` (which, per SURVEY.md §8.5, never
defined the MVG/MVidOR roots it references). Roots resolve from the
``I2VSGG_DATA_ROOT`` environment variable (default ``./data``) so nothing is
hardcoded (the reference hardcodes absolute author paths, defect §8.4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def data_root() -> str:
    return os.environ.get("I2VSGG_DATA_ROOT", "data")


@dataclass(frozen=True)
class DatasetPaths:
    """Per-dataset devkit roots, mirroring ``cfg_d`` keys."""
    MVRD: str = ""
    MVidVRD: str = ""
    MVG: str = ""
    MVidOR: str = ""

    def resolved(self, name: str) -> str:
        explicit = getattr(self, name, "")
        if explicit:
            return explicit
        return os.path.join(data_root(), name)


DEFAULT_PATHS = DatasetPaths()
