"""Dataset name registry: ``MVRD_trainval``, ``MVidVRD_test``, ... -> dataset
(the port's own copy of ``i2vsgg_tpu/data/factory.py``).

Rebuild of ``lib/datasets/factory.py:13-90``. The four I2VSGG datasets are
first-class; classic pascal_voc/coco names raise a clear error instead of
importing stock loaders we do not ship (they are unused in the I2VSGG flow,
SURVEY.md §2 "Datasets: stock").
"""

from __future__ import annotations

from i2vsgg_tpu_torch.data.dataset_config import DEFAULT_PATHS, DatasetPaths
from i2vsgg_tpu_torch.data.voc import (VOCDetectionDataset, VRD_CLASSES,
                                       VIDOR_CLASSES)

# dataset -> (classes, image extension); extensions per the reference
# (MVRD.py:53 .jpg; MVidVRD.py:53 .png; MVG/MVidOR .png)
_SPECS = {
    "MVRD": (VRD_CLASSES, ".jpg"),
    "MVidVRD": (VRD_CLASSES, ".png"),
    "MVG": (VIDOR_CLASSES, ".png"),
    "MVidOR": (VIDOR_CLASSES, ".png"),
}

_SPLITS = ("train", "val", "trainval", "test")


def get_imdb(name: str, paths: DatasetPaths = DEFAULT_PATHS
             ) -> VOCDetectionDataset:
    for ds, (classes, ext) in _SPECS.items():
        for split in _SPLITS:
            if name == f"{ds}_{split}":
                return VOCDetectionDataset(
                    ds, split, paths.resolved(ds), classes, ext)
    raise KeyError(
        f"Unknown dataset {name!r}. Known: "
        + ", ".join(f"{d}_{{{'|'.join(_SPLITS)}}}" for d in _SPECS))


def list_imdbs():
    return [f"{d}_{s}" for d in _SPECS for s in _SPLITS]
