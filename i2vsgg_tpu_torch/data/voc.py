"""VOC-XML-format detection datasets (MVRD / MVidVRD / MVG / MVidOR) — the
port's own copy of ``i2vsgg_tpu/data/voc.py``. The ``gt_roidb`` cache holds
numpy arrays only, so either package reads the other's.

One generic class replaces the four near-identical reference dataset classes
(``lib/datasets/{MVRD,MVidVRD,MVG,MVidOR}.py``) and the ``imdb`` base
(``lib/datasets/imdb.py:22-268``). Behavior preserved:

* VOC layout: ``Annotations/*.xml``, ``JPEGImages/*<ext>``,
  ``ImageSets/Main/<split>.txt``.
* XML parsing converts to 0-based pixel coords (-1), silently skips objects
  whose class name is not in the class list, records the ``difficult`` flag
  (``MVRD.py:203-260``).
* ``gt_roidb`` is pickle-cached under ``<cache_dir>/<name>_gt_roidb.pkl``
  (``MVRD.py:116-135``), written atomically (the ranks of a process group
  may write it at once).
* horizontal-flip augmentation duplicates the index list with flipped boxes
  (``imdb.py:114-132``).
* ``evaluate_detections`` writes VOC-style per-class result files and runs
  ``voc_eval`` per class (``MVRD.py:300-378``); the MVidOR-style ``setting``
  argument is accepted everywhere (reference defect §8.7: only MVidOR took
  it) and used only to suffix the output directory.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from i2vsgg_tpu_torch.eval.voc_eval import voc_eval


class VOCDetectionDataset:
    def __init__(self, name: str, image_set: str, devkit_path: str,
                 classes: Sequence[str], image_ext: str = ".jpg",
                 use_difficult: bool = False):
        self.name = f"{name}_{image_set}"
        self._image_set = image_set
        self._devkit_path = devkit_path
        self._data_path = devkit_path
        self.classes = tuple(classes)
        self.num_classes = len(self.classes)
        self._class_to_ind = {c: i for i, c in enumerate(self.classes)}
        self._image_ext = image_ext
        self._use_difficult = use_difficult
        self._image_index = self._load_image_set_index()
        self._roidb: Optional[List[Dict]] = None

    # ---------- indexing ------------------------------------------------

    def _load_image_set_index(self) -> List[str]:
        path = os.path.join(self._data_path, "ImageSets", "Main",
                            self._image_set + ".txt")
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    @property
    def image_index(self) -> List[str]:
        return self._image_index

    @property
    def num_images(self) -> int:
        return len(self._image_index)

    def image_path_at(self, i: int) -> str:
        return self.image_path_from_index(self._image_index[i])

    def image_path_from_index(self, index: str) -> str:
        return os.path.join(self._data_path, "JPEGImages",
                            index + self._image_ext)

    # ---------- annotations --------------------------------------------

    @property
    def cache_path(self) -> str:
        p = os.path.join(self._devkit_path, "cache")
        os.makedirs(p, exist_ok=True)
        return p

    def _parse_xml(self, index: str) -> Dict:
        fn = os.path.join(self._data_path, "Annotations", index + ".xml")
        tree = ET.parse(fn)
        objs = tree.findall("object")
        boxes, classes, diffs = [], [], []
        for obj in objs:
            cls_name = obj.find("name").text.lower().strip()
            if cls_name not in self._class_to_ind:
                continue
            bb = obj.find("bndbox")
            x1 = float(bb.find("xmin").text) - 1
            y1 = float(bb.find("ymin").text) - 1
            x2 = float(bb.find("xmax").text) - 1
            y2 = float(bb.find("ymax").text) - 1
            d = obj.find("difficult")
            diffs.append(0 if d is None else int(d.text))
            boxes.append([x1, y1, x2, y2])
            classes.append(self._class_to_ind[cls_name])
        n = len(boxes)
        boxes_a = np.asarray(boxes, np.float32).reshape(n, 4)
        classes_a = np.asarray(classes, np.int32)
        overlaps = np.zeros((n, self.num_classes), np.float32)
        overlaps[np.arange(n), classes_a] = 1.0
        return {
            "boxes": boxes_a,
            "gt_classes": classes_a,
            "gt_ishard": np.asarray(diffs, np.int32),
            "gt_overlaps": overlaps,
            "flipped": False,
            "seg_areas": ((boxes_a[:, 2] - boxes_a[:, 0] + 1)
                          * (boxes_a[:, 3] - boxes_a[:, 1] + 1)),
        }

    def gt_roidb(self) -> List[Dict]:
        if self._roidb is not None:
            return self._roidb
        cache = os.path.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                self._roidb = pickle.load(f)
            return self._roidb
        roidb = [self._parse_xml(idx) for idx in self._image_index]
        # written aside, then renamed over: the ranks of a process group
        # parse and write it at once, and none may read a partial file
        part = f"{cache}.{os.getpid()}.part"
        with open(part, "wb") as f:
            pickle.dump(roidb, f, pickle.HIGHEST_PROTOCOL)
        os.replace(part, cache)
        self._roidb = roidb
        return roidb

    @property
    def roidb(self) -> List[Dict]:
        return self.gt_roidb()

    def append_flipped_images(self) -> None:
        """Horizontal-flip augmentation. [imdb.py:114-132]"""
        roidb = self.gt_roidb()
        num = len(self._image_index)
        widths = [r.get("width") for r in roidb]
        assert all(w is not None for w in widths), \
            "call prepare_roidb before append_flipped_images"
        flipped = []
        for i in range(num):
            entry = dict(roidb[i])
            boxes = entry["boxes"].copy()
            oldx1 = boxes[:, 0].copy()
            oldx2 = boxes[:, 2].copy()
            boxes[:, 0] = widths[i] - oldx2 - 1
            boxes[:, 2] = widths[i] - oldx1 - 1
            entry["boxes"] = boxes
            entry["flipped"] = True
            flipped.append(entry)
        self._roidb = roidb + flipped
        self._image_index = self._image_index * 2

    # ---------- evaluation ---------------------------------------------

    def _results_file(self, out_dir: str, cls: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        return os.path.join(out_dir, f"det_{self._image_set}_{cls}.txt")

    def _write_results(self, all_boxes, out_dir: str) -> None:
        """[MVRD.py:266-287 _write_voc_results_file]"""
        for ci, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            with open(self._results_file(out_dir, cls), "w") as f:
                for ii, index in enumerate(self._image_index):
                    dets = all_boxes[ci][ii]
                    if dets is None or len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        # VOC expects 1-based pixel coords
                        f.write(f"{index} {dets[k, -1]:.3f} "
                                f"{dets[k, 0] + 1:.1f} {dets[k, 1] + 1:.1f} "
                                f"{dets[k, 2] + 1:.1f} {dets[k, 3] + 1:.1f}\n")

    def evaluate_detections(self, all_boxes, output_dir: str,
                            setting: str = "") -> Dict[str, float]:
        """Per-class VOC AP at IoU 0.5. [MVRD.py:289-378]

        Returns {class: ap, "mAP": mean}.
        """
        if setting:
            output_dir = os.path.join(output_dir, setting)
        self._write_results(all_boxes, output_dir)
        annopath = os.path.join(self._data_path, "Annotations", "{}.xml")
        aps = {}
        for ci, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            rec, prec, ap = voc_eval(
                self._results_file(output_dir, cls), annopath,
                self._image_index, cls, self.cache_path, ovthresh=0.5,
                use_07_metric=False)
            aps[cls] = ap
        aps["mAP"] = float(np.mean([v for k, v in aps.items() if k != "mAP"]))
        return aps


# class lists verified against the reference datasets
# (MVRD.py:50-51 == MVidVRD.py:50-52; MVG.py:50-92 == MVidOR.py:50-91)
VRD_CLASSES = (
    "__background__", "airplane", "ball", "bear", "bicycle", "bus", "car",
    "cat", "dog", "elephant", "horse", "motorcycle", "person", "skateboard",
    "sofa", "train")

VIDOR_CLASSES = (
    "__background__", "adult", "aircraft", "backpack", "ball", "bat", "bear",
    "bench", "bicycle", "bird", "bottle", "bread", "bus", "cake", "car",
    "cat", "cattle", "cellphone", "chair", "child", "dish", "dog", "elephant",
    "frisbee", "fruits", "handbag", "horse", "laptop", "motorcycle", "racket",
    "screen", "sheep", "sink", "skateboard", "ski", "sofa", "suitcase",
    "surfboard", "table", "toilet", "train", "watercraft")
