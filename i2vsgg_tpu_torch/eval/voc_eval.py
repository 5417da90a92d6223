"""PASCAL-VOC detection AP evaluation — the port's own copy of
``i2vsgg_tpu/eval/voc_eval.py`` (``parse_rec``, ``voc_ap``, ``voc_eval``).

Host-side numpy reimplementation of ``lib/datasets/voc_eval.py:16-212``:
per-class AP at a given IoU threshold with greedy TP matching, difficult
objects excluded from both matching penalties and the recall denominator,
supporting both the VOC-07 11-point metric and the AUC metric. Annotation
parses are pickle-cached like the reference.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence

import numpy as np


def parse_rec(filename: str) -> List[Dict]:
    """Parse one VOC XML annotation file. [voc_eval.py:16-38]"""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        d = obj.find("difficult")
        objects.append({
            "name": obj.find("name").text.lower().strip(),
            "difficult": 0 if d is None else int(d.text),
            "bbox": [int(float(bbox.find("xmin").text)),
                     int(float(bbox.find("ymin").text)),
                     int(float(bbox.find("xmax").text)),
                     int(float(bbox.find("ymax").text))],
        })
    return objects


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a precision/recall curve. [voc_eval.py:41-67]"""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval(detpath: str, annopath: str, imagenames: Sequence[str],
             classname: str, cachedir: str, ovthresh: float = 0.5,
             use_07_metric: bool = False):
    """Per-class (recall, precision, AP). [voc_eval.py:70-212]

    Args:
      detpath: results file, lines ``imagename conf x1 y1 x2 y2`` (1-based).
      annopath: format string with ``{}`` for the image name.
      imagenames: evaluated image index list.
    """
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(cachedir, "annots.pkl")
    if os.path.exists(cachefile):
        with open(cachefile, "rb") as f:
            recs = pickle.load(f)
        if not all(n in recs for n in imagenames):
            recs = None
    else:
        recs = None
    if recs is None:
        recs = {n: parse_rec(annopath.format(n)) for n in imagenames}
        with open(cachefile, "wb") as f:
            pickle.dump(recs, f)

    class_recs = {}
    npos = 0
    for name in imagenames:
        objs = [o for o in recs[name] if o["name"] == classname]
        bbox = np.asarray([o["bbox"] for o in objs], np.float64).reshape(-1, 4)
        difficult = np.asarray([o["difficult"] for o in objs], bool)
        npos += int(np.sum(~difficult))
        class_recs[name] = {"bbox": bbox, "difficult": difficult,
                            "det": [False] * len(objs)}

    with open(detpath) as f:
        lines = [ln.strip().split(" ") for ln in f if ln.strip()]
    if not lines:
        return np.zeros(0), np.zeros(0), 0.0

    image_ids = [ln[0] for ln in lines]
    confidence = np.asarray([float(ln[1]) for ln in lines])
    bb_all = np.asarray([[float(v) for v in ln[2:6]] for ln in lines])

    order = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in order]
    bb_all = bb_all[order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        r = class_recs[image_ids[d]]
        bb = bb_all[d]
        ovmax, jmax = -np.inf, -1
        if r["bbox"].size:
            bbgt = r["bbox"]
            ixmin = np.maximum(bbgt[:, 0], bb[0])
            iymin = np.maximum(bbgt[:, 1], bb[1])
            ixmax = np.minimum(bbgt[:, 2], bb[2])
            iymax = np.minimum(bbgt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                   + (bbgt[:, 2] - bbgt[:, 0] + 1.0)
                   * (bbgt[:, 3] - bbgt[:, 1] + 1.0) - inters)
            overlaps = inters / uni
            ovmax = np.max(overlaps)
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh:
            if not r["difficult"][jmax]:
                if not r["det"][jmax]:
                    tp[d] = 1.0
                    r["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap
