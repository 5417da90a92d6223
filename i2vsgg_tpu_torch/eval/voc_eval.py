"""PASCAL-VOC average precision — ``voc_ap``, copied from
``i2vsgg_tpu/eval/voc_eval.py`` (the Stage-C metrics need it). The
annotation-file evaluation (``voc_eval``, ``parse_rec``) waits for the
drivers' slice."""

from __future__ import annotations

import numpy as np


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
