"""Stage C (part 2): video relation metrics (vIoU mAP / Recall@N / tagging
Precision@K / recognition Accuracy@N) and per-frame output heads — a copy of
``i2vsgg_tpu/video/metrics.py`` (numpy only).

Host-side rebuild of ``lib/utils.py:221-458, 570-627``. Input/output JSON
schemas match the reference exactly so dumps are interchangeable.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from i2vsgg_tpu_torch.eval.voc_eval import voc_ap


def viou(traj_1, duration_1, traj_2, duration_2) -> float:
    """Voluminal IoU of two box trajectories. [lib/utils.py:221-262]"""
    d1s, d1e = duration_1
    d2s, d2e = duration_2
    if d1s >= d2e or d1e <= d2s:
        return 0.0
    t1 = np.asarray(traj_1, np.float64)
    t2 = np.asarray(traj_2, np.float64)
    os_ = max(d1s, d2s)
    oe = min(d1e, d2e)
    a = t1[os_ - d1s:oe - d1s]
    b = t2[os_ - d2s:oe - d2s]
    iw = np.maximum(0.0, np.minimum(a[:, 2], b[:, 2])
                    - np.maximum(a[:, 0], b[:, 0]) + 1)
    ih = np.maximum(0.0, np.minimum(a[:, 3], b[:, 3])
                    - np.maximum(a[:, 1], b[:, 1]) + 1)
    v_overlap = float(np.sum(iw * ih))
    v1 = float(np.sum((t1[:, 2] - t1[:, 0] + 1) * (t1[:, 3] - t1[:, 1] + 1)))
    v2 = float(np.sum((t2[:, 2] - t2[:, 0] + 1) * (t2[:, 3] - t2[:, 1] + 1)))
    return v_overlap / (v1 + v2 - v_overlap)


def eval_detection_scores(gt_relations, pred_relations,
                          viou_threshold: float = 0.5):
    """Greedy vIoU matching -> (prec, rec, hit_scores).
    [lib/utils.py:265-296]"""
    pred_relations = sorted(pred_relations, key=lambda x: x["score"],
                            reverse=True)
    gt_detected = np.zeros(len(gt_relations), bool)
    hit_scores = np.full(len(pred_relations), -np.inf)
    for pi, p in enumerate(pred_relations):
        ov_max, k_max = -np.inf, -1
        for gi, g in enumerate(gt_relations):
            if gt_detected[gi] or tuple(p["triplet"]) != tuple(g["triplet"]):
                continue
            s_iou = viou(p["sub_traj"], p["duration"],
                         g["sub_traj"], g["duration"])
            o_iou = viou(p["obj_traj"], p["duration"],
                         g["obj_traj"], g["duration"])
            ov = min(s_iou, o_iou)
            if ov >= viou_threshold and ov > ov_max:
                ov_max, k_max = ov, gi
        if k_max >= 0:
            hit_scores[pi] = p["score"]
            gt_detected[k_max] = True
    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float32)
    cum_fp = np.cumsum(~tp).astype(np.float32)
    rec = cum_tp / np.maximum(len(gt_relations), np.finfo(np.float32).eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float32).eps)
    return prec, rec, hit_scores


def eval_tagging_scores(gt_relations, pred_relations):
    """Triplet-level tagging precision. [lib/utils.py:298-319]"""
    pred_relations = sorted(pred_relations, key=lambda x: x["score"],
                            reverse=True)
    gt_triplets = {tuple(r["triplet"]) for r in gt_relations}
    pred_triplets, hit_scores = [], []
    for r in pred_relations:
        t = tuple(r["triplet"])
        if t not in pred_triplets:
            pred_triplets.append(t)
            hit_scores.append(r["score"])
    hit_scores = np.asarray(hit_scores)
    for i, t in enumerate(pred_triplets):
        if t not in gt_triplets:
            hit_scores[i] = -np.inf
    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float32)
    cum_fp = np.cumsum(~tp).astype(np.float32)
    rec = cum_tp / np.maximum(len(gt_triplets), np.finfo(np.float32).eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float32).eps)
    return prec, rec, hit_scores


def evaluate(prediction, gt, viou_threshold: float = 0.5,
             det_nreturns: Sequence[int] = (50, 100),
             tag_nreturns: Sequence[int] = (1, 5, 10), verbose: bool = True):
    """Video relation detection + tagging metrics. [lib/utils.py:375-458]

    Args:
      prediction: {vid: [serialized relations]} or a JSON path.
      gt: same schema ground truth, or a JSON path.

    Returns (mean_ap, rec_at_n, mprec_at_n).
    """
    if isinstance(prediction, str):
        prediction = json.load(open(prediction))
    if isinstance(gt, str):
        gt = json.load(open(gt))

    video_ap = {}
    tot_scores = defaultdict(list)
    tot_tp = defaultdict(list)
    prec_at_n = defaultdict(list)
    tot_gt_relations = 0
    for vid, gt_relations in gt.items():
        if len(gt_relations) == 0:
            continue
        predict_relations = prediction.get(vid, [])
        tot_gt_relations += len(gt_relations)
        det_prec, det_rec, det_scores = eval_detection_scores(
            gt_relations, predict_relations, viou_threshold)
        video_ap[vid] = voc_ap(det_rec, det_prec)
        tp = np.isfinite(det_scores)
        for nre in det_nreturns:
            cut = min(nre, det_scores.size)
            tot_scores[nre].append(det_scores[:cut])
            tot_tp[nre].append(tp[:cut])
        tag_prec, _, _ = eval_tagging_scores(gt_relations, predict_relations)
        for nre in tag_nreturns:
            cut = min(nre, tag_prec.size)
            prec_at_n[nre].append(tag_prec[cut - 1] if cut > 0 else 0.0)

    mean_ap = float(np.mean(list(video_ap.values()))) if video_ap else 0.0
    rec_at_n = {}
    for nre in det_nreturns:
        if tot_scores[nre]:
            scores = np.concatenate(tot_scores[nre])
            tps = np.concatenate(tot_tp[nre])[np.argsort(-scores)]
            cum_tp = np.cumsum(tps).astype(np.float32)
            rec = cum_tp / np.maximum(tot_gt_relations,
                                      np.finfo(np.float32).eps)
            rec_at_n[nre] = float(rec[-1]) if rec.size else 0.0
        else:
            rec_at_n[nre] = 0.0
    mprec_at_n = {nre: float(np.mean(prec_at_n[nre])) if prec_at_n[nre]
                  else 0.0 for nre in tag_nreturns}
    if verbose:
        print(f"detection mean AP (used in challenge): {mean_ap}")
        for nre in det_nreturns:
            print(f"detection recall@{nre}: {rec_at_n[nre]}")
        for nre in tag_nreturns:
            print(f"tagging precision@{nre}: {mprec_at_n[nre]}")
    return mean_ap, rec_at_n, mprec_at_n


def evaluate_recognition(predictions: Dict, rec_nreturns=(1, 5),
                         num_fg_classes: int = 15, verbose: bool = True):
    """Recognition Accuracy@N for subject/object/predicate/triplet.
    [lib/utils.py:335-372]"""
    acc_at_n = {k: defaultdict(list) for k in ("sub", "obj", "pre", "rel")}
    for video, triplets in predictions.items():
        for t in triplets:
            sub_pred = np.argsort(-np.asarray(t["sub_score"]))[:10]
            obj_pred = np.argsort(-np.asarray(t["obj_score"]))[:10]
            pre_pred = np.argsort(-np.asarray(t["pre_score"]))[:10]
            sub_c = (sub_pred == t["triplet"][0]).astype(int)
            obj_c = (obj_pred == t["triplet"][2]).astype(int)
            pre_c = (pre_pred == t["triplet"][1]).astype(int)
            for nre in rec_nreturns:
                acc_at_n["sub"][nre].append(sub_c[:nre].sum())
                acc_at_n["obj"][nre].append(obj_c[:nre].sum())
                acc_at_n["pre"][nre].append(pre_c[:nre].sum())
            acc_at_n["rel"][1].append(sub_c[0] * obj_c[0] * pre_c[0])
    out = {k: {} for k in acc_at_n}
    for k in ("sub", "obj", "pre"):
        for nre in rec_nreturns:
            out[k][nre] = float(np.mean(acc_at_n[k][nre])) \
                if acc_at_n[k][nre] else 0.0
    out["rel"][1] = float(np.mean(acc_at_n["rel"][1])) \
        if acc_at_n["rel"][1] else 0.0
    if verbose:
        for k in ("sub", "obj", "pre"):
            for nre in rec_nreturns:
                print(f"{k} recognition accuracy@{nre}: {out[k][nre]}")
        print(f"relationship recognition accuracy@1: {out['rel'][1]}")
    return out


def detection_output(rel_prob: np.ndarray, boxes: np.ndarray,
                     classes: np.ndarray, confs: np.ndarray,
                     ixs: np.ndarray, ixo: np.ndarray, top_k: int = 100):
    """Per-frame top-K (pair, predicate) tuples. [lib/utils.py:584-627]

    Args:
      rel_prob: (P, n_rel) predicate probabilities (softmaxed).
      boxes/classes/confs: (M, 4)/(M,)/(M,) detections.
      ixs/ixo: (P,) pair indices.

    Returns (rlp_labels (K,3), tuple_confs (K,), sub_boxes, obj_boxes,
    rel_idx) or None when fewer than 2 boxes.
    """
    if len(boxes) <= 1 or len(rel_prob) == 0:
        return None
    rel_prob = rel_prob * confs[ixs][:, None] * confs[ixo][:, None]
    flat_order = np.argsort(-rel_prob.ravel())[:top_k]
    pair_idx, rel = np.unravel_index(flat_order, rel_prob.shape)
    k = len(flat_order)
    rlp_labels = np.zeros((top_k, 3))
    sub_boxes = np.zeros((top_k, 4))
    obj_boxes = np.zeros((top_k, 4))
    rlp_labels[:k, 0] = classes[ixs[pair_idx]]
    rlp_labels[:k, 1] = rel
    rlp_labels[:k, 2] = classes[ixo[pair_idx]]
    sub_boxes[:k] = boxes[ixs[pair_idx]]
    obj_boxes[:k] = boxes[ixo[pair_idx]]
    tuple_confs = rel_prob[pair_idx, rel]
    return rlp_labels, tuple_confs, sub_boxes, obj_boxes, pair_idx


def recognition_output(sub_scores: np.ndarray, obj_scores: np.ndarray,
                       rel_scores: np.ndarray, so_prior: np.ndarray,
                       n_rel: int):
    """Recognition-task scores with the +log-prior fusion.
    [lib/utils.py:570-582]"""
    sub_scores = sub_scores.copy()
    obj_scores = obj_scores.copy()
    sub_scores[:, 0] = 0.0
    obj_scores[:, 0] = 0.0
    pre_scores = rel_scores + np.log(0.5 * (so_prior + 1.0 / n_rel))
    return sub_scores, obj_scores, pre_scores
