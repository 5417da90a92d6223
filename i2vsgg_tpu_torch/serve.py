"""Fused serving pipeline — counterpart of ``i2vsgg_tpu/serve.py``.

Per frame batch: backbone, proposals, detector heads, per-class NMS and the
top-K cap (``decode_detections``), pair enumeration, union/dual-mask
features and predicate scoring — all on the device, with static shapes:

* detections padded to ``max_det`` per image with validity masks,
* pairs padded to ``max_det * (max_det - 1)``.

``make_frame_program`` is the port's entry point, and
``make_bucketed_program`` its detection-count-bucketed form. Both take an
NHWC image batch or host-packed ``Conv1Planes``, and run on the card unless
the caller passes ``device="cpu"``. ``frame_relation_tuples`` turns one
frame of their output into the tuples that Stage C
(``video/association.py``) links over time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from i2vsgg_tpu_torch.config import Config
from i2vsgg_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
from i2vsgg_tpu_torch.ops.nms import nms_indices_unsorted
from i2vsgg_tpu_torch.utils.device import resolve_device
from i2vsgg_tpu_torch.video.metrics import detection_output


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) in ORIGINAL image coords
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int64
    valid: torch.Tensor    # (B, K) bool


def decode_detections(rois, roi_valid, cls_prob, bbox_pred, im_info,
                      cfg: Config, *, class_agnostic: bool = False,
                      max_det: int = 100, max_per_class: int = 50,
                      score_thresh: float = 0.0) -> Detections:
    """Bbox decode + per-class NMS + per-image top-K, batched over images
    and classes. [test_net_instance_styleD_bilinear.py:143-221]

    rois (B, N, 5); roi_valid (B, N); cls_prob (B, N, C);
    bbox_pred (B, N, 4C), or (B, N, 4) from a class-agnostic detector;
    im_info (B, 3) [h, w, scale] — boxes are rescaled back by 1/scale. A
    class keeps the rois whose score is above ``score_thresh``.

    ``class_agnostic``: every class takes box column 0. The columns are
    read from ``bbox_pred``'s width, and with one column every class takes
    it whatever ``class_agnostic`` says: the JAX function reads column
    ``j`` for class ``j`` there (``i2vsgg_tpu/serve.py:69``), an
    out-of-range gather that JAX clamps to column 0, so its frame program,
    which never passes ``class_agnostic``, serves a class-agnostic detector
    the same way. Without box regression every class takes the roi itself.
    """
    b, n, c = cls_prob.shape
    if max_det > (c - 1) * max_per_class:
        raise ValueError(f"max_det {max_det} exceeds the {(c - 1) * max_per_class}"
                         " per-class candidates")
    dev = cls_prob.device
    boxes = rois[..., 1:5]
    if cfg.TEST.BBOX_REG:
        k = bbox_pred.shape[-1] // 4
        if k not in (1, c) or bbox_pred.shape[-1] != 4 * k:
            raise ValueError(f"bbox_pred width {bbox_pred.shape[-1]}: 4 or "
                             f"4 * {c} classes")
        stds = torch.tensor(cfg.TRAIN.BBOX_NORMALIZE_STDS, device=dev)
        means = torch.tensor(cfg.TRAIN.BBOX_NORMALIZE_MEANS, device=dev)
        d = bbox_pred.reshape(b, n, k, 4) * stds + means
        pred = decode_boxes(boxes[:, :, None, :].expand(b, n, k, 4), d)
        pred = clip_boxes(pred.reshape(b, n, k * 4),
                          im_info[:, :2]).reshape(b, n, k, 4)
    else:
        pred = boxes[:, :, None, :]
    if class_agnostic:
        pred = pred[:, :, :1]
    pred = (pred / im_info[:, 2, None, None, None]     # back to original scale
            ).expand(b, n, c, 4)

    # per class (background skipped): (B, C-1, N, ...)
    scores_c = cls_prob[..., 1:].transpose(1, 2)
    boxes_c = pred[:, :, 1:].transpose(1, 2)
    ok = roi_valid[:, None, :] & (scores_c > score_thresh)
    keep, kv = nms_indices_unsorted(boxes_c, scores_c, cfg.TEST.NMS,
                                    max_out=max_per_class, valid=ok)
    safe = keep.clamp_min(0).to(torch.long)                   # (B, C-1, K)
    kept_boxes = torch.gather(
        boxes_c, 2, safe[..., None].expand(*safe.shape, 4))
    kept_scores = torch.gather(scores_c, 2, safe) * kv

    flat_boxes = kept_boxes.reshape(b, -1, 4)
    flat_scores = torch.where(kv, kept_scores,
                              torch.full_like(kept_scores, -1.0)).reshape(b, -1)
    flat_cls = torch.arange(1, c, device=dev).repeat_interleave(max_per_class)
    flat_valid = kv.reshape(b, -1)
    # stable descending sort = lax.top_k's order (ties by lower index)
    top_idx = torch.sort(flat_scores, dim=1, descending=True,
                         stable=True).indices[:, :max_det]
    top_scores = torch.gather(flat_scores, 1, top_idx)
    return Detections(
        torch.gather(flat_boxes, 1, top_idx[..., None].expand(b, max_det, 4)),
        top_scores, flat_cls[top_idx],
        torch.gather(flat_valid, 1, top_idx) & (top_scores > 0))


def make_pair_indices(max_det: int) -> tuple[np.ndarray, np.ndarray]:
    """All ordered pairs (i != j) of detection slots.
    [faster_rcnn_SGG_emb.py:597-606]"""
    ix1, ix2 = [], []
    for i in range(max_det):
        for j in range(max_det):
            if i != j:
                ix1.append(i)
                ix2.append(j)
    return np.asarray(ix1, np.int32), np.asarray(ix2, np.int32)


def make_union_dedup(ix1: np.ndarray, ix2: np.ndarray):
    """(iu1, iu2, u_map) for a static pair layout: the unordered union list
    and the pair -> union row map. union(i, j) == union(j, i), so pooling one
    union per unordered pair is exact at half the work."""
    slot = {}
    iu1, iu2, u_map = [], [], []
    for i, j in zip(ix1.tolist(), ix2.tolist()):
        key = (min(i, j), max(i, j))
        if key not in slot:
            slot[key] = len(iu1)
            iu1.append(key[0])
            iu2.append(key[1])
        u_map.append(slot[key])
    return (np.asarray(iu1, np.int32), np.asarray(iu2, np.int32),
            np.asarray(u_map, np.int32))


def pair_layout(max_det: int, dev):
    """(ix1, ix2, (iu1, iu2, u_map)) as index tensors on ``dev``."""
    ix1_np, ix2_np = make_pair_indices(max_det)
    as_idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)
    pair_static = tuple(as_idx(a) for a in make_union_dedup(ix1_np, ix2_np))
    return as_idx(ix1_np), as_idx(ix2_np), pair_static


def _to_device(images, im_info, dev):
    """A program's inputs on ``dev``: images as f32, ``Conv1Planes`` as bf16
    planes (no f32 detour), im_info as f32."""
    if isinstance(images, Conv1Planes):
        images = images.to(dev)
    else:
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    return images, torch.as_tensor(im_info, dtype=torch.float32, device=dev)


def _decode(det_out, im_info, cfg, max_det, max_per_class) -> Detections:
    return decode_detections(det_out["rois"], det_out["roi_valid"],
                             det_out["cls_prob"], det_out["bbox_pred"],
                             im_info, cfg, max_det=max_det,
                             max_per_class=max_per_class)


def relation_heads(sgg_model, base_feat, im_info, boxes, valid, layout,
                   prd):
    """The SGG head frame by frame on the detector's feature map -> (rel_prob
    (B, P, n_rel), pair_valid (B, P))."""
    ix1, ix2, pair_static = layout
    rel_prob, pair_valid = [], []
    for f in range(base_feat.shape[0]):
        # the relation head works at input scale on the detector's own
        # feature map (one trunk pass per frame for both stages)
        info = im_info[f]
        pv = valid[f][ix1] & valid[f][ix2]
        res = sgg_model.head_on_features(
            base_feat[f:f + 1], info, boxes[f] * info[2], ix1, ix2, pv, prd,
            pair_static=pair_static)
        rel_prob.append(torch.softmax(res["scores"], dim=-1))
        pair_valid.append(pv)
    return torch.stack(rel_prob), torch.stack(pair_valid)


def program_outputs(sgg_model, det_out, im_info, prd, layout, cfg: Config, *,
                    max_det: int, max_per_class: int) -> dict:
    """The frame program past the detector: ``det_out`` (the output of
    ``FasterRCNN_DA.inference``, or of ``detect_on_features`` for a trunk
    fed another run's maps) and ``im_info`` (B, 3) on the model's device,
    ``prd`` the predicate vectors there and ``layout`` a ``pair_layout`` ->
    the program's output dict."""
    dets = _decode(det_out, im_info, cfg, max_det, max_per_class)
    rel_prob, pair_valid = relation_heads(
        sgg_model, det_out["base_feat"], im_info, dets.boxes, dets.valid,
        layout, prd)
    return {
        "boxes": dets.boxes, "scores": dets.scores,
        "classes": dets.classes, "det_valid": dets.valid,
        "rel_prob": rel_prob, "pair_valid": pair_valid,
        "ix1": layout[0], "ix2": layout[1],
    }


def make_frame_program(det_model, sgg_model, prd_vecs, cfg: Config, *,
                       max_det: int = 16, max_per_class: int = 8,
                       device: str | torch.device = "cuda"):
    """Build the fused det+SGG per-frame program.

    ``det_model`` (``FasterRCNN_DA``) and ``sgg_model`` (``SGGModel``) carry
    their weights and are moved to ``device``. Returns
    ``fn(images, im_info (B, 3)) -> dict`` of detections and per-pair
    predicate probabilities, padded and masked. ``images`` is an NHWC
    (B, H, W, 3) batch (numpy or tensor, moved to the device as f32) or
    host-packed ``Conv1Planes`` (moved as bf16; the trunk's conv1 kernel
    reads them).
    """
    dev = resolve_device(device)
    det_model.to(dev).eval()
    sgg_model.to(dev).eval()
    layout = pair_layout(max_det, dev)
    prd = torch.as_tensor(np.asarray(prd_vecs, np.float32), device=dev)

    @torch.no_grad()
    def frame_program(images, im_info):
        images, im_info = _to_device(images, im_info, dev)
        return program_outputs(sgg_model, det_model.inference(images, im_info),
                               im_info, prd, layout, cfg, max_det=max_det,
                               max_per_class=max_per_class)

    return frame_program


def _check_buckets(buckets, max_det: int) -> tuple:
    """The detection-count buckets as given, refused unless they increase
    strictly and the largest is ``max_det`` (the JAX driver's guard let an
    unsorted list, or a largest bucket above ``--max_det``, through)."""
    buckets = tuple(int(b) for b in buckets)
    if not buckets or min(buckets) < 1:
        raise ValueError(f"buckets {buckets}: need one or more sizes >= 1")
    if any(a >= b for a, b in zip(buckets, buckets[1:])):
        raise ValueError(f"buckets {buckets} must increase strictly")
    if buckets[-1] != max_det:
        raise ValueError(f"the largest bucket ({buckets[-1]}) must be "
                         f"max_det ({max_det})")
    return buckets


def make_bucketed_program(det_model, sgg_model, prd_vecs, cfg: Config, *,
                          buckets: tuple = (4, 8, 16), max_det: int = 16,
                          max_per_class: int = 8,
                          device: str | torch.device = "cuda"):
    """Detection-count pair bucketing (``serve.py:177`` of the JAX package).

    The detector and decode run at ``max_det``; the batch's largest count of
    valid detections is read back to the host (one sync per batch), and the
    SGG head runs on the first ``b`` detection slots, ``b`` the smallest
    bucket that holds that count. Detections are sorted by score, so the
    valid ones come first; a pair valid in bucket ``b`` is scored as in every
    larger bucket (only the padding differs). The output adds ``bucket``.
    """
    buckets = _check_buckets(buckets, max_det)
    dev = resolve_device(device)
    det_model.to(dev).eval()
    sgg_model.to(dev).eval()
    layouts: Dict[int, tuple] = {}
    prd = torch.as_tensor(np.asarray(prd_vecs, np.float32), device=dev)

    @torch.no_grad()
    def frame_program(images, im_info):
        images, im_info = _to_device(images, im_info, dev)
        out = det_model.inference(images, im_info)
        dets = _decode(out, im_info, cfg, max_det, max_per_class)
        n = int(dets.valid.sum(dim=1).max())          # the one host sync
        b = next(x for x in buckets if x >= n)
        if b not in layouts:
            layouts[b] = pair_layout(b, dev)
        rel_prob, pair_valid = relation_heads(
            sgg_model, out["base_feat"], im_info, dets.boxes[:, :b],
            dets.valid[:, :b], layouts[b], prd)
        return {
            "boxes": dets.boxes, "scores": dets.scores,
            "classes": dets.classes, "det_valid": dets.valid,
            "rel_prob": rel_prob, "pair_valid": pair_valid,
            "ix1": layouts[b][0], "ix2": layouts[b][1], "bucket": b,
        }

    return frame_program


def frame_relation_tuples(out: Dict, frame: int, top_k: int = 100) -> list:
    """Frame ``frame`` of a program's output -> its relation tuples
    ``[conf, [s_cls, pred, o_cls], [sub_box, obj_box], rank]``, the
    per-frame step of Stage C as ``tools/serve_video.py`` runs it (pair
    indices remapped into the valid-compacted detections)."""
    o = {k: ((v.float() if v.is_floating_point() else v).cpu().numpy()
             if torch.is_tensor(v) else v) for k, v in out.items()}
    valid = o["det_valid"][frame]
    pv = o["pair_valid"][frame]
    pos = np.cumsum(valid) - 1
    res = detection_output(
        o["rel_prob"][frame][pv], o["boxes"][frame][valid],
        o["classes"][frame][valid], o["scores"][frame][valid],
        pos[o["ix1"][pv]], pos[o["ix2"][pv]], top_k=top_k)
    tuples = []
    if res is not None:
        rlp, tconfs, sboxes, oboxes, _ = res
        for t in range(len(tconfs)):
            tuples.append([float(tconfs[t]), [int(c) for c in rlp[t]],
                           [sboxes[t].tolist(), oboxes[t].tolist()], t])
    return tuples
