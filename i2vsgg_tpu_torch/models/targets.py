"""Training-target assignment: RPN anchor targets and RoI proposal targets —
counterpart of ``i2vsgg_tpu/models/targets.py`` (rebuild of
``lib/model/rpn/anchor_target_layer.py:31-219`` and
``lib/model/rpn/proposal_target_layer_cascade.py:20-212``).

As in the JAX package, every step is a masked computation of static shape:

* inside-image anchors are a mask; outside anchors stay at label -1 and
  weight 0;
* random subsampling draws a uniform priority per candidate and keeps the k
  highest (the distribution of ``np.random.permutation(n)[:k]``);
* sampling with replacement indexes the candidates, listed first in index
  order, with ``floor(u * n_cand)``.

Random draws come from an explicit ``torch.Generator`` on the tensors'
device, never from the global random state. ``jax.random`` and torch draw
different numbers, so the two packages agree only in distribution, except
under ``I2VSGG_DETERMINISTIC_SAMPLING=1`` (read at every call): then every
subsample takes the first k candidates in index order and every draw with
replacement takes ``floor((i + 0.5) / k * n_cand)``, as in JAX, and the
targets are equal. The functions are per image; the detector loops over
its batch.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from i2vsgg_tpu_torch.ops.boxes import encode_boxes, pairwise_iou_padded


def deterministic() -> bool:
    """``I2VSGG_DETERMINISTIC_SAMPLING=1``: take the first k candidates
    instead of a random k (for comparisons with the JAX package; not for
    training runs)."""
    return os.environ.get("I2VSGG_DETERMINISTIC_SAMPLING") == "1"


def keep_topk_random(generator, candidate_mask: torch.Tensor,
                     k) -> torch.Tensor:
    """At most ``k`` (an int or a 0-d tensor) of the True entries of
    ``candidate_mask``, chosen uniformly at random. [anchor_target_layer.py:
    131-147]"""
    n = candidate_mask.shape[0]
    dev = candidate_mask.device
    if deterministic():
        rank = torch.cumsum(candidate_mask.to(torch.int64), 0) - 1
        return candidate_mask & (rank < k)
    r = torch.rand(n, generator=generator, device=dev)
    pri = torch.where(candidate_mask, r, torch.full_like(r, -1.0))
    order = torch.argsort(-pri, stable=True)            # candidates first
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev)
    return candidate_mask & (rank < k)


def sample_with_replacement(generator, candidate_mask: torch.Tensor,
                            k: int) -> torch.Tensor:
    """``k`` indices drawn uniformly with replacement from the True entries
    of ``candidate_mask`` [proposal_target_layer_cascade.py:163-190];
    arbitrary when there is none (the caller masks them)."""
    dev = candidate_mask.device
    order = torch.argsort((~candidate_mask).to(torch.int8), stable=True)
    n_cand = candidate_mask.sum()
    if deterministic():
        u = (torch.arange(k, dtype=torch.float32, device=dev) + 0.5) / k
    else:
        u = torch.rand(k, generator=generator, device=dev)
    draw = torch.floor(u * n_cand.to(torch.float32)).to(torch.int64)
    draw = torch.minimum(draw.clamp_min(0), (n_cand - 1).clamp_min(0))
    return order[draw]


class AnchorTargets(NamedTuple):
    labels: torch.Tensor            # (N,) int64 in {-1, 0, 1}
    bbox_targets: torch.Tensor      # (N, 4)
    inside_weights: torch.Tensor    # (N,)
    outside_weights: torch.Tensor   # (N,)


def anchor_targets(generator, anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   im_info: torch.Tensor, *, positive_overlap: float = 0.7,
                   negative_overlap: float = 0.3,
                   clobber_positives: bool = False,
                   fg_fraction: float = 0.5,
                   batch_size: int = 256) -> AnchorTargets:
    """One image's anchor labels and regression targets.
    [anchor_target_layer.py:48-205]

    anchors (N, 4), the full grid; gt_boxes (K, 5) zero-padded
    ``[x1, y1, x2, y2, cls]``; im_info (3,) ``[h, w, scale]``."""
    n = anchors.shape[0]
    f32 = torch.float32
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_info[1]) & (anchors[:, 3] < im_info[0]))
    overlaps = pairwise_iou_padded(anchors, gt_boxes)          # (N, K)
    overlaps = torch.where(inside[:, None], overlaps,
                           torch.full_like(overlaps, -1.0))
    max_ov = overlaps.max(dim=1).values
    argmax_ov = torch.argmax(overlaps, dim=1)                  # first max
    gt_max = overlaps.max(dim=0).values
    gt_max = torch.where(gt_max == 0.0, torch.full_like(gt_max, 1e-5), gt_max)
    is_best_for_gt = (overlaps == gt_max[None, :]).any(dim=1)

    labels = torch.full((n,), -1, dtype=torch.int64, device=anchors.device)
    neg = inside & (max_ov < negative_overlap)
    if not clobber_positives:
        labels = torch.where(neg, 0, labels)
    labels = torch.where(inside & is_best_for_gt, 1, labels)
    labels = torch.where(inside & (max_ov >= positive_overlap), 1, labels)
    if clobber_positives:
        labels = torch.where(neg, 0, labels)

    # at most num_fg positives, then negatives up to batch_size
    num_fg = int(fg_fraction * batch_size)
    fg_keep = keep_topk_random(generator, labels == 1, num_fg)
    labels = torch.where((labels == 1) & ~fg_keep, -1, labels)
    num_bg = batch_size - (labels == 1).sum()
    bg_keep = keep_topk_random(generator, labels == 0, num_bg)
    labels = torch.where((labels == 0) & ~bg_keep, -1, labels)

    tgt = encode_boxes(anchors, gt_boxes[argmax_ov, :4])
    tgt = torch.where(inside[:, None], tgt, torch.zeros_like(tgt))
    inside_w = (labels == 1).to(f32)
    num_examples = (labels >= 0).sum().clamp_min(1).to(f32)
    outside_w = (labels >= 0).to(f32) / num_examples
    return AnchorTargets(labels, tgt, inside_w, outside_w)


class RoiTargets(NamedTuple):
    rois: torch.Tensor              # (S, 5) [batch_idx, x1, y1, x2, y2]
    labels: torch.Tensor            # (S,) int64 class labels (0 = bg)
    bbox_targets: torch.Tensor      # (S, 4) normalized
    inside_weights: torch.Tensor    # (S, 4)
    outside_weights: torch.Tensor   # (S, 4)


def proposal_targets(generator, rois: torch.Tensor, roi_valid: torch.Tensor,
                     gt_boxes: torch.Tensor, batch_idx: int, *,
                     rois_per_image: int = 128, fg_fraction: float = 0.25,
                     fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                     bg_thresh_lo: float = 0.1,
                     bbox_normalize_means=(0.0, 0.0, 0.0, 0.0),
                     bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2),
                     bbox_inside_weights=(1.0, 1.0, 1.0, 1.0)) -> RoiTargets:
    """One image's RoI minibatch and its regression targets.
    [proposal_target_layer_cascade.py:33-212]

    rois (R, 5) zero-padded proposals, roi_valid (R,) bool; gt_boxes (K, 5)
    zero-padded, appended to the candidates as the reference does
    (``:39-43``)."""
    k = gt_boxes.shape[0]
    dev = rois.device
    f32 = torch.float32
    gt_rois = torch.cat([torch.full((k, 1), float(batch_idx), dtype=f32,
                                    device=dev), gt_boxes[:, :4]], dim=1)
    gt_valid = (gt_boxes[:, :4] != 0.0).any(dim=1)
    all_rois = torch.cat([rois, gt_rois], dim=0)                # (R+K, 5)
    all_valid = torch.cat([roi_valid, gt_valid], dim=0)

    overlaps = pairwise_iou_padded(all_rois[:, 1:5], gt_boxes)  # (R+K, K)
    overlaps = torch.where(all_valid[:, None], overlaps,
                           torch.full_like(overlaps, -1.0))
    max_ov = overlaps.max(dim=1).values
    gt_assign = torch.argmax(overlaps, dim=1)
    cand_labels = gt_boxes[gt_assign, 4].to(torch.int64)

    fg_mask = all_valid & (max_ov >= fg_thresh)
    bg_mask = all_valid & (max_ov < bg_thresh_hi) & (max_ov >= bg_thresh_lo)
    n_fg = fg_mask.sum()
    n_bg = bg_mask.sum()
    fg_per_img = max(1, int(round(fg_fraction * rois_per_image)))

    # case 1, fg and bg both present [:156-171]: fg without replacement up
    # to fg_per_img, bg with replacement in the rest
    fg_keep = keep_topk_random(generator, fg_mask,
                               torch.clamp_max(n_fg, fg_per_img))
    n_fg_kept = fg_keep.sum()
    order_fg = torch.argsort((~fg_keep).to(torch.int8), stable=True)
    bg_draw = sample_with_replacement(generator, bg_mask, rois_per_image)
    pos = torch.arange(rois_per_image, device=dev)
    is_fg = pos < n_fg_kept
    idx_case1 = torch.where(is_fg, order_fg[pos], bg_draw)
    lbl_case1 = torch.where(is_fg, cand_labels[idx_case1], 0)
    # case 2, fg only [:173-181]: every slot fg, with replacement
    fg_draw = sample_with_replacement(generator, fg_mask, rois_per_image)
    lbl_case2 = cand_labels[fg_draw]
    # case 3, bg only [:182-193]: every slot bg, with replacement
    bg_draw3 = sample_with_replacement(generator, bg_mask, rois_per_image)

    both = (n_fg > 0) & (n_bg > 0)
    only_fg = (n_fg > 0) & (n_bg == 0)
    sel = torch.where(both, idx_case1, torch.where(only_fg, fg_draw, bg_draw3))
    labels = torch.where(both, lbl_case1,
                         torch.where(only_fg, lbl_case2,
                                     torch.zeros_like(lbl_case2)))

    out_rois = all_rois[sel].clone()
    out_rois[:, 0] = float(batch_idx)
    sel_gt = gt_boxes[gt_assign[sel], :4]
    tgt = encode_boxes(out_rois[:, 1:5], sel_gt)
    means = torch.as_tensor(bbox_normalize_means, dtype=f32, device=dev)
    stds = torch.as_tensor(bbox_normalize_stds, dtype=f32, device=dev)
    tgt = (tgt - means) / stds
    fg_sel = (labels > 0)[:, None]
    in_w = torch.where(fg_sel, torch.as_tensor(bbox_inside_weights,
                                               dtype=f32, device=dev),
                       torch.zeros((), dtype=f32, device=dev))
    out_w = (in_w > 0).to(f32)
    tgt = torch.where(fg_sel, tgt, torch.zeros_like(tgt))
    return RoiTargets(out_rois, labels, tgt, in_w, out_w)
