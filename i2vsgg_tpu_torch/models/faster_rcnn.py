"""Domain-adaptive Faster R-CNN — counterpart of ``FasterRCNN_DA`` in
``i2vsgg_tpu/models/faster_rcnn.py``: inference, and the two training
passes of Stage A (``train_source``, ``target_pass``).

Backbones ``res<depth>`` (``ResNetTrunk`` + ``ResNetHead``) and ``vgg16``
(``VGG16Trunk`` + ``VGG16Head``); ``class_agnostic`` makes ``bbox_pred`` 4
wide. Two layouts of the same function, chosen as the JAX module chooses
them (``faster_rcnn.py:294-295``):

* the fused align path, for ResNet with ``POOLING_MODE=align`` and 7x7
  pooling (``faster_rcnn.py:297-315``): layer4's stride-2 block0 only reads
  pooled positions (0, 2, 4, 6)^2, so only that 4x4 subgrid is pooled and
  block0 runs at stride 1; netD_pixel's conv1 (no-bias 1x1) commutes with
  RoIAlign, so it runs once on the feature map and the ic context pools 512
  channels;
* the non-fused path, everywhere else (``faster_rcnn.py:118-145, 316-322``):
  the full PxP grid pooled by RoIAlignAvg or, under ``POOLING_MODE=pool``,
  RoIPool on the per-image grouped rois; the head (a stride-2 layer4, or
  VGG16's fc6/fc7) and netD_pixel's full pass on the pooled rois.

The gc feature is NetDStyle's ``z`` over the trunk's tap. Parameter names
are the JAX module's (``trunk``, ``rpn``, ``head``, ``netD_pixel``,
``netD_style``, ``cls_score``, ``bbox_pred``); ``netD_pixel.conv3`` exists
on the non-fused path only, as in the JAX inference tree. ``training_tree``
builds the JAX training tree instead: both discriminators whole, whatever
``ic`` and ``gc`` are (training scores their domain probabilities); such a
module also runs inference.

Training follows the JAX passes: the RPN's outputs are detached before the
proposals (``faster_rcnn.py:99-108``), the rois carry no gradient into the
pooling, the ic and gc context features are computed a second time from a
detached input (``:182-185, 237-240``), and random draws (anchor and roi
sampling, VGG16's dropout) come from the ``torch.Generator`` passed in.

The losses of ``train_source`` are those of the global batch, as JAX's SPMD
step computes them: each is its local sum divided by the ``global_sum``
(``parallel/mesh.py``) of its count (labelled anchors for ``rpn_loss_cls``,
images for ``rpn_loss_box``, sampled rois for the RCNN terms), so the
ranks' losses, and their gradients summed over the ranks, are the global
batch's. Outside a process group the counts are this batch's.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from i2vsgg_tpu_torch.config import Config
from i2vsgg_tpu_torch.models import backbones as bb
from i2vsgg_tpu_torch.models.discriminators import NetDPixel, NetDStyle
from i2vsgg_tpu_torch.models.layers import Dense, torch_dtype
from i2vsgg_tpu_torch.models.rpn import (Proposals, RPNHead,
                                         generate_proposals, rpn_softmax_fg)
from i2vsgg_tpu_torch.models.targets import anchor_targets, proposal_targets
from i2vsgg_tpu_torch.ops.anchors import generate_anchors, shifted_anchors
from i2vsgg_tpu_torch.ops.boxes import smooth_l1_loss
from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
from i2vsgg_tpu_torch.ops.roi_pool import roi_pool
from i2vsgg_tpu_torch.parallel.mesh import global_sum


def masked_softmax_ce(logits, labels, mask, count):
    """Cross entropy over ``mask`` (labels clipped to the classes), as JAX's
    ``_masked_softmax_ce``: its sum divided by ``count`` (floored at 1), the
    mask's sum over the global batch, so that the ranks' losses add up to
    the loss of the global batch (one process: this batch's sum)."""
    labels = labels.clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return (nll * mask.to(logits.dtype)).sum() / count.clamp_min(1.0)


def _is_resnet(backbone: str) -> bool:
    return backbone.startswith("res") and backbone[3:].isdigit() and \
        int(backbone[3:]) in bb.RESNET_STAGES


class FasterRCNN_DA(nn.Module):
    """Detector + DA context heads (inference)."""

    def __init__(self, num_classes: int, cfg: Config,
                 backbone: str = "res101", class_agnostic: bool = False,
                 ic: bool = False, gc: bool = False,
                 training_tree: bool = False):
        super().__init__()
        if cfg.POOLING_MODE not in ("align", "pool"):
            raise ValueError(f"POOLING_MODE {cfg.POOLING_MODE!r}: 'align' or "
                             "'pool'")
        self.cfg = cfg
        self.num_classes = num_classes
        self.class_agnostic = class_agnostic
        self.ic, self.gc = ic, gc
        dtype = torch_dtype(cfg.COMPUTE_DTYPE)
        p = cfg.POOLING_SIZE
        if _is_resnet(backbone):
            depth = int(backbone[3:])
            self.trunk = bb.ResNetTrunk(depth=depth, dtype=dtype)
            self.head = bb.ResNetHead(depth=depth, dtype=dtype)
            feat_c, feat_d = 1024, 2048
        elif backbone == "vgg16":
            self.trunk = bb.VGG16Trunk(dtype=dtype)
            self.head = bb.VGG16Head(p * p * 512, dtype=dtype)
            feat_c, feat_d = 512, 4096
        else:
            raise ValueError(f"backbone {backbone!r}: res<depth> with depth "
                             f"in {sorted(bb.RESNET_STAGES)}, or vgg16")
        self.fused = (backbone.startswith("res")
                      and cfg.POOLING_MODE == "align" and p == 7)
        self.rpn = RPNHead(cfg.num_anchors, dtype=dtype, in_channels=feat_c)
        if ic or training_tree:
            self.netD_pixel = NetDPixel(dtype=dtype, in_channels=feat_c,
                                        conv3=training_tree or not self.fused)
        if gc or training_tree:
            self.netD_style = NetDStyle(dtype=dtype)
        feat_d += 128 * ic + 512 * gc
        self.cls_score = Dense(feat_d, num_classes, init_std=0.01)
        nb = 4 if class_agnostic else 4 * num_classes
        self.bbox_pred = Dense(feat_d, nb, init_std=0.001)
        self._base_anchors = generate_anchors(
            ratios=cfg.ANCHOR_RATIOS, scales=cfg.ANCHOR_SCALES)
        # the flax module paths (``trunk/layer3/block0/conv2``) that the
        # int8 switch's scope tokens match, and that name a refused stage
        for name, m in self.named_modules():
            if isinstance(m, (bb.BNConv, bb.ResNetStage)):
                m.path = name.replace(".", "/")

    def proposals(self, base_feat, rpn_cls, rpn_bbox, im_info,
                  training: bool = False, target: bool = False) -> Proposals:
        """The RPN head's outputs on ``base_feat`` -> decoded, NMS'd
        proposals (rois (B, N, 5), valid (B, N)), by the TEST config or,
        in training, the TRAIN config (the target pass keeps
        ``RPN_POST_NMS_TOP_N_TARGET``). No gradient reaches the RPN heads
        through them: the reference detaches both outputs (``.data``,
        rpn.py:77; JAX ``faster_rcnn.py:99-108``)."""
        c = self.cfg.TRAIN if training else self.cfg.TEST
        post = (c.RPN_POST_NMS_TOP_N_TARGET if training and target
                else c.RPN_POST_NMS_TOP_N)
        with torch.no_grad():
            h, w = base_feat.shape[1:3]
            anchors = shifted_anchors(h, w, self.cfg.FEAT_STRIDE[0],
                                      self._base_anchors, base_feat.device)
            fg = rpn_softmax_fg(rpn_cls, self.cfg.num_anchors)
            return generate_proposals(
                fg, rpn_bbox, im_info, anchors,
                pre_nms_top_n=c.RPN_PRE_NMS_TOP_N, post_nms_top_n=post,
                nms_thresh=c.RPN_NMS_THRESH)

    @torch.no_grad()
    def inference(self, images, im_info) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) NHWC or, for ResNet, ``Conv1Planes`` (whose
        ``shape`` is the image batch's), im_info (B, 3) f32 ->
        {rois (B, N, 5), roi_valid (B, N), cls_prob (B, N, C),
         bbox_pred (B, N, 4C) or (B, N, 4) class-agnostic,
         base_feat (B, H/16, W/16, 1024 or 512)}."""
        base_feat, tap = self.trunk(images)
        return self.detect_on_features(base_feat, tap, im_info)

    def pool(self, base_feat, rois_flat):
        """The non-fused path's roi features: RoIAlignAvg on the full PxP
        grid, or RoIPool (``POOLING_MODE=pool``) on the per-image grouped
        rois -> (R, P, P, C). [faster_rcnn.py:118-129]"""
        p = self.cfg.POOLING_SIZE
        scale = 1.0 / self.cfg.FEAT_STRIDE[0]
        fmap = base_feat.contiguous()
        if self.cfg.POOLING_MODE == "align":
            return roi_align_avg(fmap, rois_flat, p, p, scale)
        return roi_pool(fmap, rois_flat, p, p, scale)

    @torch.no_grad()
    def detect_on_features(self, base_feat, tap, im_info,
                           props: Proposals | None = None
                           ) -> Dict[str, torch.Tensor]:
        """``inference`` past the trunk: its outputs from the trunk's
        ``base_feat`` (B, H/16, W/16, C) and ``tap`` (B, H/8, W/8, 512),
        both NHWC. ``props`` replaces the RPN's proposals (a stage fed
        another run's input)."""
        if props is None:
            props = self.proposals(base_feat, *self.rpn(base_feat), im_info)
        b, n = props.rois.shape[:2]
        rois_flat = props.rois.reshape(b * n, 5).contiguous()
        p = self.cfg.POOLING_SIZE
        scale = 1.0 / self.cfg.FEAT_STRIDE[0]

        feat_instance = None
        if self.fused:
            pooled4 = roi_align_avg(base_feat.contiguous(), rois_flat, p, p,
                                    scale, grid=(0, 2, 4, 6))
            x = self.head(pooled4, first_stride=1).float()
            if self.ic:
                f512 = self.netD_pixel.preconv(base_feat)
                pooled_ic = roi_align_avg(f512.contiguous(), rois_flat, p, p,
                                          scale)
                feat_instance = self.netD_pixel.context_tail(pooled_ic)
        else:
            pooled = self.pool(base_feat, rois_flat)
            if self.ic:
                feat_instance = self.netD_pixel(pooled)[1]
            x = self.head(pooled).float()
        # the concat order of both JAX paths: ic, gc, head
        if self.gc:
            feat_image = self.netD_style(tap)                  # (B, 512)
            x = torch.cat([feat_image.repeat_interleave(n, dim=0), x], dim=1)
        if self.ic:
            x = torch.cat([feat_instance, x], dim=1)
        cls_prob = torch.softmax(self.cls_score(x), dim=-1)
        return {
            "rois": props.rois,
            "roi_valid": props.valid,
            "cls_prob": cls_prob.reshape(b, n, -1),
            "bbox_pred": self.bbox_pred(x).reshape(b, n, -1),
            "base_feat": base_feat,
        }

    # ---------- training (Stage A) ---------------------------------------

    def _classify(self, pooled, feat_image, feat_instance, generator):
        """Pooled rois -> (cls_score, bbox_pred), with the context concat in
        JAX's order ic, gc, head. [faster_rcnn.py:131-147]"""
        if isinstance(self.head, bb.VGG16Head):
            x = self.head(pooled, generator=generator)
        else:
            x = self.head(pooled)
        x = x.float()
        if self.gc:
            n_rep = x.shape[0] // feat_image.shape[0]
            x = torch.cat([feat_image.repeat_interleave(n_rep, dim=0), x], 1)
        if self.ic:
            x = torch.cat([feat_instance, x], dim=1)
        return self.cls_score(x), self.bbox_pred(x)

    def target_pass(self, images, im_info, eta: float = 1.0,
                    eta_style: float = 1.0) -> Dict[str, torch.Tensor]:
        """The target domain's adversarial pass: discriminator outputs only.
        [faster_rcnn_instance_styleD_bilinear.py:60-130]"""
        base_feat, tap = self.trunk(images)
        d_style = self.netD_style(tap, eta_style, prob=True)[0]
        rpn_cls, rpn_bbox = self.rpn(base_feat)
        props = self.proposals(base_feat, rpn_cls, rpn_bbox, im_info,
                               training=True, target=True)
        pooled = self.pool(base_feat, props.rois.reshape(-1, 5).contiguous())
        d_instance = self.netD_pixel(pooled, eta)[0]
        return {"d_instance": d_instance, "d_style": d_style,
                "roi_valid": props.valid.reshape(-1)}

    def train_source(self, images, im_info, gt_boxes, eta: float = 1.0,
                     eta_style: float = 1.0,
                     generator: torch.Generator | None = None
                     ) -> Dict[str, torch.Tensor]:
        """The source pass: RPN and RCNN losses and the discriminator
        outputs. [faster_rcnn.py:175-268]"""
        cfg, t = self.cfg, self.cfg.TRAIN
        b = images.shape[0]
        base_feat, tap = self.trunk(images)

        # style discriminator; the gc feature from a detached tap
        d_style = self.netD_style(tap, eta_style, prob=True)[0]
        feat_image = (self.netD_style(tap.detach(), eta_style)
                      if self.gc else None)
        rpn_cls, rpn_bbox = self.rpn(base_feat)
        props = self.proposals(base_feat, rpn_cls, rpn_bbox, im_info,
                               training=True)

        # RPN losses [rpn.py:75-108]
        h, w = base_feat.shape[1:3]
        anchors = shifted_anchors(h, w, cfg.FEAT_STRIDE[0],
                                  self._base_anchors, base_feat.device)
        with torch.no_grad():
            at = [anchor_targets(
                generator, anchors, gt_boxes[i], im_info[i],
                positive_overlap=t.RPN_POSITIVE_OVERLAP,
                negative_overlap=t.RPN_NEGATIVE_OVERLAP,
                clobber_positives=t.RPN_CLOBBER_POSITIVES,
                fg_fraction=t.RPN_FG_FRACTION, batch_size=t.RPN_BATCHSIZE)
                for i in range(b)]
        labels = torch.stack([a.labels for a in at])
        rpn_targets = [torch.stack([getattr(a, k) for a in at])
                       for k in ("bbox_targets", "inside_weights",
                                 "outside_weights")]

        # proposal sampling, pooling, RCNN losses
        with torch.no_grad():
            rt = [proposal_targets(
                generator, props.rois[i], props.valid[i], gt_boxes[i], i,
                rois_per_image=t.BATCH_SIZE, fg_fraction=t.FG_FRACTION,
                fg_thresh=t.FG_THRESH, bg_thresh_hi=t.BG_THRESH_HI,
                bg_thresh_lo=t.BG_THRESH_LO,
                bbox_normalize_means=t.BBOX_NORMALIZE_MEANS,
                bbox_normalize_stds=t.BBOX_NORMALIZE_STDS,
                bbox_inside_weights=t.BBOX_INSIDE_WEIGHTS) for i in range(b)]
        rois = torch.stack([r.rois for r in rt])                # (B, S, 5)
        s = t.BATCH_SIZE
        # the global batch's counts: labelled anchors, images, sampled rois
        n_lab, n_img, n_roi = global_sum(torch.stack([
            (labels >= 0).sum().float(),
            torch.tensor(float(b), device=labels.device),
            torch.tensor(float(b * s), device=labels.device)]))

        a = cfg.num_anchors
        rpn_logits = torch.stack([rpn_cls[..., :a], rpn_cls[..., a:]],
                                 dim=-1).reshape(b, -1, 2)
        rpn_loss_cls = masked_softmax_ce(rpn_logits, labels, labels >= 0,
                                         n_lab)
        rpn_loss_box = smooth_l1_loss(
            rpn_bbox.reshape(b, -1, 4), rpn_targets[0],
            rpn_targets[1][..., None], rpn_targets[2][..., None],
            sigma=3.0, reduce_dims=(-1, -2), count=n_img)
        pooled = self.pool(base_feat, rois.reshape(b * s, 5).contiguous())
        d_instance = self.netD_pixel(pooled, eta)[0]
        feat_instance = (self.netD_pixel(pooled.detach(), eta)[1]
                         if self.ic else None)
        cls_score, bbox_pred = self._classify(pooled, feat_image,
                                              feat_instance, generator)
        labels_flat = torch.cat([r.labels for r in rt])
        if not self.class_agnostic:
            bp = bbox_pred.reshape(b * s, -1, 4)
            bbox_pred = torch.gather(
                bp, 1, labels_flat[:, None, None].expand(-1, 1, 4))[:, 0]
        rcnn_loss_cls = masked_softmax_ce(cls_score, labels_flat,
                                          torch.ones_like(labels_flat,
                                                          dtype=torch.bool),
                                          n_roi)
        rcnn_loss_bbox = smooth_l1_loss(
            bbox_pred, torch.cat([r.bbox_targets for r in rt]),
            torch.cat([r.inside_weights for r in rt]),
            torch.cat([r.outside_weights for r in rt]), sigma=1.0,
            reduce_dims=(-1,), count=n_roi)
        return {
            "rois": rois, "rois_label": labels_flat.reshape(b, s),
            "rpn_loss_cls": rpn_loss_cls, "rpn_loss_box": rpn_loss_box,
            "rcnn_loss_cls": rcnn_loss_cls, "rcnn_loss_bbox": rcnn_loss_bbox,
            "d_instance": d_instance, "d_style": d_style,
            "fg_cnt": (labels_flat > 0).sum(),
        }
