"""Domain-adaptive Faster R-CNN, inference — counterpart of
``FasterRCNN_DA.inference`` in ``i2vsgg_tpu/models/faster_rcnn.py``.

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
on the non-fused path only, as in the JAX tree.
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
from i2vsgg_tpu_torch.ops.anchors import generate_anchors, shifted_anchors
from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
from i2vsgg_tpu_torch.ops.roi_pool import roi_pool


def _is_resnet(backbone: str) -> bool:
    return backbone.startswith("res") and backbone[3:].isdigit() and \
        int(backbone[3:]) in bb.RESNET_STAGES


class FasterRCNN_DA(nn.Module):
    """Detector + DA context heads (inference)."""

    def __init__(self, num_classes: int, cfg: Config,
                 backbone: str = "res101", class_agnostic: bool = False,
                 ic: bool = False, gc: bool = False):
        super().__init__()
        if cfg.POOLING_MODE not in ("align", "pool"):
            raise ValueError(f"POOLING_MODE {cfg.POOLING_MODE!r}: 'align' or "
                             "'pool'")
        self.cfg = cfg
        self.num_classes = num_classes
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
        if ic:
            self.netD_pixel = NetDPixel(dtype=dtype, in_channels=feat_c,
                                        conv3=not self.fused)
            feat_d += 128
        if gc:
            self.netD_style = NetDStyle(dtype=dtype)
            feat_d += 512
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

    def proposals(self, base_feat, rpn_cls, rpn_bbox, im_info) -> Proposals:
        """The RPN head's outputs on ``base_feat`` -> decoded, NMS'd
        proposals (rois (B, N, 5), valid (B, N))."""
        h, w = base_feat.shape[1:3]
        anchors = shifted_anchors(h, w, self.cfg.FEAT_STRIDE[0],
                                  self._base_anchors, base_feat.device)
        fg = rpn_softmax_fg(rpn_cls, self.cfg.num_anchors)
        t = self.cfg.TEST
        return generate_proposals(
            fg, rpn_bbox, im_info, anchors,
            pre_nms_top_n=t.RPN_PRE_NMS_TOP_N,
            post_nms_top_n=t.RPN_POST_NMS_TOP_N, nms_thresh=t.RPN_NMS_THRESH)

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
