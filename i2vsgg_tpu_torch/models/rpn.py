"""Region Proposal Network — counterpart of ``i2vsgg_tpu/models/rpn.py``.

Head + on-device proposal generation (``lib/model/rpn/proposal_layer.py``):
decode -> clip -> top-k -> padded NMS, batched over images, fixed shapes,
no host round trip. The 2A score channels are [bg x A | fg x A], NHWC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from i2vsgg_tpu_torch.models.backbones import nchw_to_nhwc, nhwc_to_nchw
from i2vsgg_tpu_torch.models.layers import Conv
from i2vsgg_tpu_torch.ops.boxes import clip_boxes, decode_boxes
from i2vsgg_tpu_torch.ops.nms import nms_indices


class RPNHead(nn.Module):
    """3x3 conv + objectness / bbox-delta 1x1 convs. [rpn.py:27-36]
    Inits normal(0, 0.01), zero bias. NHWC in, f32 NHWC out.
    ``in_channels``: the trunk's map width, 1024 for ResNet, 512 for
    VGG16."""

    def __init__(self, num_anchors: int = 9, dtype=torch.bfloat16,
                 in_channels: int = 1024):
        super().__init__()
        a = num_anchors
        self.conv = Conv(in_channels, 512, 3, padding=1, dtype=dtype,
                         init_std=0.01)
        self.cls_score = Conv(512, 2 * a, 1, dtype=dtype, init_std=0.01)
        self.bbox_pred = Conv(512, 4 * a, 1, dtype=dtype, init_std=0.01)

    def forward(self, feat):
        x = F.relu(self.conv(nhwc_to_nchw(feat)))
        cls_score = nchw_to_nhwc(self.cls_score(x)).float()
        bbox_pred = nchw_to_nhwc(self.bbox_pred(x)).float()
        return cls_score, bbox_pred


def rpn_softmax_fg(cls_score: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """(B, H, W, 2A) scores -> (B, H, W, A) fg probabilities, pairing bg
    channel a with fg channel A+a. softmax([bg, fg])[fg] == sigmoid(fg - bg),
    the overflow-safe form. [rpn.py:66-70]"""
    return torch.sigmoid(cls_score[..., num_anchors:]
                         - cls_score[..., :num_anchors])


class Proposals(NamedTuple):
    rois: torch.Tensor      # (B, N, 5) [batch_idx, x1, y1, x2, y2], zero-padded
    valid: torch.Tensor     # (B, N) bool


def generate_proposals(fg_probs: torch.Tensor, bbox_deltas: torch.Tensor,
                       im_info: torch.Tensor, anchors: torch.Tensor,
                       pre_nms_top_n: int, post_nms_top_n: int,
                       nms_thresh: float) -> Proposals:
    """Proposal generation. [proposal_layer.py:48-170]

    fg_probs: (B, H, W, A); bbox_deltas: (B, H, W, 4A);
    im_info: (B, 3) [height, width, scale]; anchors: (H*W*A, 4).
    """
    b = fg_probs.shape[0]
    n = anchors.shape[0]
    scores = fg_probs.reshape(b, n)
    deltas = bbox_deltas.reshape(b, n, 4)
    proposals = decode_boxes(anchors[None], deltas)            # (B, N, 4)
    proposals = clip_boxes(proposals, im_info[:, :2])
    k = min(pre_nms_top_n, n)
    # stable descending sort = lax.top_k's order (ties by lower index)
    top_idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    top_scores = torch.gather(scores, 1, top_idx)
    top_boxes = torch.gather(proposals, 1, top_idx[..., None].expand(b, k, 4))
    keep, keep_valid = nms_indices(top_boxes, top_scores, nms_thresh,
                                   max_out=post_nms_top_n, presorted=True)
    safe = keep.clamp_min(0).to(torch.long)
    rois4 = torch.gather(top_boxes, 1,
                         safe[..., None].expand(b, post_nms_top_n, 4))
    rois4 = torch.where(keep_valid[..., None], rois4, torch.zeros_like(rois4))
    col0 = torch.arange(b, dtype=rois4.dtype, device=rois4.device)
    col0 = col0[:, None, None].expand(b, post_nms_top_n, 1)
    return Proposals(torch.cat([col0, rois4], dim=2), keep_valid)
