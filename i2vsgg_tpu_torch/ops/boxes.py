"""Box geometry in torch — counterpart of ``i2vsgg_tpu/ops/boxes.py``.

Keeps the reference's ``+1`` box-width convention
(``lib/model/rpn/bbox_transform.py``) and the SGG head's union-box and
dual-mask rasterization (``resnet_SGG_emb.py:240-256``). Boxes are
``[x1, y1, x2, y2]`` in pixels; every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def box_wh(boxes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Widths/heights under the reference's +1 convention."""
    return boxes[..., 2] - boxes[..., 0] + 1.0, boxes[..., 3] - boxes[..., 1] + 1.0


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w, h = box_wh(boxes)
    return w * h


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU, +1 convention."""
    area_a = box_area(a)[..., :, None]
    area_b = box_area(b)[..., None, :]
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]) + 1.0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]) + 1.0)
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    return inter / (area_a + area_b - inter)


def decode_boxes(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply regression deltas to boxes. [bbox_transform.py:79-105]

    ``boxes``: (..., 4); ``deltas``: (..., 4*K). Returns (..., 4*K).
    """
    w, h = box_wh(boxes)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    shape = deltas.shape
    d = deltas.reshape(shape[:-1] + (shape[-1] // 4, 4))
    pred_cx = d[..., 0] * w[..., None] + cx[..., None]
    pred_cy = d[..., 1] * h[..., None] + cy[..., None]
    pred_w = torch.exp(d[..., 2]) * w[..., None]
    pred_h = torch.exp(d[..., 3]) * h[..., None]
    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
    return out.reshape(shape)


def clip_boxes(boxes: torch.Tensor, im_hw) -> torch.Tensor:
    """Clamp boxes (or 4K-packed class boxes) to [0, W-1] x [0, H-1].
    ``im_hw`` is (2,) or (..., 2) broadcasting against the box rows.
    [bbox_transform.py:127-135]"""
    im_hw = torch.as_tensor(im_hw, dtype=boxes.dtype, device=boxes.device)
    shape = boxes.shape
    b = boxes.reshape(shape[:-1] + (shape[-1] // 4, 4))
    xmax = (im_hw[..., 1] - 1)[..., None, None] if im_hw.ndim > 1 else im_hw[1] - 1
    ymax = (im_hw[..., 0] - 1)[..., None, None] if im_hw.ndim > 1 else im_hw[0] - 1
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), xmax)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), ymax)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), xmax)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), ymax)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(shape)


def union_boxes(a: torch.Tensor, b: torch.Tensor, im_h, im_w,
                margin: float = 10.0) -> torch.Tensor:
    """Union box of subject/object with margin, clipped to the image.
    [resnet_SGG_emb.py:240-244] Shapes broadcast: (..., 4) x (..., 4)."""
    x1 = torch.clamp_min(torch.minimum(a[..., 0], b[..., 0]) - margin, 0.0)
    y1 = torch.clamp_min(torch.minimum(a[..., 1], b[..., 1]) - margin, 0.0)
    x2 = torch.minimum(torch.maximum(a[..., 2], b[..., 2]) + margin,
                       torch.as_tensor(im_w, dtype=a.dtype, device=a.device))
    y2 = torch.minimum(torch.maximum(a[..., 3], b[..., 3]) + margin,
                       torch.as_tensor(im_h, dtype=a.dtype, device=a.device))
    return torch.stack([x1, y1, x2, y2], dim=-1)


def dual_mask(im_h, im_w, boxes: torch.Tensor, size: int = 32) -> torch.Tensor:
    """Rasterize boxes onto a ``size``x``size`` binary mask.
    [resnet_SGG_emb.py:246-256]

    x1=floor(x1*size/W) clamped >=0, x2=ceil(x2*size/W) clamped <=size;
    mask[y1:y2, x1:x2] = 1. ``boxes``: (..., 4) -> (..., size, size) float32.
    """
    f32 = torch.float32
    dev = boxes.device
    rh = size / torch.as_tensor(im_h, dtype=f32, device=dev)
    rw = size / torch.as_tensor(im_w, dtype=f32, device=dev)
    boxes = boxes.to(f32)
    x1 = torch.floor(boxes[..., 0] * rw).clamp_min(0.0)
    x2 = torch.ceil(boxes[..., 2] * rw).clamp_max(float(size))
    y1 = torch.floor(boxes[..., 1] * rh).clamp_min(0.0)
    y2 = torch.ceil(boxes[..., 3] * rh).clamp_max(float(size))
    grid = torch.arange(size, dtype=f32, device=dev)
    row = (grid >= y1[..., None]) & (grid < y2[..., None])
    col = (grid >= x1[..., None]) & (grid < x2[..., None])
    return (row[..., :, None] & col[..., None, :]).to(f32)


def relative_loc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """8-dim relative location of box ``a`` to box ``b`` (the
    ``spatial_type=1`` feature): offsets over the other box's size, then
    the logs of the size ratios. [resnet_SGG_emb.py:258-264]"""
    sw = a[..., 2] - a[..., 0]
    sh = a[..., 3] - a[..., 1]
    ow = b[..., 2] - b[..., 0]
    oh = b[..., 3] - b[..., 1]
    xy = torch.stack([(a[..., 0] - b[..., 0]) / ow,
                      (a[..., 1] - b[..., 1]) / oh,
                      (b[..., 0] - a[..., 0]) / sw,
                      (b[..., 1] - a[..., 1]) / sh], dim=-1)
    wh = torch.log(torch.stack([sw / ow, sh / oh, ow / sw, oh / sh], dim=-1))
    return torch.cat([xy, wh], dim=-1)
