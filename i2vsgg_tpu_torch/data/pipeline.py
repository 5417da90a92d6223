"""Input-pipeline pieces the serving program needs — counterparts of
``dequantize_image_u8`` and ``bucket_hw`` in ``i2vsgg_tpu/data/pipeline.py``.

The image decode and resize of that module (``imread_bgr``, ``prep_image``,
``prep_image_u8``, ``DetectionLoader``) use cv2 and are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# landscape bucket widths for height 608; portrait is the transpose.
DEFAULT_BUCKETS = (608, 736, 896, 1056, 1216)


def dequantize_image_u8(images_u8: torch.Tensor, im_info: torch.Tensor,
                        pixel_means: Sequence[float]) -> torch.Tensor:
    """On-device inverse of the uint8 transport: uint8 BGR (B, H, W, 3) ->
    mean-subtracted float32, with the padding beyond each image's true size
    (``im_info[:, :2]``) re-zeroed so that it equals the f32 transport
    exactly (f32 batches pad after the subtraction)."""
    dev = images_u8.device
    x = images_u8.to(torch.float32) - torch.as_tensor(
        pixel_means, dtype=torch.float32, device=dev)
    hh = torch.arange(images_u8.shape[1], device=dev)[None, :, None]
    ww = torch.arange(images_u8.shape[2], device=dev)[None, None, :]
    info = im_info.to(device=dev)
    mask = ((hh < info[:, 0][:, None, None])
            & (ww < info[:, 1][:, None, None]))
    return x * mask[..., None].to(torch.float32)


def bucket_hw(h: int, w: int, buckets: Sequence[int] = DEFAULT_BUCKETS,
              base: int = 608) -> Tuple[int, int]:
    """Static padded shape for a resized image."""
    long_side = max(h, w)
    for b in buckets:
        if long_side <= b:
            padded = b
            break
    else:
        padded = buckets[-1]
    return (base, padded) if w >= h else (padded, base)
