"""Inference pieces of the domain discriminators — counterpart of
``i2vsgg_tpu/models/discriminators.py``.

At inference the discriminators only supply context features: the
instance-level ``NetDPixel`` through its full pass on pooled rois (the
non-fused path) or ``preconv``/``context_tail`` (the fused align path), the
ic feature; and ``NetDStyle`` through its signed-sqrt, L2-normalised bilinear
feature ``z`` (the gc feature). The gradient reversal and the LSGAN losses
belong to the training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from i2vsgg_tpu_torch.models.backbones import nchw_to_nhwc, nhwc_to_nchw
from i2vsgg_tpu_torch.models.layers import Conv, Dense


class NetDPixel(nn.Module):
    """Patch discriminator over pooled roi features, inference pieces.
    [resnet_instance_styleD_bilinear.py:38-83]

    Three no-bias 1x1 convs, ``in_channels`` (1024 for ResNet, 512 for
    VGG16) -> 512 -> 128 -> 1. ``forward`` is the full pass on pooled rois;
    the fused align path splits it at conv1, a no-bias 1x1 (linear) that
    commutes exactly with RoIAlign: ``preconv`` applies it once to the
    feature map, the 512 channels are pooled, and ``context_tail`` finishes
    the 128-d context feature.

    ``conv3`` exists only where the JAX tree has it: the non-fused path
    evaluates the d-probability head and so creates it; the fused path
    never touches it (``conv3=False``), and a strict state dict of either
    tree loads.
    """

    def __init__(self, dtype=torch.float32, in_channels: int = 1024,
                 conv3: bool = True):
        super().__init__()
        self.conv1 = Conv(in_channels, 512, 1, bias=False, dtype=dtype,
                          init_std=0.01)
        self.conv2 = Conv(512, 128, 1, bias=False, dtype=dtype, init_std=0.01)
        if conv3:
            self.conv3 = Conv(128, 1, 1, bias=False, dtype=dtype,
                              init_std=0.01)
        self.dtype = dtype

    def forward(self, pooled):
        """(R, P, P, C) pooled rois -> (per-pixel probabilities (R, P, P, 1)
        f32, the 128-d mean after conv2 (R, 128) f32: the ic feature)."""
        x = F.relu(self.conv1(nhwc_to_nchw(pooled.to(self.dtype))))
        x = F.relu(self.conv2(x))
        prob = torch.sigmoid(nchw_to_nhwc(self.conv3(x)).float())
        return prob, x.mean(dim=(2, 3)).float()

    def preconv(self, fmap):
        """conv1 applied to the raw (B, H, W, C) feature map -> NHWC."""
        return nchw_to_nhwc(self.conv1(nhwc_to_nchw(fmap)))

    def context_tail(self, x512):
        """(R, P, P, 512) pre-conv1 pooled features -> (R, 128) f32."""
        x = F.relu(nhwc_to_nchw(x512.to(self.dtype)))
        x = F.relu(self.conv2(x))
        return x.mean(dim=(2, 3)).float()


class NetDStyle(nn.Module):
    """Factorized bilinear style feature on (B, H, W, 512) maps, in Gram
    form. [resnet_instance_styleD_bilinear.py:85-146]

    The pooled pre-activation is a quadratic form in the spatial Gram matrix
    G = sum_p x_p x_p^T (accumulated in f32):

        z[d] = sum_k w1_dk^T G w2_dk + c2.(W1^T s) + c1.(W2^T s) + P c1.c2

    with s = sum_p x_p and P = HW, then signed sqrt and L2 norm. ``forward``
    returns ``z`` (B, dim); the d-probability layer ``fc1`` is kept for the
    checkpoint's sake and is not evaluated at inference.
    """

    def __init__(self, dtype=torch.float32):
        super().__init__()
        cin, dim, rank = 512, 512, 5
        self.dim, self.rank, self.dtype = dim, rank, dtype
        bound = 1.0 / math.sqrt(cin)
        std = math.sqrt(2.0 / (dim * rank))          # kaiming fan_out
        self.fc_1 = Dense(cin, dim * rank, init_std=std, bias_bound=bound)
        self.fc_2 = Dense(cin, dim * rank, init_std=std, bias_bound=bound)
        self.fc1 = Dense(dim, 1, init_std=math.sqrt(2.0),
                         bias_bound=1.0 / math.sqrt(dim))

    def forward(self, x):
        f32 = torch.float32
        b, cin = x.shape[0], x.shape[-1]
        x = x.to(self.dtype).reshape(b, -1, cin)            # (B, HW, C)
        p = x.shape[1]
        xf = x.to(f32)
        g = torch.einsum("bpc,bpd->bcd", xf, xf)             # (B, C, C)
        s = xf.sum(dim=1)                                    # (B, C)
        w1 = self.fc_1.weight.to(f32).t()                    # (C, DR)
        w2 = self.fc_2.weight.to(f32).t()
        c1 = self.fc_1.bias.to(f32)
        c2 = self.fc_2.bias.to(f32)
        m = torch.einsum("bcd,di->bci", g, w2)               # (B, C, DR)
        t = torch.einsum("bci,ci->bi", m, w1)                # (B, DR)
        z = t + c2 * (s @ w1) + c1 * (s @ w2) + float(p) * c1 * c2
        z = z.reshape(b, self.dim, self.rank).sum(-1)        # (B, dim)
        z = torch.sqrt(F.relu(z)) - torch.sqrt(F.relu(-z))   # signed sqrt
        return z / torch.clamp_min(torch.linalg.norm(z, dim=1, keepdim=True),
                                   1e-12)
