"""Parameter-holding layers with flax's names and numerics.

The port's modules keep the JAX package's parameter tree: a flax
``nn.Conv``/``nn.Dense`` named ``x`` becomes a ``Conv``/``Dense`` attribute
``x`` whose ``weight`` and ``bias`` are the flax ``kernel`` and ``bias``,
stored in PyTorch's orientation (OIHW, (O, I)). ``utils/weights.py`` maps one
tree onto the other.

Parameters are allocated as zeros (never uninitialized memory, which can
hold NaN bit patterns): a module is either loaded from a checkpoint or
filled by ``init_weights`` (or ``inits.init_module``) from an explicit
``torch.Generator``, never from PyTorch's global random state.

Numerics follow flax: a layer built with ``dtype=None`` computes in the
promoted type of its input and its (f32) parameters; one built with a dtype
casts both to it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (``cfg.COMPUTE_DTYPE`` names)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _compute_dtype(x: torch.Tensor, w: torch.Tensor, dtype):
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class Dense(nn.Module):
    """``y = x @ W^T + b`` with W (out, in) — flax ``nn.Dense``."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: torch.dtype | None = None,
                 init_std: float | None = None,
                 init_bound: float | None = None,
                 bias_bound: float | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.init_std = init_std
        self.init_bound = init_bound
        self.bias_bound = bias_bound

    def forward(self, x):
        dt = _compute_dtype(x, self.weight, self.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Module):
    """2-D convolution on NCHW tensors — flax ``nn.Conv`` (whose HWIO kernel
    is stored here as OIHW). ``padding`` is symmetric per axis."""

    def __init__(self, in_features: int, features: int, kernel: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype | None = None,
                 init_std: float | None = None,
                 init_bound: float | None = None,
                 bias_bound: float | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.init_std = init_std
        self.init_bound = init_bound
        self.bias_bound = bias_bound

    def forward(self, x, stride: int | None = None):
        dt = _compute_dtype(x, self.weight, self.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b,
                        stride or self.stride, self.padding)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every ``Dense``/``Conv`` of ``module`` with seeded random values.

    Weights are normal with the layer's ``init_std`` (the JAX package's
    explicit head inits), with std ``init_bound / sqrt(3)`` (the variance of
    a torch-default layer's uniform draw) or, by default, std
    ``1/sqrt(fan_in)`` (the variance of flax's ``lecun_normal``); biases
    are uniform in
    ``+-bias_bound`` (torch-default layers) or zero. ``FrozenBatchNorm``
    buffers keep their identity statistics. Values are drawn on the
    generator's device and copied to the parameters' device.
    """
    gdev = generator.device
    for m in module.modules():
        if not isinstance(m, (Dense, Conv)):
            continue
        fan_in = m.weight[0].numel()
        if m.init_std is not None:
            std = m.init_std
        elif m.init_bound is not None:
            std = m.init_bound / math.sqrt(3.0)
        else:
            std = 1.0 / math.sqrt(fan_in)
        w = torch.empty(m.weight.shape, device=gdev).normal_(
            0.0, std, generator=generator)
        m.weight.copy_(w)
        if m.bias is not None:
            if m.bias_bound:
                b = torch.empty(m.bias.shape, device=gdev).uniform_(
                    -m.bias_bound, m.bias_bound, generator=generator)
                m.bias.copy_(b)
            else:
                m.bias.zero_()
    return module
