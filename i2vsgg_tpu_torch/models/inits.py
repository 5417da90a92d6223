"""Weight initializers with the reference's distributions — counterpart of
``i2vsgg_tpu/models/inits.py``, for training from scratch.

The reference initializes its fresh heads explicitly
(``faster_rcnn_instance_styleD_bilinear.py:195-211``: normal 0.01 / 0.001;
``resnet_instance_styleD_bilinear.py:52-64``: the netD_pixel convs normal
0.01; ``:104-118``: netD_style's FCs kaiming normal fan-out with torch's
default biases) and leaves every other layer to its own default, which the
JAX package gives as flax's (``lecun_normal``: a normal truncated at two
standard deviations, rescaled to variance ``1 / fan_in``; zero biases).

The port's layers carry these choices (``models/layers.py``): ``init_std``
is an explicit normal (a kaiming fan-out std is ``sqrt(2 / fan_out)``),
``init_bound`` a torch-default uniform weight (``nn.Linear``/``nn.Conv2d``:
``kaiming_uniform_(a=sqrt(5))``, uniform in ``+-1/sqrt(fan_in)``; JAX's
``torch_linear_kernel``, which the relation head uses throughout),
``bias_bound`` a torch-default uniform bias. ``init_module`` fills a module
by them from an explicit ``torch.Generator``; ``layers.init_weights``
stays the serving tests' init. A layer's fan-in counts a conv's window, as
flax's ``variance_scaling`` and torch's ``_calculate_fan_in_and_fan_out``
count it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from i2vsgg_tpu_torch.models.layers import Conv, Dense

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling
# divides by it, so that the truncated draw has the requested variance)
_TRUNC_STD = 0.87962566103423978


def _draw(shape, generator, fill) -> torch.Tensor:
    t = torch.empty(shape, device=generator.device)
    return fill(t)


def normal(shape, std: float, generator) -> torch.Tensor:
    """torch ``normal_init(m, 0, std)``."""
    return _draw(shape, generator,
                 lambda t: t.normal_(0.0, std, generator=generator))


def uniform(shape, bound: float, generator) -> torch.Tensor:
    """Uniform in ``+-bound`` (torch's default Linear/Conv2d draws)."""
    return _draw(shape, generator,
                 lambda t: t.uniform_(-bound, bound, generator=generator))


def lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated to two standard
    deviations, scaled to variance ``1 / fan_in``."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = _draw(shape, generator,
              lambda t: t.uniform_(lo, 1.0 - lo, generator=generator))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z.clamp(-2.0, 2.0) * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every ``Dense``/``Conv`` of ``module`` as the JAX package
    initializes it for training: weights normal with the layer's
    ``init_std`` (the reference's explicit inits), uniform in
    ``+-init_bound`` (torch-default layers) or ``lecun_normal``; biases
    uniform in ``+-bias_bound`` (torch-default layers) or zero.
    FrozenBatchNorm buffers keep their identity statistics. Drawn on the
    generator's device, copied to the parameters'."""
    for m in module.modules():
        if not isinstance(m, (Dense, Conv)):
            continue
        shape = tuple(m.weight.shape)
        fan_in = m.weight[0].numel()
        if m.init_std is not None:
            w = normal(shape, m.init_std, generator)
        elif m.init_bound is not None:
            w = uniform(shape, m.init_bound, generator)
        else:
            w = lecun_normal(shape, fan_in, generator)
        m.weight.copy_(w)
        if m.bias is not None:
            if m.bias_bound:
                m.bias.copy_(uniform(tuple(m.bias.shape), m.bias_bound,
                                     generator))
            else:
                m.bias.zero_()
    return module


@torch.no_grad()
def zero_init_residual(module: nn.Module) -> nn.Module:
    """``--zero_init_residual``: every bottleneck's ``bn3`` scale set to 0
    (the JAX driver's ``_zero_bn3``)."""
    for name, buf in module.named_buffers():
        if name.endswith("bn3.scale"):
            buf.zero_()
    return module
