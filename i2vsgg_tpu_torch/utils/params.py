"""Parameter dtype policy for serving weights — counterpart of
``i2vsgg_tpu/utils/params.py`` (``bf16_storage_cast``), copied, never
imported (that module imports JAX)."""

from __future__ import annotations

import torch
from torch import nn


def keep_fp32(name: str) -> bool:
    """Whether the parameter ``name`` (a dotted state-dict name) stays f32
    when weights are stored in bf16: the JAX rule ``_keep_fp32`` on the same
    path parts — a part equal to ``bbox_pred`` (box-regression weights feed
    the coordinate decode), starting with ``bn`` or ending with ``_bn``
    (FrozenBatchNorm statistics)."""
    return any(part == "bbox_pred" or part.startswith("bn")
               or part.endswith("_bn") for part in name.split("."))


@torch.no_grad()
def bf16_storage_cast(module: nn.Module) -> nn.Module:
    """Store ``module``'s f32 parameters in bf16, in place, except the
    ``keep_fp32`` ones; returns ``module``.

    The parameters themselves change dtype (not only their values), so a
    layer built with ``dtype=None`` computes in the promoted type of its
    input and its bf16 weights, as flax does with a bf16-stored tree. The
    FrozenBatchNorm statistics are buffers and stay f32. A later
    ``load_state_dict`` copies into the bf16 parameters.
    """
    for name, p in module.named_parameters():
        if p.dtype == torch.float32 and not keep_fp32(name):
            p.data = p.data.to(torch.bfloat16)
    return module
