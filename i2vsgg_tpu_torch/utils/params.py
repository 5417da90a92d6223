"""Parameter dtype policy for serving weights — counterpart of
``i2vsgg_tpu/utils/params.py`` (``bf16_storage_cast``,
``quantize_trunk_params``, ``quantize_dense_params``), copied, never
imported (that module imports JAX).

Each function acts on a port module in place (the JAX ones map a parameter
tree to a new one) and returns it. Applied in the JAX order —
``bf16_storage_cast``, then ``quantize_dense_params``, then
``quantize_trunk_params`` — the int8 taps and scales are bit-identical to
the JAX functions' on the same weights.
"""

from __future__ import annotations

import json

import torch
from torch import nn

from i2vsgg_tpu_torch.models.sgg import DenseInt8
from i2vsgg_tpu_torch.ops.int8 import weight_quant


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


def _store_int8(m: nn.Module, w_q: torch.Tensor, w_s: torch.Tensor):
    """``m.weight`` becomes the int8 taps (a parameter without gradient, so
    that ``.to(device)`` and ``state_dict`` carry it) and ``kernel_scale``
    an f32 buffer (which ``bf16_storage_cast`` leaves alone)."""
    m.weight = nn.Parameter(w_q, requires_grad=False)
    m.register_buffer("kernel_scale", w_s)


def load_act_scales(path: str) -> dict:
    """A calibration file (``runs/calib/act_scales_res101.json``): its
    ``scales`` mapping of conv paths to static activation scales, or the
    file itself when it is that mapping."""
    with open(path) as f:
        acts = json.load(f)
    return acts.get("scales", acts)


@torch.no_grad()
def quantize_trunk_params(module: nn.Module, scope: str = "layer3,layer4",
                          act_scales=None) -> nn.Module:
    """Store the in-scope trunk conv weights of ``module`` in int8, in
    place (the JAX function on the module's tree): each selected 4-D
    ``weight`` becomes its per-output-channel int8 taps plus a
    ``kernel_scale`` buffer, and with ``act_scales`` an ``act_scale`` buffer
    (0-d f32) that ``BNConv`` quantizes its input with.

    Selection, as in JAX: a conv whose module path (the state-dict name's
    parts) has a part starting with ``block``; with scope tokens, a part
    that contains one of them (substring of a single part); 1x1 kernels are
    skipped under a part ``layer4`` (they run on per-roi 4x4 grids); the
    token ``@3x3`` keeps 3x3 kernels only. ``act_scales`` is a dict of
    ``"trunk/layer3/block0/conv2"``-style paths (``KeyError`` for an
    in-scope conv it lacks) or one scale for every conv. Apply after
    ``bf16_storage_cast``.
    """
    tokens = [t for t in scope.split(",") if t] if scope else []
    k3_only = "@3x3" in tokens
    ptoks = [t for t in tokens if not t.startswith("@")]
    for name, m in module.named_modules():
        w = getattr(m, "weight", None)
        if not isinstance(w, torch.Tensor) or w.dim() != 4 or \
                w.dtype == torch.int8:
            continue
        names = tuple(name.split("."))
        k = w.shape[2]
        in_scope = (any(n.startswith("block") for n in names)
                    and (not ptoks or any(t in n for t in ptoks
                                          for n in names))
                    and not (k == 1 and "layer4" in names)
                    and not (k3_only and k != 3))
        if not in_scope:
            continue
        _store_int8(m, *weight_quant(w))
        if act_scales is not None:
            path = "/".join(names)
            a = (act_scales if not isinstance(act_scales, dict)
                 else act_scales.get(path))
            if a is None:
                raise KeyError(f"act_scales missing calibration for "
                               f"in-scope conv {path!r}")
            m.register_buffer("act_scale", torch.as_tensor(
                a, dtype=torch.float32, device=w.device))
    return module


@torch.no_grad()
def quantize_dense_params(module: nn.Module,
                          names=("fc6", "fc7")) -> nn.Module:
    """Store the 2-D ``weight`` of every submodule named in ``names`` in
    int8 with its ``kernel_scale``, in place (the JAX function: the fc6/fc7
    towers of a head built with ``int8_fc=True``). Refuses a module that is
    not a ``DenseInt8``: a plain ``Dense`` cannot take int8 weights (in JAX
    the tree would fail when applied)."""
    for name, m in module.named_modules():
        w = getattr(m, "weight", None)
        if (name.split(".")[-1] not in names
                or not isinstance(w, torch.Tensor) or w.dim() != 2
                or w.dtype == torch.int8):
            continue
        if not isinstance(m, DenseInt8):
            raise TypeError(f"{name} is a {type(m).__name__}, not a "
                            "DenseInt8: build the head with int8_fc=True")
        _store_int8(m, *weight_quant(w))
    return module
