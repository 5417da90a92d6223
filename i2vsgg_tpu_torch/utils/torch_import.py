"""Import the reference's PyTorch checkpoints into the port's modules — the
counterpart of ``i2vsgg_tpu/utils/torch_import.py``.

The reference (jwyang's faster-rcnn.pytorch layout) names its tensors
``RCNN_base.{0,1,4,5,6}.*`` (conv1, bn1, layer1-3), ``RCNN_top.0.*``
(layer4), ``RCNN_rpn.RPN_*``, ``RCNN_{cls_score,bbox_pred}``,
``netD_pixel.conv{1,2,3}``, ``netD_style.{fc_1,fc_2,fc1}`` and, in its SGG
checkpoints, ``vrd.*`` [resnet_instance_styleD_bilinear.py:368-379,
resnet_SGG_emb.py:64-130]. Each function here maps such a state dict to a
flat dict under the port's state-dict names (the flax module names).

The port keeps PyTorch's layouts — conv (O, I, KH, KW), linear (O, I) — so
no weight is transposed. Only names change, plus one permutation: the port
pools HWC, as the JAX package does, and flattens the pooled (7, 7, C)
feature in that order, so fc6's (4096, C*7*7) weight, whose columns the
reference orders C, H, W, becomes ``w.reshape(o, c, 7, 7).permute(0, 2, 3,
1).reshape(o, -1)``. BatchNorm ``weight/bias/running_mean/running_var``
become the FrozenBatchNorm buffers ``scale/bias/mean/var``.

``--pretrained_backbone`` reads a torchvision-layout state dict
(``conv1``, ``bn1``, ``layer1``-``layer4`` for ResNet, caffe-converted or
not; ``features.N``/``classifier.N`` for VGG16): ``resnet_trunk_params``,
``resnet_head_params``, ``vgg16_trunk_params`` and ``vgg16_head_params`` map
it onto the trunk's and the head's names.

``merge_imported`` loads the result into a module strictly: a name the
module lacks, or a shape that differs, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

# (layer1, layer2, layer3, layer4) blocks of each ResNet depth, as
# models/backbones.py::RESNET_STAGES
from i2vsgg_tpu_torch.models.backbones import RESNET_STAGES

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    """A tensor (or array) as f32 on the CPU; an f32 CPU tensor is returned
    as it is (a memory-mapped one stays mapped)."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def load_torch_checkpoint(path: str) -> StateDict:
    """A ``.pth`` file -> {name: f32 tensor}, with the reference's checkpoint
    wrapper (``{"model": state_dict, ...}``,
    trainval_net_instance_styleD_bilinear.py:421-434) unwrapped and the
    ``module.`` prefix of ``nn.DataParallel`` state dicts stripped. Loaded
    with ``mmap=True, weights_only=True`` (a zip-format file stays mapped;
    an SGG head's fc6 alone is 822 MB in f32); a file in the legacy format
    is read whole."""
    try:
        sd = torch.load(path, map_location="cpu", mmap=True,
                        weights_only=True)
    except RuntimeError as e:
        if "mmap" not in str(e):
            raise
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, Mapping) and "model" in sd:
        sd = sd["model"]
    out: StateDict = {}
    for k, v in sd.items():
        if not torch.is_tensor(v):
            continue
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _t(v)
    return out


def _bn(sd: Mapping, src: str, dst: str) -> StateDict:
    return {f"{dst}.scale": _t(sd[f"{src}.weight"]),
            f"{dst}.bias": _t(sd[f"{src}.bias"]),
            f"{dst}.mean": _t(sd[f"{src}.running_mean"]),
            f"{dst}.var": _t(sd[f"{src}.running_var"])}


def _bottleneck(sd: Mapping, src: str, dst: str,
                has_downsample: bool) -> StateDict:
    out: StateDict = {}
    for i in (1, 2, 3):
        out[f"{dst}.conv{i}.weight"] = _t(sd[f"{src}.conv{i}.weight"])
        out.update(_bn(sd, f"{src}.bn{i}", f"{dst}.bn{i}"))
    if has_downsample:
        out[f"{dst}.downsample_conv.weight"] = _t(
            sd[f"{src}.downsample.0.weight"])
        out.update(_bn(sd, f"{src}.downsample.1", f"{dst}.downsample_bn"))
    return out


def _stage(sd: Mapping, src: str, dst: str, blocks: int) -> StateDict:
    out: StateDict = {}
    for i in range(blocks):
        out.update(_bottleneck(sd, f"{src}.{i}", f"{dst}.block{i}",
                               has_downsample=(i == 0)))
    return out


def _linear(sd: Mapping, src: str, dst: str) -> StateDict:
    return {f"{dst}.weight": _t(sd[f"{src}.weight"]),
            f"{dst}.bias": _t(sd[f"{src}.bias"])}


def _conv(sd: Mapping, src: str, dst: str) -> StateDict:
    out = {f"{dst}.weight": _t(sd[f"{src}.weight"])}
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])
    return out


def prefixed(prefix: str, sd: StateDict) -> StateDict:
    """``sd`` with every name under ``prefix.`` (a submodule's names in its
    parent)."""
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def resnet_trunk_params(sd: Mapping, depth: int = 101) -> StateDict:
    """A torchvision-layout ResNet state dict -> ``ResNetTrunk`` names
    (conv1, bn1, layer1-3)."""
    n1, n2, n3, _ = RESNET_STAGES[depth]
    out = {"conv1.weight": _t(sd["conv1.weight"])}
    out.update(_bn(sd, "bn1", "bn1"))
    for name, n in (("layer1", n1), ("layer2", n2), ("layer3", n3)):
        out.update(_stage(sd, name, name, n))
    return out


def resnet_head_params(sd: Mapping, depth: int = 101) -> StateDict:
    """The same state dict's layer4 -> ``ResNetHead`` names."""
    return _stage(sd, "layer4", "layer4", RESNET_STAGES[depth][3])


# the conv layers' indices in torchvision's vgg16.features
_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def vgg16_trunk_params(sd: Mapping) -> StateDict:
    """A torchvision ``vgg16`` state dict's ``features.N`` -> ``VGG16Trunk``
    names (``conv0``..``conv12``)."""
    out: StateDict = {}
    for i, idx in enumerate(_VGG16_CONVS):
        out.update(_conv(sd, f"features.{idx}", f"conv{i}"))
    return out


def vgg16_head_params(sd: Mapping) -> StateDict:
    """``classifier.0`` / ``classifier.3`` -> ``VGG16Head`` fc6 / fc7, fc6's
    columns from torchvision's CHW flatten to the port's HWC one."""
    out = {"fc6.weight": fc_chw_to_hwc(_t(sd["classifier.0.weight"]),
                                       512, 7, 7),
           "fc6.bias": _t(sd["classifier.0.bias"])}
    out.update(_linear(sd, "classifier.3", "fc7"))
    return out


def jwyang_trunk_params(sd: Mapping, depth: int = 101,
                        prefix: str = "RCNN_base") -> StateDict:
    """``RCNN_base.*`` tensors -> a ``ResNetTrunk`` state dict (conv1, bn1,
    layer1-3)."""
    n1, n2, n3, _ = RESNET_STAGES[depth]
    out = {"conv1.weight": _t(sd[f"{prefix}.0.weight"])}
    out.update(_bn(sd, f"{prefix}.1", "bn1"))
    for dst, idx, n in (("layer1", 4, n1), ("layer2", 5, n2),
                        ("layer3", 6, n3)):
        out.update(_stage(sd, f"{prefix}.{idx}", dst, n))
    return out


def jwyang_detector_params(sd: Mapping, depth: int = 101) -> StateDict:
    """A jwyang/styleD detector state dict -> ``FasterRCNN_DA`` names.
    Parts absent from the checkpoint (e.g. the discriminators of a plain
    jwyang checkpoint) are left out: ``merge_imported`` loads the rest over
    a freshly initialized module."""
    n4 = RESNET_STAGES[depth][3]
    out: StateDict = {}
    if "RCNN_base.0.weight" in sd:
        out.update(prefixed("trunk", jwyang_trunk_params(sd, depth)))
    if "RCNN_top.0.0.conv1.weight" in sd:
        out.update(_stage(sd, "RCNN_top.0", "head.layer4", n4))
    if "RCNN_rpn.RPN_Conv.weight" in sd:
        for src, dst in (("RPN_Conv", "conv"), ("RPN_cls_score", "cls_score"),
                         ("RPN_bbox_pred", "bbox_pred")):
            out.update(_conv(sd, f"RCNN_rpn.{src}", f"rpn.{dst}"))
    for name in ("cls_score", "bbox_pred"):
        if f"RCNN_{name}.weight" in sd:
            out.update(_linear(sd, f"RCNN_{name}", name))
    if "netD_pixel.conv1.weight" in sd:
        for i in (1, 2, 3):
            if f"netD_pixel.conv{i}.weight" in sd:
                out.update(_conv(sd, f"netD_pixel.conv{i}",
                                 f"netD_pixel.conv{i}"))
    if "netD_style.fc_1.weight" in sd:
        for name in ("fc_1", "fc_2", "fc1"):
            out.update(_linear(sd, f"netD_style.{name}",
                               f"netD_style.{name}"))
    return out


def fc_chw_to_hwc(w: torch.Tensor, c: int, h: int, wdt: int) -> torch.Tensor:
    """An FC weight over CHW-flattened pooled features (out, c*h*w) -> the
    same weight over the port's HWC flatten (``_fc_chw_to_hwc`` of the JAX
    module, without its final transpose)."""
    o = w.shape[0]
    return (w.reshape(o, c, h, wdt).permute(0, 2, 3, 1)
            .reshape(o, h * wdt * c).contiguous())


def jwyang_vrd_params(sd: Mapping, fmap_channels: int = 1024,
                      pool: int = 7) -> StateDict:
    """The SGG head's tensors (the ``FC``/``Conv2d`` wrappers of
    resnet_SGG_emb.py: ``fc6.fc.*``, ``conv_lo.{0,1,2}.conv.*``,
    ``prd_sem_embeddings.{0,2}.*``, ...), with or without the ``vrd.``
    prefix of a whole SGG checkpoint -> ``VRDHead`` names (no prefix).
    fc6's columns go from the CHW to the HWC flatten."""
    if "fc6.fc.weight" in sd and "vrd.fc6.fc.weight" not in sd:
        sd = prefixed("vrd", dict(sd))
    out = {"fc6.weight": fc_chw_to_hwc(_t(sd["vrd.fc6.fc.weight"]),
                                       fmap_channels, pool, pool),
           "fc6.bias": _t(sd["vrd.fc6.fc.bias"])}
    for name in ("fc7", "so_vis_embeddings", "fc8", "fc_fusion", "fc_rel"):
        out.update(_linear(sd, f"vrd.{name}.fc", name))
    for name in ("fc_so", "fc_lov"):
        if f"vrd.{name}.fc.weight" in sd:
            out.update(_linear(sd, f"vrd.{name}.fc", name))
    for i in range(3):
        if f"vrd.conv_lo.{i}.conv.weight" in sd:
            out.update(_conv(sd, f"vrd.conv_lo.{i}.conv", f"conv_lo{i}"))
    out.update(_linear(sd, "vrd.prd_sem_embeddings.0",
                       "prd_sem_embeddings.fc0"))
    out.update(_linear(sd, "vrd.prd_sem_embeddings.2",
                       "prd_sem_embeddings.fc1"))
    return out


def jwyang_sgg_params(sd: Mapping, depth: int = 101) -> StateDict:
    """A Stage-B (SGG) jwyang checkpoint -> ``SGGModel`` names (``trunk.*``
    and ``vrd.*``)."""
    out: StateDict = {}
    if "RCNN_base.0.weight" in sd:
        out.update(prefixed("trunk", jwyang_trunk_params(sd, depth)))
    if "vrd.fc6.fc.weight" in sd:
        out.update(prefixed("vrd", jwyang_vrd_params(sd)))
    return out


@torch.no_grad()
def merge_imported(module: nn.Module, imported: Mapping) -> nn.Module:
    """Copy ``imported`` into ``module``'s parameters and buffers, strictly:
    a name the module lacks raises ``KeyError``, a shape that differs
    raises ``ValueError`` (an import bug, unlike the test-time intersection
    load of ``train/checkpoint.py::restore_intersection``). Names the
    checkpoint lacks keep their values. Each tensor is cast to the target's
    dtype. Returns ``module``."""
    target = module.state_dict(keep_vars=True)
    for name, value in imported.items():
        if name not in target:
            raise KeyError(f"imported {name} has no target in "
                           f"{type(module).__name__}")
        got, want = torch.as_tensor(value), target[name]
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {name}: imported "
                             f"{tuple(got.shape)} vs {tuple(want.shape)}")
    for name, value in imported.items():
        target[name].copy_(torch.as_tensor(value))
    return module
