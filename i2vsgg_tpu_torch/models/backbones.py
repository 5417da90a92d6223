"""ResNet and VGG16 trunks and heads — counterpart of
``i2vsgg_tpu/models/backbones.py`` (the serving program's float and int8
paths).

* caffe-convention ``Bottleneck``: the stride sits on the FIRST 1x1 conv;
* every BatchNorm is frozen, i.e. a constant affine (``FrozenBatchNorm``);
* ``ResNetTrunk`` = conv1..layer3 and returns ``(c4, layer2 tap)``;
  ``ResNetHead`` = layer4 + spatial mean;
* ``VGG16Trunk`` = conv1_1..conv5_3 and returns ``(conv5_3, conv4_3 tap)``;
  ``VGG16Head`` = fc6/fc7 over the flattened pooled rois.

Public inputs and outputs are NHWC, as in the JAX package. Inside, tensors
are NCHW views of channels-last memory (``permute`` of an NHWC tensor), which
is the layout cuDNN's NHWC convolutions read and write, so no copy is made at
either end.
"""

from __future__ import annotations

import os
from itertools import chain

import torch
import torch.nn.functional as F
from torch import nn

from i2vsgg_tpu_torch.models.layers import Conv, Dense
from i2vsgg_tpu_torch.ops import conv1 as conv1_ops
from i2vsgg_tpu_torch.ops.bottleneck import (bottleneck_chain,
                                             chain_vmem_bytes,
                                             fold_block_params)
from i2vsgg_tpu_torch.ops.int8 import (dynamic_act_quant, int8_conv2d,
                                       static_act_quant, weight_quant)

RESNET_STAGES = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
    # tiny debug/test variant (full channel widths, one block per stage)
    10: (1, 1, 1, 1),
}


def prepared(module: nn.Module, name: str, sources, build):
    """``build()``, kept on ``module`` under ``name`` until one of the
    ``sources`` tensors changes: its storage (``.to(device)``,
    ``bf16_storage_cast``, a replaced parameter) or its version counter
    (``load_state_dict`` and any in-place edit). The kept entry holds the
    sources' storages, so no later tensor can reuse their addresses while
    it stands. Built without autograd: serving weights, prepared once per
    load rather than once per call."""
    key = tuple((t.data_ptr(), t._version) for t in sources)
    hit = module.__dict__.get(name)
    if hit is not None and hit[0] == key:
        return hit[2]
    with torch.no_grad():
        value = build()
    module.__dict__[name] = (key, [t.detach() for t in sources], value)
    return value


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine params: ``x * mul + add``
    with ``mul = scale * rsqrt(var + eps)``, ``add = bias - mean * mul``,
    both cast to the input dtype (as the JAX module does). NCHW input."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self):
        """The folded ``(mul, add)`` in f32 (the JAX module called with
        ``None``), for kernels that take the affine as parameters."""
        mul = self.scale * torch.rsqrt(self.var + self.eps)
        return mul, self.bias - self.mean * mul

    def forward(self, x):
        mul, add = self.affine()
        return (x * mul.to(x.dtype)[:, None, None]
                + add.to(x.dtype)[:, None, None])


class BNConv(Conv):
    """No-bias conv with padding ``k // 2``, computed in ``dtype``. On tiny
    spatial grids (per-roi head inputs, H*W <= 64) a 1x1 stride-1 conv runs
    as one (R*HW, C) @ (C, F) matmul, as in the JAX module.

    Under ``I2VSGG_INT8_CALIB`` (read at forward time) every call first
    records ``max|x|`` of its input in f32, the running maximum over calls
    (``record_absmax``; ``act_absmax`` reads the records, ``clear_absmax``
    drops them): the JAX module's ``sow`` of ``act_absmax``, which
    ``calibrate_act_scales`` turns into static activation scales.

    The int8 branches of the JAX module, in its order:

    * an int8-stored ``weight`` (``utils/params.py::quantize_trunk_params``)
      with its ``kernel_scale`` runs the int8 conv with a static activation
      scale (buffer ``act_scale``) or a dynamic one; a small-grid 1x1 with
      such a weight is dequantized instead;
    * otherwise ``I2VSGG_INT8_TRUNK`` (read at forward time) = ``1`` or
      ``1:<tok>,..`` quantizes on the fly the convs it selects: a token
      matches as a substring of the joined flax path (``path``, e.g.
      ``trunk/layer3/block0/conv2``, set by ``FasterRCNN_DA``), and ``@3x3``
      keeps 3x3 kernels only.

    The int32 product is rescaled as ``(y * (a_s * w_s)).to(dtype)``. The
    fake-quant twins of both branches (``I2VSGG_INT8_TRUNK=sim[:scope]`` on
    the fly, ``I2VSGG_INT8_PREQ_SIM`` on int8-stored weights, the modes the
    quality gate ``quant_trunk_ab`` runs) take the same integer taps and
    convolve them in f32 instead (``_product``).
    """

    path = ""

    def __init__(self, in_features: int, features: int, kernel: int = 1,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=kernel // 2, bias=False, dtype=dtype)

    def forward(self, x, stride: int | None = None):
        stride = stride or self.stride
        if os.environ.get("I2VSGG_INT8_CALIB"):
            self.record_absmax(x)
        r, c, h, w = x.shape
        k = self.weight.shape[-1]
        small = h * w <= 64 and k == 1 and stride == 1
        if self.weight.dtype == torch.int8:
            return self._int8_forward(x, stride, small)
        if small:
            xm = nchw_to_nhwc(x).reshape(r * h * w, c).to(self.dtype)
            wm = self.weight.reshape(self.weight.shape[0], c).to(self.dtype)
            return nhwc_to_nchw((xm @ wm.t()).reshape(r, h, w, -1))
        mode = int8_trunk_mode(self.path, k)
        if mode in ("1", "sim"):
            w_q, w_s = weight_quant(self.weight)
            x_q, a_s = dynamic_act_quant(x)
            return self._rescale(
                self._product(x_q, w_q, stride, mode == "sim"), a_s, w_s)
        return super().forward(x, stride)

    def record_absmax(self, x):
        """Fold ``max|x|`` (f32, on x's device, no sync) into the record, a
        plain attribute: neither a parameter nor a buffer, so that no
        state dict, checkpoint or weight cache (``prepared``) sees it. abs
        and max are exact in every float type, so taking them before the
        cast to f32 gives JAX's value without an f32 copy of the map."""
        m = x.detach().abs().amax().float()
        prev = self.__dict__.get("act_absmax")
        self.__dict__["act_absmax"] = (m if prev is None
                                       else torch.maximum(prev, m))

    def _int8_forward(self, x, stride: int, small: bool):
        """The hoisted int8 weight (``quantize_trunk_params``)."""
        w_s = self.kernel_scale
        if small:
            # the transform skips small-grid 1x1s; one that slips through
            # is dequantized rather than miscomputed (as in JAX)
            r, c, h, w = x.shape
            wd = (self.weight.float().reshape(-1, c) * w_s[:, None]).to(
                self.dtype)
            xm = nchw_to_nhwc(x).reshape(r * h * w, c).to(self.dtype)
            return nhwc_to_nchw((xm @ wd.t()).reshape(r, h, w, -1))
        a_s = getattr(self, "act_scale", None)
        if a_s is not None:
            x_q = static_act_quant(x, a_s)
        else:
            x_q, a_s = dynamic_act_quant(x)
        sim = bool(os.environ.get("I2VSGG_INT8_PREQ_SIM"))
        return self._rescale(self._product(x_q, self.weight, stride, sim),
                             a_s, w_s)

    def _product(self, x_q, w_q, stride: int, sim: bool):
        """The int32 conv of the int8 taps or, for the fake-quant modes, the
        same taps convolved in f32: equal to it while every partial sum
        stays below 2**24 (127 * 127 * K < 2**24 for K = kh * kw * C_in <=
        1040), rounded above. TF32, which cuDNN may use for f32 convs,
        keeps these taps exact (8 significant bits at most), so it needs no
        switching off; the order of the sums is cuDNN's own."""
        if sim:
            return F.conv2d(x_q.float(), w_q.float(), None, stride,
                            self.padding)
        return int8_conv2d(x_q, w_q, stride, self.padding)

    def _rescale(self, y, a_s, w_s):
        return (y.float() * (a_s * w_s)[:, None, None]).to(self.dtype)


def act_absmax(model: nn.Module) -> dict:
    """The ``I2VSGG_INT8_CALIB`` records of ``model``'s ``BNConv`` modules,
    ``{path: max|x|}`` as Python floats, keyed by each module's name under
    ``model`` with ``/`` for ``.`` (``trunk/layer3/block0/conv2``, the keys
    ``quantize_trunk_params`` looks up): the twin of the JAX tool's
    ``flatten_absmax``. Read to the host in one transfer."""
    recs = [(name.replace(".", "/"), m.__dict__["act_absmax"])
            for name, m in model.named_modules()
            if isinstance(m, BNConv) and "act_absmax" in m.__dict__]
    if not recs:
        return {}
    vals = torch.stack([v for _, v in recs]).cpu().tolist()
    return {path: v for (path, _), v in zip(recs, vals)}


def clear_absmax(model: nn.Module):
    """Drop every ``BNConv`` record of ``model``."""
    for m in model.modules():
        if isinstance(m, BNConv):
            m.__dict__.pop("act_absmax", None)


def int8_trunk_mode(path: str, k: int) -> str:
    """The ``I2VSGG_INT8_TRUNK`` mode for a conv at flax ``path`` with a
    ``k`` x ``k`` kernel: ``""`` (float) unless the switch selects it, as
    the JAX ``BNConv`` reads it. ``<mode>:<tok>,..`` selects the convs whose
    path contains a token (substring of the joined path); ``@3x3`` drops
    every kernel but 3x3."""
    mode, _, only = (os.environ.get("I2VSGG_INT8_TRUNK") or "").partition(":")
    if only:
        toks = [t for t in only.split(",") if t]
        if "@3x3" in toks and k != 3:
            mode = ""
        ptoks = [t for t in toks if not t.startswith("@")]
        if ptoks and not any(t in path for t in ptoks):
            mode = ""
    return mode


class Bottleneck(nn.Module):
    """Caffe-convention bottleneck (stride on the first 1x1 conv)."""

    def __init__(self, planes: int, in_features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.bfloat16):
        super().__init__()
        p = planes
        self.conv1 = BNConv(in_features, p, 1, stride, dtype)
        self.bn1 = FrozenBatchNorm(p)
        self.conv2 = BNConv(p, p, 3, 1, dtype)
        self.bn2 = FrozenBatchNorm(p)
        self.conv3 = BNConv(p, p * 4, 1, 1, dtype)
        self.bn3 = FrozenBatchNorm(p * 4)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = BNConv(in_features, p * 4, 1, stride, dtype)
            self.downsample_bn = FrozenBatchNorm(p * 4)

    def forward(self, x, stride: int | None = None):
        """``stride`` overrides the block's own (the head's first_stride)."""
        out = F.relu(self.bn1(self.conv1(x, stride)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = (self.downsample_bn(self.downsample_conv(x, stride))
                    if self.has_downsample else x)
        return F.relu(out + residual)

    def folded(self):
        """(w1', b1, w3', b3, w2', b2) in f32 for the identity-chain kernel
        (``ops/bottleneck.py::fold_block_params``); stride 1, no
        downsample."""
        assert not self.has_downsample and self.conv1.stride == 1
        return fold_block_params(
            self.conv1.weight, self.bn1.affine(), self.conv2.weight,
            self.bn2.affine(), self.conv3.weight, self.bn3.affine())


class ResNetStage(nn.Module):
    """``blocks`` bottlenecks named ``block0..``; block0 downsamples.

    With ``I2VSGG_PALLAS_BOTTLENECK=1`` (read at forward time, as the JAX
    stage reads it) and a map that passes ``use_fused_chain``, the identity
    tail (blocks 1..) runs as one ``bottleneck_chain`` on the folded
    weights: bf16 with f32 bias and accumulation whatever ``dtype`` is, the
    result cast to ``dtype`` (as the JAX stage does). A tail with int8-stored
    weights is refused there (``folded_tail``), and so is a trainable tail
    with grad enabled: the chain has no backward.
    """

    path = ""

    def __init__(self, in_features: int, planes: int, blocks: int,
                 stride: int, dtype=torch.bfloat16):
        super().__init__()
        self.blocks = blocks
        self.planes = planes
        self.dtype = dtype
        self.block0 = Bottleneck(planes, in_features, stride, True, dtype)
        for i in range(1, blocks):
            setattr(self, f"block{i}", Bottleneck(planes, planes * 4, 1,
                                                  False, dtype))

    def folded_tail(self):
        """The identity tail's folded weights, stacked over blocks 1.., in
        the chain's types: w1 (n, C, M), w3 (n, 9, M, M), w2 (n, M, C) bf16
        (``bf16(f32(w) * mul)``); b1, b3, b2 f32. Folded once per set of
        weights and kept on the stage (``prepared``): a change to any tail
        weight or FrozenBN statistic folds again.

        Raises ``ValueError`` on int8-stored weights: the JAX stage folds
        their raw integer taps without ``kernel_scale``
        (``backbones.py:319-326`` with ``bottleneck_kernel.py:204-221``), a
        chain that computes something else, which the port does not copy."""
        tail = [t for m in self._tail_modules() for t in chain(
            m._parameters.values(), m._buffers.values()) if t is not None]
        if any(t.dtype == torch.int8 for t in tail):
            int8 = [name for name, p in self.named_parameters()
                    if p.dtype == torch.int8 and not name.startswith("block0.")]
            raise ValueError(
                f"stage {self.path or type(self).__name__}: int8-stored "
                f"weights ({', '.join(int8)}) cannot be folded into the "
                "bottleneck chain; serve them with I2VSGG_PALLAS_BOTTLENECK "
                "off")
        return prepared(self, "_folded_tail", tail, self._fold_tail)

    def _tail_modules(self) -> list:
        """The identity tail's submodules (blocks 1..), listed once: the
        weights' cache key walks them on every call."""
        if "_tail_mods" not in self.__dict__:
            self.__dict__["_tail_mods"] = [
                m for i in range(1, self.blocks)
                for m in getattr(self, f"block{i}").modules()]
        return self.__dict__["_tail_mods"]

    def _fold_tail(self):
        bf16, f32 = torch.bfloat16, torch.float32
        w1, b1, w3, b3, w2, b2 = (torch.stack(t) for t in zip(*[
            getattr(self, f"block{i}").folded()
            for i in range(1, self.blocks)]))
        return (w1.to(bf16), b1.to(f32), w3.to(bf16), b3.to(f32),
                w2.to(bf16), b2.to(f32))

    def forward(self, x, first_stride: int | None = None):
        x = self.block0(x, first_stride)
        if self.blocks > 1 and use_fused_chain(x, self.planes):
            if torch.is_grad_enabled() and any(
                    p.requires_grad for m in self._tail_modules()
                    for p in m.parameters(recurse=False)):
                raise ValueError(
                    f"stage {self.path or type(self).__name__}: the "
                    "bottleneck chain is forward-only (no backward in either "
                    "package) and its folded weights are built without "
                    "autograd, so a trainable tail would get no gradient; "
                    "train with I2VSGG_PALLAS_BOTTLENECK off")
            y = bottleneck_chain(
                nchw_to_nhwc(x).to(torch.bfloat16).contiguous(),
                *self.folded_tail())
            return nhwc_to_nchw(y.to(self.dtype))
        for i in range(1, self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


def use_fused_chain(x: torch.Tensor, planes: int) -> bool:
    """The JAX stage's gate (``_use_fused_chain``), copied: the opt-in
    switch, an identity tail of 128-aligned widths, and a map whose TPU
    footprint estimate fits the 15.2 MB budget. ``x`` is the NCHW block0
    output. The gate is part of the function computed (a fused stage rounds
    differently), so the port fuses exactly where the JAX package does."""
    if os.environ.get("I2VSGG_PALLAS_BOTTLENECK") != "1":
        return False
    _, c, h, w = x.shape
    if c != planes * 4 or c % 128 or planes % 128:
        return False
    return chain_vmem_bytes(h, w, c, planes) <= int(15.2e6)


def caffe_maxpool(x: torch.Tensor) -> torch.Tensor:
    """Caffe-convention 3x3/2 maxpool, pad 0, CEIL mode (the reference's
    '# change', resnet_instance_styleD_bilinear.py:228), not torchvision's
    pad 1: the JAX package pads -inf at the END when (dim - 3) is odd, which
    is what ``ceil_mode`` does; out = (dim - 2) // 2 + 1."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


class ResNetTrunk(nn.Module):
    """conv1..layer3 (stride 16) with the layer2 tap.

    ``forward(images NHWC or Conv1Planes)`` -> (c4 (B, H/16, W/16, 1024),
    c3 tap (B, H/8, W/8, 512)), both NHWC.

    conv1 dispatches as the JAX trunk does, reading the environment at
    forward time:

    * a ``Conv1Planes`` input (host-packed parity planes) goes to the
      planes-fed conv1 kernel;
    * ``I2VSGG_PALLAS_CONV1=1`` sends an image batch to the image-fed
      conv1 kernel;
    * otherwise conv1 is the plain 7x7/2 pad-3 conv (cuDNN on the card).
      JAX's ``I2VSGG_S2D=1`` runs this conv as a space-to-depth conv
      (``Conv1S2D``), the same function; the port ignores the switch, as
      the packed form was slower than cuDNN's direct conv on the H100;
    * on the kernel paths ``I2VSGG_CONV1_FUSED_POOL`` (default ``1``)
      selects the stem (conv + BN + ReLU + the caffe pool in the kernel's
      module) over the kernel conv followed by ``caffe_maxpool``.

    The kernel paths compute conv1 in bf16 with f32 accumulation and return
    bf16 values, whatever the trunk's dtype (as the JAX kernels do).
    """

    def __init__(self, depth: int = 101, dtype=torch.bfloat16):
        super().__init__()
        n1, n2, n3, _ = RESNET_STAGES[depth]
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False,
                          dtype=dtype)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResNetStage(64, 64, n1, 1, dtype)
        self.layer2 = ResNetStage(256, 128, n2, 2, dtype)
        self.layer3 = ResNetStage(512, 256, n3, 2, dtype)

    def conv1_weights(self) -> conv1_ops.Conv1Weights:
        """conv1's kernel operands (the K-major bf16 weight, the f32 BN
        affine), prepared once per set of weights and kept on the trunk
        (``prepared``)."""
        return prepared(
            self, "_conv1_weights", [self.conv1.weight, *self.bn1.buffers()],
            lambda: conv1_ops.prepare_conv1(self.conv1.weight,
                                            *self.bn1.affine()))

    def _stem(self, images):
        fused_pool = os.environ.get("I2VSGG_CONV1_FUSED_POOL", "1") == "1"
        if isinstance(images, conv1_ops.Conv1Planes):
            x = conv1_ops.conv1_apply(images.planes, self.conv1_weights(),
                                      (images.h, images.w), fused_pool)
        elif os.environ.get("I2VSGG_PALLAS_CONV1") == "1":
            x = conv1_ops.conv1_apply(images.float().contiguous(),
                                      self.conv1_weights(), None, fused_pool)
        else:
            x = nhwc_to_nchw(images.to(self.dtype))
            return caffe_maxpool(F.relu(self.bn1(self.conv1(x))))
        x = nhwc_to_nchw(x.to(self.dtype))
        return x if fused_pool else caffe_maxpool(x)

    def forward(self, images):
        x = self.layer1(self._stem(images))
        tap = self.layer2(x)
        x = self.layer3(tap)
        return nchw_to_nhwc(x), nchw_to_nhwc(tap)


class ResNetHead(nn.Module):
    """layer4 over pooled roi features + global spatial mean -> (R, 2048).

    ``first_stride=1`` is the fused serving layout: the caller pooled only
    the 4x4 subgrid a stride-2 block0 would sample. Params do not depend on
    the stride, so one checkpoint serves both.
    """

    def __init__(self, depth: int = 101, dtype=torch.bfloat16):
        super().__init__()
        _, _, _, n4 = RESNET_STAGES[depth]
        self.dtype = dtype
        self.layer4 = ResNetStage(1024, 512, n4, 2, dtype)

    def forward(self, x, first_stride: int = 2):
        x = self.layer4(nhwc_to_nchw(x.to(self.dtype)), first_stride)
        return x.mean(dim=(2, 3))


class VGG16Trunk(nn.Module):
    """VGG16 conv1_1..conv5_3 (``conv0`` .. ``conv12``: 3x3, bias, ReLU),
    a 2x2/2 max pool (floor) after each of the first four blocks and none
    after the fifth, so the map is at stride 16 — the ``vgg16.yml``
    backbone.

    ``forward(images NHWC)`` -> (conv5_3 (B, H/16, W/16, 512), conv4_3 tap
    (B, H/8, W/8, 512), taken before the fourth pool), both NHWC. The pools
    floor: 600 rows give a 37-row map. Images only: the conv1 kernels'
    ``Conv1Planes`` belong to the ResNet stem.
    """

    CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512)

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin, i = 3, 0
        for v in self.CFG:
            if v != "M":
                setattr(self, f"conv{i}", Conv(cin, v, 3, padding=1,
                                               dtype=dtype))
                cin, i = v, i + 1

    def forward(self, images):
        if isinstance(images, conv1_ops.Conv1Planes):
            raise TypeError("VGG16Trunk takes an image batch: Conv1Planes "
                            "feed the ResNet stem's conv1 kernel only")
        x = nhwc_to_nchw(images.to(self.dtype))
        tap, i, pools = None, 0, 0
        for v in self.CFG:
            if v == "M":
                if pools == 3:
                    tap = x
                x = F.max_pool2d(x, 2, 2)
                pools += 1
            else:
                x = F.relu(getattr(self, f"conv{i}")(x))
                i += 1
        return nchw_to_nhwc(x), nchw_to_nhwc(tap)


class VGG16Head(nn.Module):
    """fc6/fc7 (ReLU) over the pooled rois (R, P, P, C) flattened in NHWC
    order -> (R, 4096). Dropout (rate ``dropout_rate``, after each ReLU) runs
    in training only, when a ``generator`` is passed: flax's
    ``nn.Dropout`` (keep with probability 1 - rate, scale the kept by
    1 / (1 - rate)) drawn from it."""

    dropout_rate = 0.5

    def __init__(self, in_features: int = 7 * 7 * 512,
                 dtype=torch.bfloat16):
        super().__init__()
        self.fc6 = Dense(in_features, 4096, dtype=dtype)
        self.fc7 = Dense(4096, 4096, dtype=dtype)

    def _dropout(self, x, generator):
        rate = self.dropout_rate
        if generator is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def forward(self, x, generator: torch.Generator | None = None):
        x = F.relu(self.fc6(x.reshape(x.shape[0], -1)))
        x = F.relu(self.fc7(self._dropout(x, generator)))
        return self._dropout(x, generator)
