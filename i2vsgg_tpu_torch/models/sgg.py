"""Embedding-based relation (SGG) head — counterpart of
``i2vsgg_tpu/models/sgg.py`` (the ``vrd`` module of
``lib/model/faster_rcnn/resnet_SGG_emb.py:64-264``).

* object + union rois are pooled in ONE call (RoIPool for ``pooling="pool"``,
  the serving default, or RoIAlignAvg for ``"align"``) and share one fc6/fc7
  tower;
* the union embedding (fc8), the object-pair embedding (fc_so, with
  ``use_obj_visual``) and the spatial branch (``spatial_type`` 2: the conv
  tower over the 2x32x32 dual masks; 1: ``fc_lov`` on the 8-d relative
  location; 0: none) are concatenated -> fc_fusion -> fc_rel;
* predicate scores are cosines against the GloVe-MLP predicate embeddings;
  training (Stage B) adds dropout after fc6 and fc7 and the multi-label
  BCE of ``bce_multilabel_loss``.

The serving layout is exact restructuring of the same math, as in the JAX
package: unions are pooled once per unordered pair and fanned out by
``u_map``; conv_lo0 (linear in its two mask channels) runs on 2M+1
per-detection stacks instead of P pair stacks; the tower's stride-2 convs pad
symmetrically (2, 2) like torch's ``same_padding``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from i2vsgg_tpu_torch.models.layers import Conv, Dense
from i2vsgg_tpu_torch.ops.boxes import dual_mask, union_boxes
from i2vsgg_tpu_torch.ops.int8 import int8_linear, row_act_quant, weight_quant
from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
from i2vsgg_tpu_torch.ops.roi_pool import roi_pool


def dense_t(in_features: int, features: int) -> Dense:
    """Dense with torch-default init: uniform(+-1/sqrt(fan_in)) on both the
    weight and the bias (JAX's ``torch_linear_kernel`` /
    ``torch_linear_bias``)."""
    bound = 1.0 / math.sqrt(in_features)
    return Dense(in_features, features, init_bound=bound, bias_bound=bound)


def conv_t(in_features: int, features: int, kernel: int, stride: int = 1,
           padding: int = 0) -> Conv:
    """Conv with torch-default init (fan_in = k*k*in)."""
    bound = 1.0 / math.sqrt(kernel * kernel * in_features)
    return Conv(in_features, features, kernel, stride=stride, padding=padding,
                init_bound=bound, bias_bound=bound)


class DenseInt8(Dense):
    """``Dense`` whose product runs in int8 (JAX ``DenseInt8``): per-output-
    channel symmetric weights — an int8-stored ``weight`` with its
    ``kernel_scale`` (``utils/params.py::quantize_dense_params``), or
    quantized on the fly from a float one — and one dynamic scale per input
    row; the int32 product is rescaled and the bias added in f32. It
    returns f32, whatever the input and weight dtypes."""

    def forward(self, x):
        if self.weight.dtype == torch.int8:
            w_q, w_s = self.weight, self.kernel_scale
        else:
            w_q, w_s = weight_quant(self.weight)
        x_q, a_s = row_act_quant(x)
        y = int8_linear(x_q, w_q)
        return (y.float() * (a_s[:, None] * w_s[None, :])
                + self.bias.float())


def dense_int8_t(in_features: int, features: int) -> DenseInt8:
    """``DenseInt8`` with ``dense_t``'s init."""
    bound = 1.0 / math.sqrt(in_features)
    return DenseInt8(in_features, features, init_bound=bound,
                     bias_bound=bound)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: each unit kept with probability
    ``1 - rate`` (a uniform draw below it, as ``jax.random.bernoulli``) and
    divided by ``1 - rate``, the rest 0. The draw is on ``generator``'s
    device, never on the global random state."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device) < 1.0 - rate
    return torch.where(keep.to(x.device), x / (1.0 - rate),
                       torch.zeros_like(x))


def bce_multilabel_loss(scores: torch.Tensor, labels: torch.Tensor,
                        pair_valid: torch.Tensor) -> torch.Tensor:
    """BCE with logits averaged over the valid pairs' ``P x n_rel``
    elements (the denominator floored at 1), in the ``log_sigmoid`` form of
    JAX's ``bce_multilabel_loss``. [resnet_SGG_emb.py:95;
    faster_rcnn_SGG_emb.py:269]"""
    logp = F.logsigmoid(scores)
    lognp = F.logsigmoid(-scores)
    per_elem = -(labels * logp + (1.0 - labels) * lognp)
    w = pair_valid.to(scores.dtype)[:, None]
    return (per_elem * w).sum() / torch.clamp_min(
        w.sum() * scores.shape[1], 1.0)


class PredicateEmbedder(nn.Module):
    """GloVe 300-d -> emb_dim predicate embeddings.
    [resnet_SGG_emb.py:188-192 prd_sem_embeddings]"""

    def __init__(self, emb_dim: int = 300, in_dim: int = 300):
        super().__init__()
        self.fc0 = dense_t(in_dim, 1024)
        self.fc1 = dense_t(1024, emb_dim)

    def forward(self, prd_vecs):
        return self.fc1(F.leaky_relu(self.fc0(prd_vecs), negative_slope=0.1))


class VRDHead(nn.Module):
    """Relation classification head over pooled features.

    ``in_channels``: the feature map's width (1024 for ResNet, 512 for
    VGG16), so fc6 takes ``in_channels * 49`` inputs. ``spatial_type``: 0
    no spatial branch, 1 ``fc_lov`` on a (P, 8) relative-location feature
    (``ops/boxes.py::relative_loc``), 2 the conv tower over the 2x32x32 dual
    masks. ``use_obj_visual``: the subject/object embedding branch
    (``fc_so``). ``fc_fusion`` takes 256 inputs a branch present. ``int8_fc``
    runs the fc6/fc7 tower as ``DenseInt8`` (same parameter names), whose f32
    output feeds the rest of the head. ``dropout_rate``: the dropout after
    relu(fc6) and after relu(fc7), drawn only in training (``forward(...,
    generator=...)`` on a module in training mode)."""

    pooling_size = 7

    def __init__(self, emb_dim: int = 300, fc_dim: int = 4096,
                 pooling: str = "pool", dtype=torch.float32,
                 int8_fc: bool = False, in_channels: int = 1024,
                 spatial_type: int = 2, use_obj_visual: bool = True,
                 dropout_rate: float = 0.5):
        super().__init__()
        if pooling not in ("pool", "align"):
            raise ValueError(f"pooling must be 'pool' or 'align', not {pooling!r}")
        if spatial_type not in (0, 1, 2):
            raise ValueError(f"spatial_type must be 0, 1 or 2, not "
                             f"{spatial_type!r}")
        self.pooling = pooling
        self.dtype = dtype
        self.int8_fc = int8_fc
        self.dropout_rate = dropout_rate
        self.spatial_type = spatial_type
        self.use_obj_visual = use_obj_visual
        p = self.pooling_size
        fc = dense_int8_t if int8_fc else dense_t
        self.fc6 = fc(in_channels * p * p, fc_dim)
        self.fc7 = fc(fc_dim, fc_dim)
        self.so_vis_embeddings = dense_t(fc_dim, emb_dim)
        self.fc8 = dense_t(fc_dim, 256)
        if use_obj_visual:
            self.fc_so = dense_t(2 * emb_dim, 256)
        if spatial_type == 1:
            self.fc_lov = dense_t(8, 256)
        elif spatial_type == 2:
            self.conv_lo0 = conv_t(2, 96, 5, stride=2, padding=2)
            self.conv_lo1 = conv_t(96, 128, 5, stride=2, padding=2)
            self.conv_lo2 = conv_t(128, 64, 8)
            self.fc_lov = dense_t(64, 256)
        branches = 1 + int(use_obj_visual) + int(spatial_type > 0)
        self.fc_fusion = dense_t(branches * 256, 256)
        self.fc_rel = dense_t(256, emb_dim)
        self.prd_sem_embeddings = PredicateEmbedder(emb_dim)

    def forward(self, fmap, obj_rois, union_rois, ix1, ix2, prd_vecs, *,
                u_map=None, det_masks=None, spatial_fea=None,
                generator: torch.Generator | None = None
                ) -> Dict[str, torch.Tensor]:
        """
        fmap: (1, H, W, C) feature map; obj_rois (M, 5); union_rois (U, 5)
        (U == P unless ``u_map`` (P,) maps pairs to union rows);
        ix1/ix2 (P,) subject/object indices; prd_vecs (n_rel, 300).
        The spatial branch reads ``spatial_fea``: (P, 8) under
        ``spatial_type=1``; under 2, (P, 32, 32, 2) pair masks (NHWC), or
        instead ``det_masks`` (M, 32, 32) per-detection masks (the pair
        masks are built after conv_lo0, exactly).
        ``generator``: with the module in training mode, the dropout after
        fc6 and after fc7 draws its masks from it (``dropout``); without
        one, or in eval mode, no dropout runs (JAX's ``deterministic``).
        Returns {'scores' (P, n_rel) cosines, 'union_emb', 'prd_emb',
        'obj_emb'}.
        """
        p = self.pooling_size
        m = obj_rois.shape[0]
        all_rois = torch.cat([obj_rois, union_rois], dim=0).contiguous()
        if self.pooling == "align":
            # JAX pools an f32 copy of the map; the widening mode is the
            # same function without the copy
            pooled = roi_align_avg(fmap.contiguous(), all_rois, p, p,
                                   1.0 / 16.0, out_dtype=torch.float32)
        else:
            pooled = roi_pool(fmap.contiguous(), all_rois, p, p, 1.0 / 16.0)
        # flattened in NHWC order, as JAX flattens it
        x = pooled.reshape(pooled.shape[0], -1).to(self.dtype)
        drop = generator is not None and self.training
        x = F.relu(self.fc6(x))
        if drop:
            x = dropout(x, self.dropout_rate, generator)
        x = F.relu(self.fc7(x))
        if drop:
            x = dropout(x, self.dropout_rate, generator)

        obj_feat = self.so_vis_embeddings(x[:m])
        x_u = F.relu(self.fc8(x[m:]))
        if u_map is not None:
            x_u = x_u[u_map]                              # fan out to (P, 256)
        feats = [x_u]
        if self.use_obj_visual:
            feats.append(F.relu(self.fc_so(
                torch.cat([obj_feat[ix1], obj_feat[ix2]], 1))))
        if self.spatial_type == 1:
            feats.append(F.relu(self.fc_lov(spatial_fea)))
        elif self.spatial_type == 2:
            feats.append(self._spatial_tower(m, ix1, ix2, det_masks,
                                             spatial_fea))

        x = F.relu(self.fc_fusion(torch.cat(feats, dim=1)))
        vis_emb = self.fc_rel(x)
        prd_emb = self.prd_sem_embeddings(prd_vecs)
        prd_emb = prd_emb / torch.clamp_min(
            torch.linalg.norm(prd_emb, dim=1, keepdim=True), 1e-12)
        vis_n = vis_emb / torch.clamp_min(
            torch.linalg.norm(vis_emb, dim=1, keepdim=True), 1e-12)
        # bf16-stored weights leave vis_n bf16 and prd_emb f32 (its input
        # is f32): the product promotes, as jnp's matmul does
        dt = torch.promote_types(vis_n.dtype, prd_emb.dtype)
        return {"scores": vis_n.to(dt) @ prd_emb.t().to(dt),
                "union_emb": vis_emb,
                "prd_emb": prd_emb, "obj_emb": obj_feat}

    def _spatial_tower(self, m, ix1, ix2, det_masks, spatial_fea):
        """The conv tower over the pair masks -> (P, 256)."""
        if det_masks is not None:
            # conv_lo0 over (mask, 0) / (0, mask) per detection and the
            # all-zero stack: z(i, j) = relu(S[i] + O[j] - Z)
            dm = det_masks.to(self.dtype)[:, None]         # (M, 1, 32, 32)
            zch = torch.zeros_like(dm)
            stacked = torch.cat([torch.cat([dm, zch], 1),
                                 torch.cat([zch, dm], 1),
                                 torch.zeros_like(dm[:1]).repeat(1, 2, 1, 1)],
                                0)
            ab = self.conv_lo0(stacked)                    # (2M+1, 96, 16, 16)
            z = F.relu(ab[ix1] + ab[m + ix2] - ab[2 * m])
        else:
            z = F.relu(self.conv_lo0(
                spatial_fea.to(self.dtype).permute(0, 3, 1, 2)))
        z = F.relu(self.conv_lo1(z))
        z = F.relu(self.conv_lo2(z))
        return F.relu(self.fc_lov(z.reshape(z.shape[0], -1)))


class SGGModel(nn.Module):
    """Relation model on a frozen detector's features.
    Parameter names: ``vrd.*`` and, with a trunk, ``trunk.*``, as in the
    JAX module.

    ``trunk`` (a ``ResNetTrunk`` or ``VGG16Trunk``, optional) is Stage B's
    own backbone, which ``forward`` runs before the head (the evaluation
    driver, ``tools/test_sgg.py``); the fused serving program shares the
    detector's trunk and calls ``head_on_features`` on its map instead.
    Both run under ``no_grad``. Training (``train/sgg.py``) runs the trunk
    with ``frozen_map`` and the head with ``train_head``."""

    def __init__(self, vrd: VRDHead, trunk: nn.Module | None = None):
        super().__init__()
        self.vrd = vrd
        if trunk is not None:
            self.trunk = trunk

    @torch.no_grad()
    def forward(self, images, im_info, obj_boxes, classes, ix1, ix2,
                pair_valid, prd_vecs, *, pair_static=None):
        """Stage B on one frame: the trunk on ``images`` (1, H, W, 3) (the
        preprocessed frame), then ``head_on_features`` on its stride-16 map.
        ``classes`` (M,) is not read by the head (the JAX signature carries
        it). [i2vsgg_tpu/models/sgg.py:266-283]"""
        if not hasattr(self, "trunk"):
            raise ValueError("SGGModel.forward needs the model built with a "
                             "trunk; the serving program calls "
                             "head_on_features on the detector's map")
        base_feat, _ = self.trunk(images)
        return self.head_on_features(base_feat, im_info, obj_boxes, ix1, ix2,
                                     pair_valid, prd_vecs,
                                     pair_static=pair_static)

    @torch.no_grad()
    def frozen_map(self, images) -> torch.Tensor:
        """The trunk's stride-16 map of ``images`` (B, H, W, 3), computed
        without grad: Stage B's frozen detector (JAX's ``stop_gradient``,
        ``i2vsgg_tpu/models/sgg.py:301``). A map that needs no grad sends
        the RoI wrappers straight to their kernels, with no backward."""
        return self.trunk(images)[0]

    def train_head(self, base_feat, im_info, obj_boxes, ix1, ix2, pair_valid,
                   prd_vecs, generator: torch.Generator):
        """The head with grad on one frame's (detached) map, over the
        ordered pairs ``ix1``/``ix2`` (one union roi a pair), with dropout
        drawn from ``generator`` while the module is in training mode (JAX's
        ``deterministic=False``). Padded boxes and pairs are computed and
        left to the loss's mask, as in JAX. An int8 head (``int8_fc``) is
        refused: it is a serving lever, with no VJP in JAX."""
        if self.vrd.int8_fc:
            raise ValueError("an int8 head (int8_fc=True) is serving-only; "
                             "train the float head and quantize it after")
        return self._head(base_feat.detach(), im_info, obj_boxes, ix1, ix2,
                          pair_valid, prd_vecs, generator=generator)

    @torch.no_grad()
    def head_on_features(self, base_feat, im_info, obj_boxes, ix1, ix2,
                         pair_valid, prd_vecs, *, pair_static=None):
        """Relation head on a precomputed (1, H, W, C) feature map.

        ``obj_boxes`` (M, 4) in input-image scale; ``im_info`` (3,);
        ``pair_static``: optional ``(iu1, iu2, u_map)`` from
        ``serve.make_union_dedup`` — union rois are pooled once per
        unordered pair (union boxes are symmetric) and fanned back out.

        The JAX module pools an f32 copy of the feature map. The port takes
        the map as it comes: ``pool`` because a max is one of its inputs, so
        the pooled values are the same in any dtype; ``align`` because
        ``roi_align_avg(..., out_dtype=torch.float32)`` widens each value
        exactly and builds its weights in f32, the function of pooling the
        copy.

        ``spatial_type=1`` raises ``ValueError``: its (P, 8) feature is not
        built here. The JAX method passes no spatial feature and fails
        there too (``i2vsgg_tpu/models/sgg.py:190-193, 329-331``).
        """
        return self._head(base_feat, im_info, obj_boxes, ix1, ix2,
                          pair_valid, prd_vecs, pair_static=pair_static)

    def _head(self, base_feat, im_info, obj_boxes, ix1, ix2, pair_valid,
              prd_vecs, *, pair_static=None, generator=None):
        if self.vrd.spatial_type == 1:
            raise ValueError("head_on_features builds no spatial feature: "
                             "spatial_type=1 needs VRDHead's spatial_fea "
                             "(P, 8), e.g. from ops.boxes.relative_loc")
        m = obj_boxes.shape[0]
        zeros = torch.zeros((m, 1), dtype=obj_boxes.dtype,
                            device=obj_boxes.device)
        obj_rois = torch.cat([zeros, obj_boxes], dim=1)
        u_map = None
        if pair_static is not None:
            iu1, iu2, u_map = (torch.as_tensor(a, dtype=torch.long,
                                               device=obj_boxes.device)
                               for a in pair_static)
            u = union_boxes(obj_boxes[iu1], obj_boxes[iu2], im_info[0],
                            im_info[1], margin=10.0)
        else:
            u = union_boxes(obj_boxes[ix1], obj_boxes[ix2], im_info[0],
                            im_info[1], margin=10.0)
        union_rois = torch.cat([torch.zeros_like(u[:, :1]), u], dim=1)
        det_masks = None
        if self.vrd.spatial_type == 2:
            det_masks = dual_mask(im_info[0], im_info[1],
                                  obj_boxes)                 # (M, 32, 32)
        out = self.vrd(base_feat, obj_rois, union_rois, ix1, ix2, prd_vecs,
                       u_map=u_map, det_masks=det_masks, generator=generator)
        out["pair_valid"] = pair_valid
        return out
