"""The port's detector and head variants against the JAX package on the CPU:
the VGG16 family, the non-fused detector path (``POOLING_MODE=pool``, a
``POOLING_SIZE`` other than 7), class-agnostic boxes, ``decode_detections``'
``class_agnostic``/``score_thresh``, and ``VRDHead``'s ``spatial_type`` and
``use_obj_visual`` — at the tiny config of test_torch_models.py (64x80
frames, 4 classes, ``max_det`` 4), f32 on both sides, ic+gc context.

The JAX parameters are initialised once per detector, carried across with
``params_from_jax`` (strict loads: the VGG16 trees' conv biases and
25088-wide fc6, ``netD_pixel/conv3`` where the tree has it, a 4-wide
``bbox_pred``), and the same inputs, made from a numpy seed, go through both.
Tolerances: rtol 1e-5 with an atol of 1e-5 of the reference's largest
magnitude (``close``); proposal validity, classes, detection validity and
NMS keep sets exact, unless a test states otherwise.
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from i2vsgg_tpu import serve as jax_serve
from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.models import backbones as jax_bb
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.models.sgg import SGGModel as JaxSGGModel
from i2vsgg_tpu.models.sgg import VRDHead as JaxVRDHead
from i2vsgg_tpu.ops import boxes as jax_boxes
from i2vsgg_tpu_torch import config as port_config
from i2vsgg_tpu_torch import serve
from i2vsgg_tpu_torch.models import backbones as bb
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.layers import Conv, init_weights
from i2vsgg_tpu_torch.models.rpn import Proposals
from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
from i2vsgg_tpu_torch.ops import boxes
from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
from i2vsgg_tpu_torch.ops.roi_pool import roi_pool
from i2vsgg_tpu_torch.utils.weights import params_from_jax

N_CLASSES, N_REL, MD = 4, 5, 4
B, H, W = 2, 64, 80
JAX_CFG = JaxConfig().replace(
    TEST=JaxConfig().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                    RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="float32")
CFG = port_config.Config().replace(
    TEST=port_config.TestConfig(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="float32")

# the detectors under test: backbone, pooling mode and size, class-agnostic
DETECTORS = {
    "vgg16": ("vgg16", "align", 7, True),        # cfgs/vgg16.yml, --cag
    "res10_pool": ("res10", "pool", 7, False),
    "res10_align5": ("res10", "align", 5, False),
    "res10_pool_cag": ("res10", "pool", 7, True),
    "res10_fused_cag": ("res10", "align", 7, True),
    "res10_fused": ("res10", "align", 7, False),
}
# the SGG head served with each: in_channels, pooling, spatial_type,
# use_obj_visual (chip_smoke.py phase 12a and 12b)
SGG_HEADS = {"vgg16": (512, "pool", 2, True),
             "res10_pool": (1024, "align", 0, False)}


def T(a):
    return torch.as_tensor(np.array(a))


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def close(got, exp, rtol=1e-5, atol=1e-5):
    """allclose with ``atol`` relative to the reference's largest magnitude:
    f32 sums taken in another order differ by a fraction of the summed
    magnitude, which an element near zero cannot meet in relative terms."""
    exp = np.asarray(exp)
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(got.detach().float().numpy(), exp, rtol=rtol,
                               atol=atol * max(scale, 1.0))


def cfgs(mode: str, size: int):
    return (JAX_CFG.replace(POOLING_MODE=mode, POOLING_SIZE=size),
            CFG.replace(POOLING_MODE=mode, POOLING_SIZE=size))


def make_inputs(seed: int):
    rs = np.random.RandomState(seed)
    images = (rs.randn(B, H, W, 3) * 10).astype(np.float32)
    im_info = np.tile([[H, W, 1.0]], (B, 1)).astype(np.float32)
    return images, im_info, rs.randn(N_REL, 300).astype(np.float32)


def build_detector(name: str, images, im_info):
    """The JAX detector ``name`` initialised from a fixed key, and the port's
    with the same weights. The RPN and class logits are scaled up so that
    scores spread out and no top-k or NMS decision sits on a float
    near-tie; VGG16's convs get the ReLU gain (x sqrt 2) so that the map
    does not fade over its thirteen layers."""
    backbone, mode, size, cag = DETECTORS[name]
    jcfg, cfg = cfgs(mode, size)
    det = JaxFasterRCNN(num_classes=N_CLASSES, cfg=jcfg, backbone=backbone,
                        class_agnostic=cag, ic=True, gc=True)
    params = np_tree(det.init({"params": jax.random.PRNGKey(0)},
                              jnp.asarray(images[:1]),
                              jnp.asarray(im_info[:1]),
                              mode="inference")["params"])
    params["rpn"]["cls_score"]["kernel"] *= 40.0
    params["cls_score"]["kernel"] *= 40.0
    if backbone == "vgg16":
        for conv in params["trunk"].values():
            conv["kernel"] *= math.sqrt(2.0)
    det_t = FasterRCNN_DA(N_CLASSES, cfg, backbone, class_agnostic=cag,
                          ic=True, gc=True)
    det_t.load_state_dict(params_from_jax(params))
    return dict(det=det, params=params, det_t=det_t.eval(), jcfg=jcfg,
                cfg=cfg)


def build_sgg(name: str, prd):
    """The JAX and port SGG heads served with detector ``name``."""
    c, pooling, spatial, obj_visual = SGG_HEADS[name]
    trunk = (jax_bb.VGG16Trunk(dtype=jnp.float32) if c == 512
             else jax_bb.ResNetTrunk(depth=10, dtype=jnp.float32))
    sgg = JaxSGGModel(trunk=trunk, vrd=JaxVRDHead(
        emb_dim=16, fc_dim=32, pooling=pooling, spatial_type=spatial,
        use_obj_visual=obj_visual), n_rel=N_REL)
    ix = jnp.zeros((MD * (MD - 1),), jnp.int32)
    params = np_tree(sgg.init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, H // 16, W // 16, c)), jnp.asarray([H, W, 1.0]),
        jnp.zeros((MD, 4)), ix, ix, jnp.zeros(ix.shape, bool),
        jnp.asarray(prd), method=JaxSGGModel.head_on_features)["params"])
    sgg_t = SGGModel(VRDHead(emb_dim=16, fc_dim=32, pooling=pooling,
                             in_channels=c, spatial_type=spatial,
                             use_obj_visual=obj_visual))
    sgg_t.load_state_dict(params_from_jax(params))
    return sgg, params, sgg_t.eval()


class Zoo:
    """Detectors and SGG heads built on first use and kept for the module
    (VGG16's two 25088x4096 fc6 are built once)."""

    def __init__(self):
        self.images, self.im_info, self.prd = make_inputs(0)
        self._det, self._sgg = {}, {}

    def det(self, name):
        if name not in self._det:
            self._det[name] = build_detector(name, self.images, self.im_info)
        return self._det[name]

    def jax_out(self, name):
        d = self.det(name)
        if "jax_out" not in d:
            d["jax_out"] = jax.tree_util.tree_map(np.asarray, d["det"].apply(
                {"params": d["params"]}, jnp.asarray(self.images),
                jnp.asarray(self.im_info), mode="inference"))
        return d["jax_out"]

    def sgg(self, name):
        if name not in self._sgg:
            self._sgg[name] = build_sgg(name, self.prd)
        return self._sgg[name]


@pytest.fixture(scope="module")
def zoo():
    return Zoo()


# ---------------------------------------------------------------- boxes --

def test_relative_loc_matches_jax_and_pinned_values(rng):
    # tests/test_boxes.py::test_relative_loc's pinned case
    a = np.array([10.0, 20.0, 30.0, 60.0], np.float32)
    b = np.array([20.0, 10.0, 60.0, 30.0], np.float32)
    sw, sh, ow, oh = 20.0, 40.0, 40.0, 20.0
    pinned = np.hstack([
        [(10 - 20) / ow, (20 - 10) / oh, (20 - 10) / sw, (10 - 20) / sh],
        np.log([sw / ow, sh / oh, ow / sw, oh / sh])])
    close(boxes.relative_loc(T(a), T(b)), pinned)
    # random boxes with a leading batch dim
    lo = rng.rand(2, 12, 2).astype(np.float32) * 500
    sz = rng.rand(2, 12, 2).astype(np.float32) * 300 + 5
    a = np.concatenate([lo, lo + sz], -1)
    b = a[:, ::-1].copy()
    exp = jax_boxes.relative_loc(jnp.asarray(a), jnp.asarray(b))
    got = boxes.relative_loc(T(a), T(b))
    assert tuple(got.shape) == (2, 12, 8)
    close(got, exp)


# ---------------------------------------------------------------- VGG16 --

def test_vgg16_trunk_and_head_match_jax(zoo, rng):
    """The map (stride 16, floor pools) and the conv4_3 tap, and the
    fc6/fc7 head on pooled rois flattened in NHWC order."""
    p = zoo.det("vgg16")["params"]
    det_t = zoo.det("vgg16")["det_t"]
    fmap, tap = jax_bb.VGG16Trunk(dtype=jnp.float32).apply(
        {"params": p["trunk"]}, jnp.asarray(zoo.images))
    fmap_t, tap_t = det_t.trunk(T(zoo.images))
    assert tuple(fmap_t.shape) == (B, 4, 5, 512)
    assert tuple(tap_t.shape) == (B, 8, 10, 512)
    close(fmap_t, fmap)
    close(tap_t, tap)
    x = rng.randn(6, 7, 7, 512).astype(np.float32)
    exp = jax_bb.VGG16Head(dtype=jnp.float32).apply(
        {"params": p["head"]}, jnp.asarray(x))
    got = det_t.head(T(x))
    assert tuple(got.shape) == (6, 4096)
    close(got, exp)


def test_vgg16_trunk_floors_odd_maps_and_refuses_planes():
    """600 rows pool to 37 (600 -> 300 -> 150 -> 75 -> 37): the map keeps
    its own size. Conv1Planes are the ResNet stem's input only."""
    trunk = init_weights(bb.VGG16Trunk(dtype=torch.float32),
                         torch.Generator().manual_seed(0))
    with torch.no_grad():
        fmap, tap = trunk(torch.zeros(1, 600, 40, 3))
    assert tuple(fmap.shape) == (1, 37, 2, 512)
    assert tuple(tap.shape) == (1, 75, 5, 512)
    planes = Conv1Planes.pack(np.zeros((1, 64, 80, 3), np.float32))
    with pytest.raises(TypeError, match="Conv1Planes"):
        trunk(planes)


def test_params_from_jax_carries_vgg16_trees(zoo):
    """The conv biases and the 25088-wide fc6 of the detector head and of
    the SGG head map leaf by leaf, and load strictly."""
    p = zoo.det("vgg16")["params"]
    sd = params_from_jax(p)
    k = p["trunk"]["conv12"]["kernel"]                         # HWIO
    np.testing.assert_array_equal(
        sd["trunk.conv12.weight"].numpy()[7, 5, 2, 0], k[2, 0, 5, 7])
    np.testing.assert_array_equal(sd["trunk.conv0.bias"].numpy(),
                                  p["trunk"]["conv0"]["bias"])
    fc6 = p["head"]["fc6"]["kernel"]                           # (25088, 4096)
    assert tuple(sd["head.fc6.weight"].shape) == (4096, 25088)
    np.testing.assert_array_equal(sd["head.fc6.weight"].numpy()[9, 25000],
                                  fc6[25000, 9])
    assert "netD_pixel.conv3.weight" in sd
    assert tuple(sd["bbox_pred.weight"].shape) == (4, 4096 + 512 + 128)
    _, sgg_params, sgg_t = zoo.sgg("vgg16")
    sd = params_from_jax(sgg_params)
    assert tuple(sd["vrd.fc6.weight"].shape) == (32, 7 * 7 * 512)
    np.testing.assert_array_equal(sd["vrd.fc6.weight"].numpy(),
                                  sgg_params["vrd"]["fc6"]["kernel"].T)
    sgg_t.load_state_dict(sd)                                  # strict


# ----------------------------------------------------- detector variants --

def end_to_end_tol(name: str) -> float:
    """rtol (and atol, of the largest magnitude) for a whole detector run
    against JAX's. The trunks' f32 sums run in another order on each side
    (oneDNN, XLA:CPU); the RPN's box deltas times anchors of up to 368 px
    turn the map's relative differences into roi coordinates, and the x40
    class logits turn them into probabilities: 1e-4 (as
    test_torch_models.py holds the ResNet path), and 1e-3 for VGG16, whose
    thirteen 3x3 convs before the RPN compound them. Each stage fed JAX's
    own input is held to 1e-5."""
    return 1e-3 if DETECTORS[name][0] == "vgg16" else 1e-4


def jax_heads(det, params, base_feat, tap, rois):
    """The JAX module's non-fused inference past the proposals
    (``faster_rcnn.py:316-322``), on the given map, tap and rois."""
    def run(m, f, t, r):
        b, n = r.shape[:2]
        pooled = m._pool(f, r.reshape(b * n, 5))
        feat_instance = m.netD_pixel(pooled, 0.0)[1] if m.ic else None
        feat_image = m.netD_style(t, 0.0)[1] if m.gc else None
        cls_score, bbox_pred = m._classify(pooled, feat_image, feat_instance)
        return (jax.nn.softmax(cls_score, -1).reshape(b, n, -1),
                bbox_pred.reshape(b, n, -1), pooled)
    return det.apply({"params": params}, jnp.asarray(base_feat),
                     jnp.asarray(tap), jnp.asarray(rois), method=run)


@pytest.mark.parametrize("name", ["res10_pool", "res10_align5", "vgg16"])
def test_nonfused_inference_matches_jax(zoo, name):
    """The non-fused path (full-grid RoIAlignAvg or grouped RoIPool, the
    stride-2 layer4 or VGG16's fc6/fc7, netD_pixel's full pass). End to
    end: the same proposals, the rest to ``end_to_end_tol``. Past the
    proposals, fed JAX's map, tap and rois: the pooled rois exact under
    RoIPool (a max is one of its inputs), the rest to rtol 1e-5, save the
    probabilities: their logits are scaled x40, and so are the head's f32
    sum-order differences, so they are held to rtol 1e-4."""
    d = zoo.det(name)
    assert not d["det_t"].fused
    exp = zoo.jax_out(name)
    before = (roi_pool.launches, roi_align_avg.launches)
    got = d["det_t"].inference(T(zoo.images), T(zoo.im_info))
    assert (roi_pool.launches, roi_align_avg.launches) == before   # CPU: plain
    np.testing.assert_array_equal(got["roi_valid"].numpy(), exp["roi_valid"])
    assert got["roi_valid"].all()
    tol = end_to_end_tol(name)
    for k in ("base_feat", "rois", "cls_prob", "bbox_pred"):
        close(got[k], exp[k], tol, tol)

    tap = d["det"].apply({"params": d["params"]}, jnp.asarray(zoo.images),
                         method=lambda m, x: m.trunk(x)[1])
    prob, deltas, pooled = jax_heads(d["det"], d["params"], exp["base_feat"],
                                     tap, exp["rois"])
    fed = d["det_t"].detect_on_features(
        T(exp["base_feat"]), T(tap), T(zoo.im_info),
        Proposals(T(exp["rois"]), T(exp["roi_valid"])))
    close(fed["cls_prob"], prob, 1e-4)
    close(fed["bbox_pred"], deltas)
    got_pooled = d["det_t"].pool(T(exp["base_feat"]),
                                 T(exp["rois"].reshape(-1, 5)))
    if DETECTORS[name][1] == "pool":
        np.testing.assert_array_equal(got_pooled.numpy(), np.asarray(pooled))
    else:
        close(got_pooled, pooled)


def test_port_nonfused_align7_layout_matches_fused(zoo):
    """The port's fused align path (4x4 subgrid, stride-1 block0, netD conv1
    on the map) against its own non-fused layout on the same weights (full
    7x7 grid, stride-2 block0, netD_pixel's full pass; conv3, which only the
    latter evaluates, seeded), as
    tests/test_faster_rcnn.py::test_fused_inference_matches_reference_path
    holds the JAX module's two layouts: rtol 1e-5."""
    fused = zoo.det("res10_fused")["det_t"]
    plain = copy.deepcopy(fused)
    plain.fused = False
    plain.netD_pixel.conv3 = init_weights(
        Conv(128, 1, 1, bias=False, init_std=0.01),
        torch.Generator().manual_seed(5))
    x, info = T(zoo.images), T(zoo.im_info)
    a, b = fused.inference(x, info), plain.inference(x, info)
    np.testing.assert_array_equal(a["rois"].numpy(), b["rois"].numpy())
    close(a["cls_prob"], b["cls_prob"].numpy())
    close(a["bbox_pred"], b["bbox_pred"].numpy())


@pytest.mark.parametrize("name", ["res10_fused_cag", "res10_pool_cag"])
def test_class_agnostic_inference_matches_jax(zoo, name):
    d = zoo.det(name)
    assert d["det_t"].fused == (name == "res10_fused_cag")
    exp = zoo.jax_out(name)
    got = d["det_t"].inference(T(zoo.images), T(zoo.im_info))
    assert tuple(got["bbox_pred"].shape) == (B, 16, 4)
    np.testing.assert_array_equal(got["roi_valid"].numpy(), exp["roi_valid"])
    tol = end_to_end_tol(name)
    for k in ("rois", "cls_prob", "bbox_pred"):
        close(got[k], exp[k], tol, tol)


def test_detector_refuses_what_jax_does_not_build():
    for backbone in ("vgg19", "res18", "resnet"):
        with pytest.raises(ValueError, match="backbone"):
            FasterRCNN_DA(N_CLASSES, CFG, backbone)
    with pytest.raises(ValueError, match="POOLING_MODE"):
        FasterRCNN_DA(N_CLASSES, CFG.replace(POOLING_MODE="crop"), "res10")


def test_netd_pixel_conv3_only_where_the_jax_tree_has_it(zoo):
    """Strict state dicts: the fused tree has no netD_pixel/conv3, the
    non-fused one has it."""
    assert "netD_pixel.conv3.weight" not in zoo.det("res10_fused")["params"] \
        and "conv3" not in zoo.det("res10_fused")["params"]["netD_pixel"]
    assert "conv3" in zoo.det("res10_pool")["params"]["netD_pixel"]
    fused = dict(zoo.det("res10_fused")["det_t"].state_dict())
    assert not any(k.startswith("netD_pixel.conv3") for k in fused)
    assert "netD_pixel.conv3.weight" in zoo.det("res10_pool")["det_t"
                                                            ].state_dict()


# ---------------------------------------------------------------- decode --

def _decode_inputs(seed: int, k: int):
    rs = np.random.RandomState(seed)
    n, c = 24, N_CLASSES + 1
    lo = rs.rand(B, n, 2).astype(np.float32) * np.float32([W - 20, H - 20])
    sz = rs.rand(B, n, 2).astype(np.float32) * 30 + 4
    rois = np.concatenate([np.repeat(np.arange(B, dtype=np.float32), n
                                     ).reshape(B, n, 1), lo, lo + sz], -1)
    valid = rs.rand(B, n) > 0.1
    logits = rs.randn(B, n, c).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = (rs.randn(B, n, 4 * k) * 0.5).astype(np.float32)
    info = np.asarray([[H, W, 1.0], [H, W, 1.6]], np.float32)
    return rois, valid, prob.astype(np.float32), deltas, info


@pytest.mark.parametrize("bbox_reg,agnostic,width,thresh", [
    (True, False, "4C", 0.0), (True, False, "4C", 0.3),
    (True, True, "4C", 0.0), (True, True, "4C", 0.3),
    (True, True, "4", 0.0), (True, True, "4", 0.3),
    (True, False, "4", 0.0),           # JAX's clamped gather: column 0
    (False, False, "4C", 0.0), (False, True, "4", 0.3)])
def test_decode_detections_matches_jax(bbox_reg, agnostic, width, thresh):
    """Keep sets exact (classes, validity), boxes and scores to 1e-5."""
    c = N_CLASSES + 1
    rois, valid, prob, deltas, info = _decode_inputs(
        3, c if width == "4C" else 1)
    jcfg = JAX_CFG.replace(TEST=JAX_CFG.TEST.__class__(
        RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16, BBOX_REG=bbox_reg))
    cfg = CFG.replace(TEST=port_config.TestConfig(
        RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16, BBOX_REG=bbox_reg))
    kw = dict(max_det=12, max_per_class=6, score_thresh=thresh)
    exp = jax_serve.decode_detections(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(prob),
        jnp.asarray(deltas), jnp.asarray(info), jcfg,
        class_agnostic=agnostic, **kw)
    got = serve.decode_detections(T(rois), T(valid), T(prob), T(deltas),
                                  T(info), cfg, class_agnostic=agnostic, **kw)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(exp.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(exp.valid))
    close(got.boxes, exp.boxes)
    close(got.scores, exp.scores)
    assert got.valid.sum() >= 8
    if thresh > 0:
        assert bool((got.scores[got.valid] > thresh).all())


def test_decode_detections_refuses_other_widths():
    rois, valid, prob, deltas, info = _decode_inputs(3, 2)
    with pytest.raises(ValueError, match="bbox_pred width"):
        serve.decode_detections(T(rois), T(valid), T(prob), T(deltas),
                                T(info), CFG, max_det=4, max_per_class=4)


# ------------------------------------------------------------ VRD heads --

VRD_CASES = {          # spatial_type, use_obj_visual, spatial input
    "st0": (0, True, None),
    "st0_no_obj_visual": (0, False, None),
    "st1_relative_loc": (1, True, "loc"),
    "st2_det_masks": (2, True, "det_masks"),
    "st2_pair_masks": (2, True, "pair_masks"),
    "st2_no_obj_visual": (2, False, "det_masks"),
}


@pytest.mark.parametrize("case", list(VRD_CASES))
def test_vrd_head_matches_jax(case, rng):
    """``VRDHead`` against JAX's ``VRDHead.__call__`` on a 512-channel map
    (fc6 in_channels * 49) with unions deduplicated by ``u_map``: scores
    and embeddings to rtol 1e-5. spatial_type 1 reads an explicit
    ``relative_loc`` feature; 2 the per-detection masks or the (P, 32, 32,
    2) pair masks."""
    spatial, obj_visual, feed = VRD_CASES[case]
    m, c = 5, 512
    ix1, ix2 = jax_serve.make_pair_indices(m)
    iu1, iu2, u_map = jax_serve.make_union_dedup(ix1, ix2)
    fmap = rng.randn(1, 6, 8, c).astype(np.float32)
    lo = rng.rand(m, 2).astype(np.float32) * 60
    det = np.concatenate([lo, lo + rng.rand(m, 2).astype(np.float32) * 60
                          + 8], 1)
    obj_rois = np.concatenate([np.zeros((m, 1), np.float32), det], 1)
    u = np.concatenate([np.minimum(det[iu1, :2], det[iu2, :2]),
                        np.maximum(det[iu1, 2:], det[iu2, 2:])], 1)
    union_rois = np.concatenate([np.zeros((len(u), 1), np.float32), u], 1)
    prd = rng.randn(N_REL, 300).astype(np.float32)
    det_masks = np.asarray(jax_boxes.dual_mask(96.0, 128.0, jnp.asarray(det)))
    spatial_fea = det_masks_kw = None
    if feed == "loc":
        spatial_fea = np.asarray(jax_boxes.relative_loc(
            jnp.asarray(det[ix1]), jnp.asarray(det[ix2])))
    elif feed == "pair_masks":
        spatial_fea = np.stack([det_masks[ix1], det_masks[ix2]], -1)
    elif feed == "det_masks":
        det_masks_kw = det_masks
    head = JaxVRDHead(emb_dim=16, fc_dim=32, spatial_type=spatial,
                      use_obj_visual=obj_visual)
    args = (jnp.asarray(fmap), jnp.asarray(obj_rois), jnp.asarray(union_rois),
            None if spatial_fea is None else jnp.asarray(spatial_fea),
            jnp.asarray(ix1), jnp.asarray(ix2), jnp.asarray(prd))
    kw = dict(u_map=jnp.asarray(u_map),
              det_masks=None if det_masks_kw is None
              else jnp.asarray(det_masks_kw))
    params = np_tree(head.init({"params": jax.random.PRNGKey(2)}, *args,
                               **kw)["params"])
    exp = head.apply({"params": params}, *args, **kw)
    port = VRDHead(emb_dim=16, fc_dim=32, in_channels=c, spatial_type=spatial,
                   use_obj_visual=obj_visual)
    port.load_state_dict(params_from_jax(params))
    assert ("fc_so.weight" in port.state_dict()) == obj_visual
    with torch.no_grad():
        got = port(T(fmap), T(obj_rois), T(union_rois), T(ix1).long(),
                   T(ix2).long(), T(prd), u_map=T(u_map).long(),
                   det_masks=None if det_masks_kw is None else T(det_masks_kw),
                   spatial_fea=None if spatial_fea is None else T(spatial_fea))
    for k in ("scores", "union_emb", "obj_emb", "prd_emb"):
        close(got[k], exp[k])


def test_head_on_features_refuses_spatial_type_1():
    """The JAX method passes no spatial feature, so spatial_type 1 fails
    there; the port says why."""
    sgg = JaxSGGModel(trunk=jax_bb.VGG16Trunk(dtype=jnp.float32),
                      vrd=JaxVRDHead(emb_dim=16, fc_dim=32, spatial_type=1),
                      n_rel=N_REL)
    ix = jnp.zeros((MD * (MD - 1),), jnp.int32)
    args = (jnp.zeros((1, 4, 5, 512)), jnp.asarray([H, W, 1.0]),
            jnp.zeros((MD, 4)), ix, ix, jnp.zeros(ix.shape, bool),
            jnp.zeros((N_REL, 300)))
    with pytest.raises(AttributeError):
        sgg.init({"params": jax.random.PRNGKey(1)}, *args,
                 method=JaxSGGModel.head_on_features)
    port = SGGModel(VRDHead(emb_dim=16, fc_dim=32, in_channels=512,
                            spatial_type=1))
    with pytest.raises(ValueError, match="spatial_type=1"):
        port.head_on_features(*(T(a) for a in args))
    with pytest.raises(ValueError, match="spatial_type"):
        VRDHead(spatial_type=3)


# -------------------------------------------------------------- programs --

def _held(got, exp, name, bucketed=False):
    """A program's output against JAX's: masks, classes and pairs exact,
    boxes, scores and relation probabilities to ``end_to_end_tol``."""
    for k in ("det_valid", "classes", "pair_valid", "ix1", "ix2"):
        np.testing.assert_array_equal(got[k].numpy(), exp[k])
    assert got["det_valid"].any() and got["pair_valid"].any()
    if bucketed:
        assert got["bucket"] == int(exp["bucket"])
    tol = end_to_end_tol(name)
    for k in ("boxes", "scores", "rel_prob"):
        close(got[k], exp[k], tol, tol)
    np.testing.assert_allclose(got["rel_prob"].sum(-1).numpy(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["vgg16", "res10_pool"])
def test_frame_program_matches_jax(zoo, name):
    """The whole frame program: VGG16 (class-agnostic, ic+gc, align/7) with
    the SGG head on RoIPool over 512 channels; ResNet under
    ``POOLING_MODE=pool`` with the head under align, spatial_type 0, no
    object visual branch."""
    d = zoo.det(name)
    sgg, sgg_params, sgg_t = zoo.sgg(name)
    jax_prog = jax_serve.make_frame_program(
        d["det"], d["params"], sgg, sgg_params, zoo.prd, d["jcfg"],
        max_det=MD, max_per_class=4)
    exp = jax.tree_util.tree_map(np.asarray, jax_prog(
        jnp.asarray(zoo.images), jnp.asarray(zoo.im_info)))
    prog = serve.make_frame_program(d["det_t"], sgg_t, zoo.prd, d["cfg"],
                                    max_det=MD, max_per_class=4, device="cpu")
    _held(prog(zoo.images, zoo.im_info), exp, name)


@pytest.mark.parametrize("name", ["vgg16", "res10_pool"])
def test_bucketed_program_matches_jax(zoo, name):
    d = zoo.det(name)
    sgg, sgg_params, sgg_t = zoo.sgg(name)
    jax_prog = jax_serve.make_bucketed_program(
        d["det"], d["params"], sgg, sgg_params, zoo.prd, d["jcfg"],
        buckets=(2, MD), max_per_class=4)
    exp = jax.tree_util.tree_map(np.asarray, jax_prog(
        jnp.asarray(zoo.images), jnp.asarray(zoo.im_info)))
    prog = serve.make_bucketed_program(d["det_t"], sgg_t, zoo.prd, d["cfg"],
                                       buckets=(2, MD), max_det=MD,
                                       max_per_class=4, device="cpu")
    _held(prog(zoo.images, zoo.im_info), exp, name, bucketed=True)


def test_frame_program_class_agnostic_matches_jax(zoo):
    """A class-agnostic detector in the frame program, which passes no
    ``class_agnostic`` to the decode: JAX's out-of-range gather clamps to
    the one box column, the port reads the column count from
    ``bbox_pred``'s width; the same detections."""
    d = zoo.det("res10_fused_cag")
    sgg, sgg_params, sgg_t = zoo.sgg("res10_pool")
    jax_prog = jax_serve.make_frame_program(
        d["det"], d["params"], sgg, sgg_params, zoo.prd, d["jcfg"],
        max_det=MD, max_per_class=4)
    exp = jax.tree_util.tree_map(np.asarray, jax_prog(
        jnp.asarray(zoo.images), jnp.asarray(zoo.im_info)))
    prog = serve.make_frame_program(d["det_t"], sgg_t, zoo.prd, d["cfg"],
                                    max_det=MD, max_per_class=4, device="cpu")
    got = prog(zoo.images, zoo.im_info)
    _held(got, exp, "res10_fused_cag")
    # every class of a roi took the one agnostic box
    out = d["det_t"].inference(T(zoo.images), T(zoo.im_info))
    dec = serve.decode_detections(out["rois"], out["roi_valid"],
                                  out["cls_prob"], out["bbox_pred"],
                                  T(zoo.im_info), d["cfg"], max_det=MD,
                                  max_per_class=4, class_agnostic=True)
    np.testing.assert_array_equal(dec.classes.numpy(), got["classes"].numpy())
    close(dec.boxes, got["boxes"].numpy())
