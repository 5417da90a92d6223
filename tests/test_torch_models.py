"""Parity of the port's models and serving program with the JAX package on
the CPU, stage by stage, at the tiny config of test_serve.py (res10, 64x80
frames, 4 classes) with the main path's ic+gc context and the SGG head's
``pooling="pool"``.

The JAX parameters are initialised once, carried across with
``params_from_jax``, and each stage of the port is fed the JAX stage's own
inputs, so a near-tie in an NMS at one stage cannot hide or fake a fault at
a later one. fp32 on both sides (conftest sets JAX's matmul precision to
"highest"); tolerances: trunk/head rtol 1e-4, detections exact in classes
and validity with boxes to 1e-4, relation probabilities to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.models import backbones as jax_bb
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.models.rpn import generate_proposals as jax_generate_proposals
from i2vsgg_tpu.models.sgg import SGGModel as JaxSGGModel
from i2vsgg_tpu.models.sgg import VRDHead as JaxVRDHead
from i2vsgg_tpu.ops.anchors import generate_anchors as jax_generate_anchors
from i2vsgg_tpu.ops.anchors import shifted_anchors as jax_shifted_anchors
from i2vsgg_tpu import serve as jax_serve
from i2vsgg_tpu_torch import serve
from i2vsgg_tpu_torch import config as port_config
from i2vsgg_tpu_torch.models import backbones as port_bb
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.rpn import generate_proposals
from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
from i2vsgg_tpu_torch.ops.anchors import generate_anchors, shifted_anchors
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


def T(a):
    return torch.as_tensor(np.array(a))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """JAX and port models with the same weights. The RPN and class logits
    are scaled up so that scores spread out and no top-k or NMS decision
    sits on a float near-tie."""
    rs = np.random.RandomState(0)
    images = (rs.randn(B, H, W, 3) * 10).astype(np.float32)
    im_info = np.tile([[H, W, 1.0]], (B, 1)).astype(np.float32)
    det = JaxFasterRCNN(num_classes=N_CLASSES, cfg=JAX_CFG, backbone="res10",
                        ic=True, gc=True)
    det_params = np_tree(det.init({"params": jax.random.PRNGKey(0)},
                                  jnp.asarray(images[:1]),
                                  jnp.asarray(im_info[:1]),
                                  mode="inference")["params"])
    det_params = jax.tree_util.tree_map(lambda a: a.copy(), det_params)
    det_params["rpn"]["cls_score"]["kernel"] *= 40.0
    det_params["cls_score"]["kernel"] *= 40.0
    sgg = JaxSGGModel(trunk=jax_bb.ResNetTrunk(depth=10, dtype=jnp.float32),
                      vrd=JaxVRDHead(emb_dim=16, fc_dim=32), n_rel=N_REL)
    prd = rs.randn(N_REL, 300).astype(np.float32)
    ix = jnp.zeros((MD * (MD - 1),), jnp.int32)
    sgg_params = np_tree(sgg.init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, H // 16, W // 16, 1024)), jnp.asarray([H, W, 1.0]),
        jnp.zeros((MD, 4)), ix, ix, jnp.zeros(ix.shape, bool),
        jnp.asarray(prd), method=JaxSGGModel.head_on_features)["params"])

    det_t = FasterRCNN_DA(N_CLASSES, CFG, "res10", ic=True, gc=True)
    det_t.load_state_dict(params_from_jax(det_params))
    sgg_t = SGGModel(VRDHead(emb_dim=16, fc_dim=32))
    sgg_t.load_state_dict(params_from_jax(sgg_params))
    jax_out = det.apply({"params": det_params}, jnp.asarray(images),
                        jnp.asarray(im_info), mode="inference")
    return dict(det=det, det_params=det_params, sgg=sgg,
                sgg_params=sgg_params, det_t=det_t.eval(),
                sgg_t=sgg_t.eval(), prd=prd, images=images, im_info=im_info,
                jax_out=jax.tree_util.tree_map(np.asarray, jax_out))


def close(got, exp, rtol, atol=0.0):
    """allclose with ``atol`` relative to the reference's largest magnitude:
    f32 sums taken in another order differ by a fraction of the summed
    magnitude, which an element near zero cannot meet in relative terms."""
    exp = np.asarray(exp)
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(got.detach().numpy(), exp, rtol=rtol,
                               atol=atol * max(scale, 1.0))


def test_params_from_jax_layouts(models):
    sd = params_from_jax(models["det_params"])
    k = models["det_params"]["rpn"]["conv"]["kernel"]           # HWIO
    assert tuple(sd["rpn.conv.weight"].shape) == (k.shape[3], k.shape[2],
                                                  k.shape[0], k.shape[1])
    np.testing.assert_array_equal(sd["rpn.conv.weight"].numpy()[5, 7, 2, 1],
                                  k[2, 1, 7, 5])
    d = models["det_params"]["cls_score"]["kernel"]              # (I, O)
    np.testing.assert_array_equal(sd["cls_score.weight"].numpy(), d.T)
    assert "trunk.bn1.var" in dict(models["det_t"].named_buffers())


def test_trunk_and_head_match_jax(models, rng):
    p = models["det_params"]
    trunk = jax_bb.ResNetTrunk(depth=10, dtype=jnp.float32)
    c4, tap = trunk.apply({"params": p["trunk"]},
                          jnp.asarray(models["images"]))
    c4_t, tap_t = models["det_t"].trunk(T(models["images"]))
    close(c4_t, c4, 1e-4, 1e-5)
    close(tap_t, tap, 1e-4, 1e-5)

    head = jax_bb.ResNetHead(depth=10, dtype=jnp.float32)
    for size, stride in ((4, 1), (7, 2)):
        x = rng.randn(6, size, size, 1024).astype(np.float32)
        exp = head.apply({"params": p["head"]}, jnp.asarray(x),
                         first_stride=stride)
        close(models["det_t"].head(T(x), first_stride=stride), exp, 1e-4, 1e-5)


@pytest.mark.parametrize("hw", [(64, 96), (60, 80), (61, 81)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_conv1_under_s2d_matches_jax(monkeypatch, hw):
    """``I2VSGG_S2D=1``: JAX's space-to-depth conv1 (``Conv1S2D``; at the
    odd 61x81 its direct fallback) against the port's direct conv1, which
    ignores the switch: f32, atol 2e-5 as JAX's own test holds the two
    forms. The port's stem is the same with the switch on and off."""
    h, w = hw
    x = np.random.RandomState(3).randn(2, h, w, 3).astype(np.float32)
    m = jax_bb.Conv1S2D(dtype=jnp.float32)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    trunk = port_bb.ResNetTrunk(depth=10, dtype=torch.float32)
    trunk.conv1.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in params["params"].items()}))
    with torch.no_grad():
        plain = trunk._stem(T(x))
        monkeypatch.setenv("I2VSGG_S2D", "1")
        want = np.asarray(m.apply(params, jnp.asarray(x)))
        got = port_bb.nchw_to_nhwc(trunk.conv1(port_bb.nhwc_to_nchw(T(x))))
        assert torch.equal(trunk._stem(T(x)), plain)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_rpn_proposals_match_jax(rng):
    """generate_proposals given identical head outputs: same rois/valid."""
    fh, fw, a = 4, 5, 9
    fg = rng.rand(B, fh, fw, a).astype(np.float32)
    deltas = (rng.randn(B, fh, fw, 4 * a) * 0.2).astype(np.float32)
    im_info = np.asarray([[H, W, 1.0], [H - 8, W - 16, 1.0]], np.float32)
    base = jax_generate_anchors()
    exp = jax_generate_proposals(
        jnp.asarray(fg), jnp.asarray(deltas), jnp.asarray(im_info),
        jax_shifted_anchors(fh, fw, 16, base), 100, 16, 0.7)
    got = generate_proposals(T(fg), T(deltas), T(im_info),
                             shifted_anchors(fh, fw, 16, generate_anchors()),
                             100, 16, 0.7)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(exp.valid))
    close(got.rois, exp.rois, 1e-5, 1e-6)


def test_faster_rcnn_inference_matches_jax(models):
    exp = models["jax_out"]
    got = models["det_t"].inference(T(models["images"]),
                                    T(models["im_info"]))
    close(got["base_feat"], exp["base_feat"], 1e-4, 1e-5)
    np.testing.assert_array_equal(got["roi_valid"].numpy(), exp["roi_valid"])
    # end to end the trunk's ~1e-6 relative differences reach the rois
    # multiplied by anchor sizes of up to 368 px: 1e-5 of the largest roi
    # coordinate is a few thousandths of a pixel
    close(got["rois"], exp["rois"], 1e-5, 1e-5)
    close(got["cls_prob"], exp["cls_prob"], 1e-4, 1e-6)
    close(got["bbox_pred"], exp["bbox_pred"], 1e-4, 1e-6)


def _jax_dets(models):
    o = models["jax_out"]
    return jax_serve.decode_detections(
        jnp.asarray(o["rois"]), jnp.asarray(o["roi_valid"]),
        jnp.asarray(o["cls_prob"]), jnp.asarray(o["bbox_pred"]),
        jnp.asarray(models["im_info"]), JAX_CFG, max_det=MD, max_per_class=4)


def test_decode_detections_matches_jax(models):
    o = models["jax_out"]
    exp = _jax_dets(models)
    got = serve.decode_detections(
        T(o["rois"]), T(o["roi_valid"]), T(o["cls_prob"]), T(o["bbox_pred"]),
        T(models["im_info"]), CFG, max_det=MD, max_per_class=4)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(exp.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(exp.valid))
    close(got.boxes, exp.boxes, 1e-5, 1e-6)
    close(got.scores, exp.scores, 1e-6, 1e-6)
    assert got.valid.any()


@pytest.mark.parametrize("pooling", ["pool", "align"])
def test_head_on_features_matches_jax(models, pooling):
    """The SGG head fed JAX's feature map and detections."""
    dets = _jax_dets(models)
    sgg = JaxSGGModel(trunk=jax_bb.ResNetTrunk(depth=10, dtype=jnp.float32),
                      vrd=JaxVRDHead(emb_dim=16, fc_dim=32, pooling=pooling),
                      n_rel=N_REL)
    sgg_t = SGGModel(VRDHead(emb_dim=16, fc_dim=32, pooling=pooling))
    sgg_t.load_state_dict(params_from_jax(models["sgg_params"]))
    ix1, ix2 = jax_serve.make_pair_indices(MD)
    pair_static = jax_serve.make_union_dedup(ix1, ix2)
    base = models["jax_out"]["base_feat"]
    for f in range(B):
        info = models["im_info"][f]
        boxes = np.asarray(dets.boxes[f]) * info[2]
        pv = np.asarray(dets.valid[f])[ix1] & np.asarray(dets.valid[f])[ix2]
        exp = sgg.apply({"params": models["sgg_params"]},
                        jnp.asarray(base[f:f + 1]), jnp.asarray(info),
                        jnp.asarray(boxes), jnp.asarray(ix1),
                        jnp.asarray(ix2), jnp.asarray(pv),
                        jnp.asarray(models["prd"]), pair_static=pair_static,
                        method=JaxSGGModel.head_on_features)
        before = roi_pool.launches
        got = sgg_t.head_on_features(
            T(base[f:f + 1]), T(info), T(boxes), T(ix1).long(),
            T(ix2).long(), T(pv), T(models["prd"]),
            pair_static=tuple(T(a).long() for a in pair_static))
        assert roi_pool.launches == before          # CPU: plain version
        close(torch.softmax(got["scores"], -1),
              jax.nn.softmax(exp["scores"], -1), 1e-4, 1e-6)
        close(got["scores"], exp["scores"], 1e-4, 1e-5)


def test_frame_program_matches_jax(models):
    jax_prog = jax_serve.make_frame_program(
        models["det"], models["det_params"], models["sgg"],
        models["sgg_params"], models["prd"], JAX_CFG, max_det=MD,
        max_per_class=4)
    exp = jax.tree_util.tree_map(np.asarray, jax_prog(
        jnp.asarray(models["images"]), jnp.asarray(models["im_info"])))
    prog = serve.make_frame_program(models["det_t"], models["sgg_t"],
                                    models["prd"], CFG, max_det=MD,
                                    max_per_class=4, device="cpu")
    got = prog(models["images"], models["im_info"])
    p = MD * (MD - 1)
    assert tuple(got["rel_prob"].shape) == (B, p, N_REL)
    np.testing.assert_array_equal(got["det_valid"].numpy(), exp["det_valid"])
    np.testing.assert_array_equal(got["classes"].numpy(), exp["classes"])
    np.testing.assert_array_equal(got["pair_valid"].numpy(), exp["pair_valid"])
    np.testing.assert_array_equal(got["ix1"].numpy(), exp["ix1"])
    close(got["boxes"], exp["boxes"], 1e-5, 1e-5)
    close(got["scores"], exp["scores"], 1e-4, 1e-6)
    close(got["rel_prob"], exp["rel_prob"], 1e-4, 1e-6)
    np.testing.assert_allclose(got["rel_prob"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_entry_points_refuse_a_missing_card(models, monkeypatch):
    """With no card and no explicit cpu, the entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.make_frame_program(models["det_t"], models["sgg_t"],
                                 models["prd"], CFG, max_det=MD,
                                 max_per_class=4)
