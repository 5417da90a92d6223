"""The port at bf16 with bf16-stored weights against the JAX package on the
CPU: the frame program at ``COMPUTE_DTYPE="bfloat16"`` with
``bf16_storage_cast`` on both sides, at two settings of the tiny config of
test_serve.py (2 frames of 64x80, 4 classes, ``max_det`` 4, ic+gc, the SGG
head under ``pooling="align"`` in bf16):

* ``res10`` with ``I2VSGG_PALLAS_BOTTLENECK`` off (one block a stage: no
  chain anywhere);
* ``res50`` with the switch on (layer2 and layer3 tails run as the chain).

Each stage is fed the JAX stage's input, as tests/test_torch_models.py
does: the trunk's stages (the JAX stage's input map), the detector past the
trunk (JAX's c4 and tap), the SGG head (JAX's map and detections). Whole
programs are compared too. The detector's random weights are scaled so that
its detections are not degenerate (``_jax_models``). bf16 roundings taken in
another order (XLA's and oneDNN's sums) compound with depth, so the bounds
are stated per setting (measured on the CPU with 1 and 6 threads):

* trunk stages: the chain bounds of tests/test_torch_bottleneck.py (at
  most one bf16 ulp measured: bit-equal shares 0.99991-1.0 at res10 and
  0.62-0.99 at res50, where the chain's f32 sums run in another order than
  the interpret-mode Pallas kernel's through 5 blocks);
* detector past the trunk: roi validity equal, rois to 8e-4 px (measured
  1.5e-5), ``cls_prob`` to 1e-3 (1.1e-4) and ``bbox_pred`` to 2e-2
  (2.9e-4): one bf16 ulp of the head's features carried through the f32
  ``cls_score``/``bbox_pred``;
* SGG head on JAX's detections: ``rel_prob`` to 5e-3 (measured 9.6e-4;
  bf16 fc6/fc7 and conv tower);
* whole programs: classes, validity and pair validity equal — at res10
  slot by slot, at res50 after matching each JAX detection to the port's
  of the same class with the nearest box (two detections whose scores
  nearly tie may swap slots when two summation orders score them);
  boxes within 0.05 px at res10 (measured 3.8e-6) and 4 px at res50
  (0.84: the trunk's bf16 differences reach the RPN's bf16 box deltas,
  which anchors of up to 368 px scale), scores within 5e-3 (2.6e-4) and
  ``rel_prob`` within 5e-3 (1.0e-3).

Also: ``bf16_storage_cast`` keeps f32 exactly the leaves JAX's keeps, name
by name through ``params_from_jax``, which moves bf16 leaves bit for bit,
int8 kernels as int8, and still refuses any other int8 leaf.
"""

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
from i2vsgg_tpu.utils.params import bf16_storage_cast as jax_cast
from i2vsgg_tpu_torch import config as port_config
from i2vsgg_tpu_torch import serve
from i2vsgg_tpu_torch.models import backbones as bb
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models import sgg as sgg_mod
from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
from i2vsgg_tpu_torch.ops import bottleneck as chain
from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
from i2vsgg_tpu_torch.utils.params import bf16_storage_cast, keep_fp32
from i2vsgg_tpu_torch.utils.weights import params_from_jax
import chip_smoke
from test_torch_bottleneck import chain_close

N_CLASSES, N_REL, MD = 4, 5, 4
B, H, W = 2, 64, 80
JAX_CFG = JaxConfig().replace(
    TEST=JaxConfig().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                    RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="bfloat16")
CFG = port_config.Config().replace(
    TEST=port_config.TestConfig(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="bfloat16")
# setting -> (backbone, I2VSGG_PALLAS_BOTTLENECK, whole-program box bound
# px, detections in JAX's slot order)
SETTINGS = {"res10": ("res10", "0", 0.05, True),
            "res50": ("res50", "1", 4.0, False)}
REL_PROB_TOL = 5e-3
SCORE_TOL = 5e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def T(a):
    """numpy (bf16 leaves as their bits) -> torch, dtype kept."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def _jax_models(backbone, images, im_info, rs):
    det = JaxFasterRCNN(num_classes=N_CLASSES, cfg=JAX_CFG,
                        backbone=backbone, ic=True, gc=True)
    det_params = np_tree(det.init({"params": jax.random.PRNGKey(0)},
                                  jnp.asarray(images[:1]),
                                  jnp.asarray(im_info[:1]),
                                  mode="inference")["params"])
    # detections that are not degenerate: RPN scores spread (x40), box
    # deltas x0.1 so that proposals and boxes stay near their anchors
    # instead of collapsing onto the frame's border, class logits at their
    # init scale so that the probabilities spread over (0, 1) instead of
    # saturating (at 1.0, or at 1e-12 for res50) into ties that any two
    # summation orders break their own way
    det_params["rpn"]["cls_score"]["kernel"] *= 40.0
    det_params["rpn"]["bbox_pred"]["kernel"] *= 0.1
    det_params["bbox_pred"]["kernel"] *= 0.1
    sgg = JaxSGGModel(
        trunk=jax_bb.ResNetTrunk(depth=10, dtype=jnp.bfloat16),
        vrd=JaxVRDHead(emb_dim=16, fc_dim=32, pooling="align",
                       dtype=jnp.bfloat16), n_rel=N_REL)
    prd = rs.randn(N_REL, 300).astype(np.float32)
    ix = jnp.zeros((MD * (MD - 1),), jnp.int32)
    sgg_params = np_tree(sgg.init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, H // 16, W // 16, 1024)), jnp.asarray([H, W, 1.0]),
        jnp.zeros((MD, 4)), ix, ix, jnp.zeros(ix.shape, bool),
        jnp.asarray(prd), method=JaxSGGModel.head_on_features)["params"])
    return det, det_params, sgg, sgg_params, prd


@pytest.fixture(scope="module", params=list(SETTINGS))
def setting(request):
    """Both packages' models with the same bf16-stored weights, and JAX's
    outputs with the setting's switch."""
    backbone, switch, box_tol, exact_order = SETTINGS[request.param]
    rs = np.random.RandomState(0)
    images = (rs.randn(B, H, W, 3) * 10).astype(np.float32)
    im_info = np.tile([[H, W, 1.0]], (B, 1)).astype(np.float32)
    det, det_params, sgg, sgg_params, prd = _jax_models(backbone, images,
                                                        im_info, rs)
    det_params = np_tree(jax_cast(det_params))
    sgg_params = np_tree(jax_cast(sgg_params))
    det_t = bf16_storage_cast(FasterRCNN_DA(N_CLASSES, CFG, backbone, ic=True,
                                            gc=True))
    det_t.load_state_dict(params_from_jax(det_params))
    sgg_t = bf16_storage_cast(SGGModel(VRDHead(
        emb_dim=16, fc_dim=32, pooling="align", dtype=torch.bfloat16)))
    sgg_t.load_state_dict(params_from_jax(sgg_params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I2VSGG_PALLAS_BOTTLENECK", switch)
        out, state = det.apply({"params": det_params}, jnp.asarray(images),
                               jnp.asarray(im_info), mode="inference",
                               capture_intermediates=True)
        prog = jax_serve.make_frame_program(det, det_params, sgg, sgg_params,
                                            prd, JAX_CFG, max_det=MD,
                                            max_per_class=4)
        program_out = prog(jnp.asarray(images), jnp.asarray(im_info))
    return dict(switch=switch, box_tol=box_tol, exact_order=exact_order,
                sgg=sgg, sgg_params=sgg_params, det_t=det_t.eval(),
                sgg_t=sgg_t.eval(),
                prd=prd, images=images, im_info=im_info,
                jax_out=np_tree(out), trunk_mid=np_tree(
                    state["intermediates"]["trunk"]),
                jax_program=np_tree(program_out))


def close(got, exp, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(exp, np.float32), rtol=0, atol=atol)


def test_bf16_storage_cast_keeps_what_jax_keeps():
    """Name by name over a res10 det + SGG tree: the port's cast module has
    the dtypes of JAX's cast tree carried through ``params_from_jax``."""
    rs = np.random.RandomState(0)
    images = np.zeros((1, H, W, 3), np.float32)
    im_info = np.asarray([[H, W, 1.0]], np.float32)
    _, det_params, _, sgg_params, _ = _jax_models("res10", images, im_info,
                                                  rs)
    for tree, port in (
            (det_params, FasterRCNN_DA(N_CLASSES, CFG, "res10", ic=True,
                                       gc=True)),
            (sgg_params, SGGModel(VRDHead(emb_dim=16, fc_dim=32)))):
        want = {k: v.dtype for k, v in
                params_from_jax(np_tree(jax_cast(tree))).items()}
        got = {k: v.dtype for k, v in bf16_storage_cast(port).state_dict()
               .items()}
        assert got == want
        kept = {k for k, v in got.items() if v == torch.float32}
        assert kept == {k for k in got if keep_fp32(k)}
        assert any(v == torch.bfloat16 for v in got.values())
        if isinstance(port, FasterRCNN_DA):
            assert {"bbox_pred.weight", "rpn.bbox_pred.bias",
                    "trunk.bn1.var",
                    "head.layer4.block0.downsample_bn.scale"} <= kept


def test_params_from_jax_keeps_bf16_bits_and_refuses_int8():
    rs = np.random.RandomState(1)
    k = jnp.asarray(rs.randn(3, 3, 4, 5).astype(np.float32)).astype(
        jnp.bfloat16)
    b = jnp.asarray(rs.randn(5).astype(np.float32)).astype(jnp.bfloat16)
    sd = params_from_jax({"conv": {"kernel": np.asarray(k),
                                   "bias": np.asarray(b)},
                          "bn1": {"scale": np.ones(5, np.float32)}})
    assert sd["conv.weight"].dtype == torch.bfloat16
    assert sd["bn1.scale"].dtype == torch.float32
    want = np.asarray(k).view(np.uint16).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(
        sd["conv.weight"].view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(
        sd["conv.bias"].float().numpy(), np.asarray(b, np.float32))
    # int8 kernels (quantized serving trees) move as int8, transposed
    # (tests/test_torch_int8.py); any other int8 leaf is still refused
    sd = params_from_jax({"fc6": {"kernel": np.arange(12, dtype=np.int8)
                                  .reshape(3, 4)}})
    assert sd["fc6.weight"].dtype == torch.int8
    np.testing.assert_array_equal(sd["fc6.weight"].numpy(),
                                  np.arange(12).reshape(3, 4).T)
    with pytest.raises(TypeError):
        params_from_jax({"fc6": {"bias": np.zeros((4,), np.int8)}})


def test_bf16_trunk_stages_match_jax(monkeypatch, setting):
    """Each trunk stage fed the JAX stage's input map; with the switch on
    (res50) the layer2 and layer3 tails go through the chain."""
    s = setting
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", s["switch"])
    calls = []
    real = chain.bottleneck_chain

    def counting(*a):
        calls.append(tuple(a[0].shape))
        return real(*a)

    monkeypatch.setattr(bb, "bottleneck_chain", counting)
    trunk = s["det_t"].trunk
    mid = s["trunk_mid"]
    c4, tap = (np.asarray(a, np.float32) for a in mid["__call__"][0])
    x1 = np.asarray(mid["layer1"]["__call__"][0], np.float32)
    bf16 = torch.bfloat16
    with torch.no_grad():
        got1 = trunk.layer1(trunk._stem(T(s["images"])))
        got2 = trunk.layer2(bb.nhwc_to_nchw(T(x1)).to(bf16))
        got3 = trunk.layer3(bb.nhwc_to_nchw(T(tap)).to(bf16))
    for got, want in ((got1, x1), (got2, tap), (got3, c4)):
        assert got.dtype == bf16
        chain_close(bb.nchw_to_nhwc(got).float().numpy(), want)
    fused = [(B, 8, 10, 512), (B, 4, 5, 1024)] if s["switch"] == "1" else []
    assert calls == fused


def test_bf16_detector_past_the_trunk_matches_jax(monkeypatch, setting):
    """The detector fed JAX's c4 and tap: RPN, proposals, RoIAlign, layer4,
    the context heads and the f32 classifier."""
    s = setting
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", s["switch"])
    c4, tap = s["trunk_mid"]["__call__"][0]
    got = s["det_t"].detect_on_features(T(c4), T(tap), T(s["im_info"]))
    exp = s["jax_out"]
    np.testing.assert_array_equal(got["roi_valid"].numpy(), exp["roi_valid"])
    close(got["rois"], exp["rois"], 1e-5 * W)
    close(got["cls_prob"], exp["cls_prob"], 1e-3)
    close(got["bbox_pred"], exp["bbox_pred"], 2e-2)


def test_bf16_sgg_head_on_jax_detections_matches_jax(setting):
    s = setting
    o = s["jax_program"]
    ix1, ix2 = jax_serve.make_pair_indices(MD)
    pair_static = jax_serve.make_union_dedup(ix1, ix2)
    base = s["jax_out"]["base_feat"]
    for f in range(B):
        info = s["im_info"][f]
        boxes = np.asarray(o["boxes"][f]) * info[2]
        pv = np.asarray(o["pair_valid"][f])
        exp = s["sgg"].apply(
            {"params": s["sgg_params"]}, jnp.asarray(base[f:f + 1]),
            jnp.asarray(info), jnp.asarray(boxes), jnp.asarray(ix1),
            jnp.asarray(ix2), jnp.asarray(pv), jnp.asarray(s["prd"]),
            pair_static=pair_static, method=JaxSGGModel.head_on_features)
        got = s["sgg_t"].head_on_features(
            T(base[f:f + 1]), T(info), T(boxes), T(ix1).long(),
            T(ix2).long(), T(pv), T(s["prd"]),
            pair_static=tuple(T(a).long() for a in pair_static))
        close(torch.softmax(got["scores"].float(), -1),
              jax.nn.softmax(exp["scores"].astype(jnp.float32), -1),
              REL_PROB_TOL)


def test_bf16_sgg_head_under_align_pools_the_map_without_a_copy(setting):
    """The SGG head under align hands RoIAlignAvg the bf16 map as it comes
    with out_dtype=float32; its outputs equal those of the former route,
    which pooled an f32 copy of the map, and match JAX's head."""
    s = setting
    o = s["jax_program"]
    ix1, ix2 = jax_serve.make_pair_indices(MD)
    pair_static = jax_serve.make_union_dedup(ix1, ix2)
    base = s["jax_out"]["base_feat"]
    calls = []

    def recording(features, rois, *a, **k):
        calls.append((features.dtype, k.get("out_dtype")))
        return roi_align_avg(features, rois, *a, **k)

    def copy_route(features, rois, *a, out_dtype=None, **k):
        return roi_align_avg(features.float(), rois, *a, **k)

    for f in range(B):
        info = s["im_info"][f]
        boxes = np.asarray(o["boxes"][f]) * info[2]
        pv = np.asarray(o["pair_valid"][f])
        args = (T(info), T(boxes), T(ix1).long(), T(ix2).long(), T(pv),
                T(s["prd"]))
        kw = dict(pair_static=tuple(T(a).long() for a in pair_static))
        fmap = T(base[f:f + 1])
        assert fmap.dtype == torch.bfloat16
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sgg_mod, "roi_align_avg", recording)
            got = s["sgg_t"].head_on_features(fmap, *args, **kw)
            mp.setattr(sgg_mod, "roi_align_avg", copy_route)
            before = s["sgg_t"].head_on_features(fmap, *args, **kw)
        assert calls[-1] == (torch.bfloat16, torch.float32)
        for key in got:
            assert torch.equal(got[key], before[key]), key
        exp = s["sgg"].apply(
            {"params": s["sgg_params"]}, jnp.asarray(base[f:f + 1]),
            jnp.asarray(info), jnp.asarray(boxes), jnp.asarray(ix1),
            jnp.asarray(ix2), jnp.asarray(pv), jnp.asarray(s["prd"]),
            pair_static=pair_static, method=JaxSGGModel.head_on_features)
        close(torch.softmax(got["scores"].float(), -1),
              jax.nn.softmax(exp["scores"].astype(jnp.float32), -1),
              REL_PROB_TOL)


def test_bf16_frame_program_matches_jax(monkeypatch, setting):
    """Whole programs. At res50 two detections whose scores nearly tie may
    take each other's slot (``chip_smoke.matched_order``: same class and
    validity, nearest box); matched, they are compared as at res10, where
    the slots must agree as they are."""
    s = setting
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", s["switch"])
    exp = {k: T(v) for k, v in s["jax_program"].items()}
    prog = serve.make_frame_program(s["det_t"], s["sgg_t"], s["prd"], CFG,
                                    max_det=MD, max_per_class=4, device="cpu")
    got = prog(s["images"], s["im_info"])
    np.testing.assert_array_equal(got["ix1"].numpy(), exp["ix1"].numpy())
    np.testing.assert_array_equal(got["ix2"].numpy(), exp["ix2"].numpy())
    perm = chip_smoke.matched_order(got, exp)
    if s["exact_order"]:
        assert torch.equal(perm, torch.arange(MD).expand(B, MD))
    got = chip_smoke.reordered(got, perm)
    for k in ("det_valid", "classes", "pair_valid"):
        np.testing.assert_array_equal(got[k].numpy(), exp[k].numpy())
    assert got["det_valid"].any() and got["pair_valid"].any()
    close(got["boxes"], exp["boxes"], s["box_tol"])
    close(got["scores"], exp["scores"], SCORE_TOL)
    close(got["rel_prob"], exp["rel_prob"], REL_PROB_TOL)
    np.testing.assert_allclose(got["rel_prob"].sum(-1).float().numpy(), 1.0,
                               rtol=1e-5)
