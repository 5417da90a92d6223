"""The port's reference-checkpoint import (``i2vsgg_tpu_torch/utils/
torch_import.py``) against the JAX package's (``i2vsgg_tpu/utils/
torch_import.py``) on the CPU.

* Synthetic state dicts with the reference's (jwyang) names, built from the
  torch replicas of tests/test_jwyang_import.py and tests/
  test_torch_import.py: a res10 detector with ic+gc context and a VRD head.
  Each is imported by both packages; every imported tensor is bit-equal
  once carried across (``params_from_jax``), every tensor of the port's
  module comes from the checkpoint, and the two modules' outputs agree at
  f32 rtol 1e-5 (atol 1e-5 of the reference's largest magnitude).
* ``merge_imported`` raises on a name the module lacks and on a shape
  mismatch.
* The trained reference head ``runs/parity_r4c/ref_head_s1.pth`` (skipped
  where the file is absent; loaded once for the module), imported by both
  packages — with and without the ``vrd.`` prefix — and run through
  ``head_on_features`` on seeded 1024-channel features: rtol 1e-5; and
  how far the serving levers (bf16 storage, int8 fc6/fc7) move its output
  against its f32 self (``-s`` prints the numbers).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

from tests.test_jwyang_import import (TorchNetDPixel, TorchNetDStyle,
                                      TorchVRD, build_jwyang_base,
                                      randomize_bn)
from tests.test_torch_import import TorchBottleneck

from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.models.backbones import RESNET_STAGES
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.models.sgg import SGGModel as JaxSGGModel
from i2vsgg_tpu.models.sgg import VRDHead as JaxVRDHead
from i2vsgg_tpu.utils import torch_import as jax_import
from i2vsgg_tpu_torch import config as port_config
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.layers import init_weights
from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
from i2vsgg_tpu_torch.utils import torch_import
from i2vsgg_tpu_torch.utils.weights import params_from_jax

DEPTH, N_CLASSES = 10, 4
B, H, W = 2, 64, 80
REF_HEAD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "runs", "parity_r4c", "ref_head_s1.pth")
JAX_CFG = JaxConfig().replace(
    TEST=JaxConfig().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                    RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="float32")
CFG = port_config.Config().replace(
    TEST=port_config.TestConfig(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="float32")


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def close(got, exp, rtol=1e-5, atol=1e-5):
    exp = np.asarray(exp)
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, exp, rtol=rtol,
                               atol=atol * max(scale, 1.0))


def same_tensors(port_module, imported_tree):
    """Every tensor of ``port_module`` bit-equal to the JAX tree carried
    across, and no tensor of the module left out."""
    want = params_from_jax(np_tree(imported_tree))
    got = port_module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def jwyang_detector_state_dict(num_classes, seed=0):
    """A res10 detector checkpoint in the reference's names: RCNN_base
    (conv1, bn1, layer1-3), RCNN_top (layer4), RCNN_rpn, the two heads over
    ic (128) + gc (512) + 2048 features, netD_pixel (conv1-3) and
    netD_style."""
    torch.manual_seed(seed)
    base = build_jwyang_base(DEPTH)
    n4 = RESNET_STAGES[DEPTH][3]
    top = tnn.Sequential(tnn.Sequential(
        TorchBottleneck(1024, 512, 2, downsample=True),
        *[TorchBottleneck(2048, 512) for _ in range(1, n4)]))
    for m in (base, top):
        randomize_bn(m)
    rpn = tnn.Module()
    rpn.RPN_Conv = tnn.Conv2d(1024, 512, 3, 1, 1)
    rpn.RPN_cls_score = tnn.Conv2d(512, 18, 1)
    rpn.RPN_bbox_pred = tnn.Conv2d(512, 36, 1)
    feat = 2048 + 128 + 512
    sd = {f"RCNN_base.{k}": v for k, v in base.state_dict().items()}
    sd.update({f"RCNN_top.{k}": v for k, v in top.state_dict().items()})
    sd.update({f"RCNN_rpn.{k}": v for k, v in rpn.state_dict().items()})
    with torch.no_grad():
        sd["RCNN_rpn.RPN_cls_score.weight"] *= 40.0
    cls, box = tnn.Linear(feat, num_classes), tnn.Linear(feat, 4 * num_classes)
    with torch.no_grad():
        cls.weight *= 40.0
        box.weight *= 0.1
    sd.update({f"RCNN_cls_score.{k}": v for k, v in cls.state_dict().items()})
    sd.update({f"RCNN_bbox_pred.{k}": v for k, v in box.state_dict().items()})
    sd.update({f"netD_pixel.{k}": v
               for k, v in TorchNetDPixel().state_dict().items()})
    sd.update({f"netD_style.{k}": v
               for k, v in TorchNetDStyle().state_dict().items()})
    # a DataParallel checkpoint in the reference's wrapper
    return {"model": {f"module.{k}": v for k, v in sd.items()},
            "epoch": 3, "pooling_mode": "align"}


def test_detector_import_matches_jax(tmp_path, rng):
    path = str(tmp_path / "det.pth")
    torch.save(jwyang_detector_state_dict(N_CLASSES), path)
    sd = torch_import.load_torch_checkpoint(path)
    sd_jax = jax_import.load_torch_checkpoint(path)
    assert set(sd) == set(sd_jax)
    assert not any(k.startswith("module.") for k in sd)

    images = (rng.randn(B, H, W, 3) * 20).astype(np.float32)
    im_info = np.tile([[H, W, 1.0]], (B, 1)).astype(np.float32)
    det_j = JaxFasterRCNN(num_classes=N_CLASSES, cfg=JAX_CFG,
                          backbone=f"res{DEPTH}", ic=True, gc=True)
    init = det_j.init({"params": jax.random.PRNGKey(0)},
                      jnp.asarray(images[:1]), jnp.asarray(im_info[:1]),
                      mode="inference")["params"]
    imported_j = jax_import.jwyang_detector_params(sd_jax, DEPTH)
    det = FasterRCNN_DA(N_CLASSES, CFG, f"res{DEPTH}", ic=True, gc=True)
    init_weights(det, torch.Generator().manual_seed(0))
    imported = torch_import.jwyang_detector_params(sd, DEPTH)
    # the fused detector has no netD_pixel conv3 (it runs in training
    # only): both packages refuse the reference's conv3 strictly
    with pytest.raises(KeyError):
        jax_import.merge_imported(init, imported_j)
    with pytest.raises(KeyError):
        torch_import.merge_imported(det, imported)
    del imported_j["netD_pixel"]["conv3"]
    imported = {k: v for k, v in imported.items()
                if not k.startswith("netD_pixel.conv3.")}
    params = jax_import.merge_imported(init, imported_j)
    assert set(imported) == set(det.state_dict())
    torch_import.merge_imported(det, imported)
    same_tensors(det, params)

    exp = det_j.apply({"params": params}, jnp.asarray(images),
                      jnp.asarray(im_info), mode="inference")
    got = det.eval().inference(torch.from_numpy(images),
                               torch.from_numpy(im_info))
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(exp["roi_valid"]))
    for k in ("base_feat", "rois", "cls_prob", "bbox_pred"):
        close(got[k], exp[k])


def test_vrd_head_import_matches_jax(rng):
    """The replica's ``vrd.*`` names (c = 8 channels, fc_dim 32, the
    spatial tower): fc6's CHW-to-HWC columns, the tower and the cosine
    scores; the head's names with the ``vrd.`` prefix and without it."""
    c, fc_dim, emb = 8, 32, 16
    torch.manual_seed(1)
    sd = {f"vrd.{k}": v for k, v in TorchVRD(c, 7, fc_dim, emb)
          .state_dict().items()}
    head_j = JaxVRDHead(emb_dim=emb, fc_dim=fc_dim, dtype=jnp.float32)
    fmap = rng.randn(1, 20, 26, c).astype(np.float32)
    obj = np.asarray([[0, 10, 12, 120, 150], [0, 60, 30, 300, 200],
                      [0, 5, 100, 90, 310]], np.float32)
    uni = obj[[0, 1, 2]].copy()
    masks = rng.rand(3, 32, 32, 2).astype(np.float32)
    ix1 = np.asarray([0, 1, 2], np.int32)
    ix2 = np.asarray([1, 2, 0], np.int32)
    prd = rng.randn(5, 300).astype(np.float32)
    args = [jnp.asarray(a) for a in (fmap, obj, uni, masks, ix1, ix2, prd)]
    init = head_j.init({"params": jax.random.PRNGKey(0)}, *args)["params"]
    params = jax_import.merge_imported(
        init, jax_import.jwyang_vrd_params(
            {k: v.numpy() for k, v in sd.items()}, fmap_channels=c))
    exp = head_j.apply({"params": params}, *args)["scores"]

    head = VRDHead(emb_dim=emb, fc_dim=fc_dim, in_channels=c)
    model = SGGModel(head)
    torch_import.merge_imported(model, {
        f"vrd.{k}": v for k, v in torch_import.jwyang_vrd_params(
            sd, fmap_channels=c).items()})
    bare = torch_import.jwyang_vrd_params(
        {k[len("vrd."):]: v for k, v in sd.items()}, fmap_channels=c)
    assert set(bare) == set(head.state_dict())
    same_tensors(head, params)
    with torch.no_grad():
        got = head(torch.from_numpy(fmap), torch.from_numpy(obj),
                   torch.from_numpy(uni), torch.from_numpy(ix1).long(),
                   torch.from_numpy(ix2).long(), torch.from_numpy(prd),
                   spatial_fea=torch.from_numpy(masks))["scores"]
    close(got, exp)


def test_merge_imported_is_strict():
    head = VRDHead(emb_dim=16, fc_dim=32, in_channels=8)
    w = head.fc8.weight.detach().clone()                 # (256, 32)
    with pytest.raises(KeyError):
        torch_import.merge_imported(head, {"fc9.weight": w})
    with pytest.raises(ValueError):
        torch_import.merge_imported(head, {"fc8.weight": w.t()})
    # a refused import leaves the module as it was
    with pytest.raises(KeyError):
        torch_import.merge_imported(head, {"fc8.weight": w + 1,
                                           "nope.bias": w[0]})
    assert torch.equal(head.fc8.weight, w)


@pytest.fixture(scope="module")
def ref_head():
    """The trained head, loaded once: its state dict (memory-mapped), the
    JAX tree and the port's head."""
    if not os.path.exists(REF_HEAD):
        pytest.skip(f"{REF_HEAD} is not in this checkout")
    sd = torch_import.load_torch_checkpoint(REF_HEAD)
    assert "fc6.fc.weight" in sd and tuple(sd["fc6.fc.weight"].shape) == (
        4096, 50176)
    head = VRDHead()
    torch_import.merge_imported(head, torch_import.jwyang_vrd_params(sd))
    jtree = jax_import.jwyang_vrd_params(
        {f"vrd.{k}": v.numpy() for k, v in sd.items()})
    return sd, jtree, head.eval()


def test_trained_head_matches_jax(ref_head, rng):
    """head_on_features of the trained head, JAX's against the port's, on
    seeded synthetic 1024-channel features and 6 boxes (30 pairs)."""
    from i2vsgg_tpu.serve import make_pair_indices, make_union_dedup
    sd, jtree, head = ref_head
    fmap = np.abs(rng.randn(1, 24, 32, 1024)).astype(np.float32)
    boxes = np.asarray([[10, 20, 200, 260], [150, 40, 380, 330],
                        [300, 100, 500, 370], [40, 200, 260, 370],
                        [220, 10, 420, 180], [0, 0, 511, 383]], np.float32)
    im_info = np.asarray([384, 512, 1.0], np.float32)
    ix1, ix2 = make_pair_indices(len(boxes))
    static = make_union_dedup(ix1, ix2)
    pv = np.ones(len(ix1), bool)
    prd = rng.randn(26, 300).astype(np.float32)
    sgg_j = JaxSGGModel(trunk=None, vrd=JaxVRDHead(), n_rel=26)
    exp = sgg_j.apply({"params": {"vrd": jtree}}, jnp.asarray(fmap),
                      jnp.asarray(im_info), jnp.asarray(boxes),
                      jnp.asarray(ix1), jnp.asarray(ix2), jnp.asarray(pv),
                      jnp.asarray(prd), pair_static=static,
                      method=JaxSGGModel.head_on_features)
    got = SGGModel(head).head_on_features(
        torch.from_numpy(fmap), torch.from_numpy(im_info),
        torch.from_numpy(boxes), torch.from_numpy(ix1).long(),
        torch.from_numpy(ix2).long(), torch.from_numpy(pv),
        torch.from_numpy(prd), pair_static=static)
    close(got["scores"], exp["scores"])
    close(torch.softmax(got["scores"], -1),
          jax.nn.softmax(exp["scores"], -1))


def test_trained_head_prefix_forms_agree(ref_head):
    """The head's keys with and without ``vrd.`` import to the same
    tensors, and the permuted fc6 is the CHW weight reordered HWC."""
    sd, _, head = ref_head
    with_prefix = torch_import.jwyang_sgg_params(
        {f"vrd.{k}": v for k, v in sd.items()})
    assert set(with_prefix) == {f"vrd.{k}" for k in head.state_dict()}
    w = sd["fc6.fc.weight"]
    assert torch.equal(head.fc6.weight[:, :1024], w[:, ::49])
    for k, v in head.state_dict().items():
        if k != "fc6.weight":
            assert torch.equal(with_prefix[f"vrd.{k}"], v), k


def test_trained_head_drift_under_serving_levers(ref_head):
    """How far the serving levers move the trained head's output against
    its f32 self (accuracy on the CPU, not speed; PERF.md records these
    numbers): ``bf16_storage_cast`` (``--bf16_weights``, bf16 compute),
    fc6/fc7 in int8 (``--int8_fc6``, ``quantize_dense_params``) and both.
    Seeded post-ReLU-like features (|N(0, 1)|, 4 frames of (1, 38, 60,
    1024), the stride-16 map of a 600x960 frame) with 8 random boxes each
    (224 pairs) and the drivers' random predicate vectors: the trunk that
    fed this head in training is not saved and no GloVe file is in the
    repository, so this is the levers' arithmetic on this head, not its
    task accuracy. Held to the bounds that the recorded numbers meet: the
    relation probabilities move by under 1e-4, the raw cosines by under
    1e-2, and no pair's top-1 predicate changes."""
    from i2vsgg_tpu_torch.serve import make_pair_indices, pair_layout
    from i2vsgg_tpu_torch.utils.params import (bf16_storage_cast,
                                               quantize_dense_params)
    sd, _, _ = ref_head
    imported = torch_import.jwyang_vrd_params(sd)
    heads = {}
    for name, dtype, int8 in (("f32", torch.float32, False),
                              ("bf16", torch.bfloat16, False),
                              ("int8", torch.float32, True),
                              ("bf16+int8", torch.bfloat16, True)):
        head = VRDHead(dtype=dtype, int8_fc=int8)
        torch_import.merge_imported(head, imported)
        if dtype == torch.bfloat16:
            bf16_storage_cast(head)
        if int8:
            quantize_dense_params(head)
        heads[name] = SGGModel(head).eval()
    dets, frames, h, w = 8, 4, 38, 60
    prd = torch.from_numpy(np.random.RandomState(0).randn(26, 300).astype(
        np.float32))
    ix1, ix2, static = pair_layout(dets, "cpu")
    pv = torch.ones(len(make_pair_indices(dets)[0]), dtype=torch.bool)
    rs = np.random.RandomState(0)
    cos = {k: [] for k in heads}
    with torch.no_grad():
        for _ in range(frames):
            fmap = np.abs(rs.randn(1, h, w, 1024)).astype(np.float32)
            ih, iw = 16.0 * h, 16.0 * w
            xy = rs.uniform(0, 1, (dets, 2)) * [iw * 0.7, ih * 0.7]
            wh = rs.uniform(0.1, 0.3, (dets, 2)) * [iw, ih]
            boxes = np.concatenate([xy, np.minimum(xy + wh, [iw - 1,
                                                             ih - 1])], 1)
            args = (torch.from_numpy(fmap),
                    torch.tensor([ih, iw, 1.0]),
                    torch.from_numpy(boxes.astype(np.float32)))
            for k, m in heads.items():
                cos[k].append(m.head_on_features(
                    *args, ix1, ix2, pv, prd, pair_static=static)[
                        "scores"].float())
    ref_cos = torch.cat(cos.pop("f32"))
    ref = torch.softmax(ref_cos, -1)
    top2 = ref.topk(2, -1).values
    print(f"f32: {ref.shape[0]} pairs, rel_prob max {float(ref.max()):.4g}, "
          f"median top-1 margin {float((top2[:, 0] - top2[:, 1]).median()):.3g}")
    for k, c in cos.items():
        c = torch.cat(c)
        got = torch.softmax(c, -1)
        d = (got - ref).abs()
        cos_d = float((c - ref_cos).abs().max())
        changed = float((got.argmax(-1) != ref.argmax(-1)).float().mean())
        print(f"{k}: rel_prob max |d| {float(d.max()):.3g} (mean "
              f"{float(d.mean()):.3g}), cosine max |d| {cos_d:.3g}, top-1 "
              f"changed on {100 * changed:.2f} % of pairs")
        assert float(d.max()) < 1e-4, k
        assert cos_d < 1e-2, k
        assert changed == 0.0, k
