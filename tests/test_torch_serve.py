"""The port's serving levers and Stage C against the JAX package on the CPU,
at the tiny config of test_serve.py (res10, 64x80 frames, 4 classes,
``max_det`` 4) with ic+gc context and the SGG head under ``pooling="align"``:

* the frame program fed host-packed ``Conv1Planes`` (conv1 in bf16, the rest
  f32): detections exact in classes and validity, boxes to 1e-5, scores and
  relation probabilities to 1e-4 (f32 summation order; the conv1 outputs
  agree bit for bit at this size);
* the bucketed program against the fused one (same package): detections
  identical, valid pairs' probabilities to 1e-5 (only the padding of the
  pair batch differs), and the bucket guard;
* ``dequantize_image_u8`` and Stage C (``detection_output``, the per-frame
  tuples, ``association``, ``evaluate``, ``evaluate_recognition``): exact.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from i2vsgg_tpu import serve as jax_serve
from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.data import pipeline as jax_pipeline
from i2vsgg_tpu.models import backbones as jax_bb
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.models.sgg import SGGModel as JaxSGGModel
from i2vsgg_tpu.models.sgg import VRDHead as JaxVRDHead
from i2vsgg_tpu.ops.pallas.conv1_kernel import Conv1Planes as JaxConv1Planes
from i2vsgg_tpu.video import association as jax_assoc
from i2vsgg_tpu.video import metrics as jax_metrics
from i2vsgg_tpu_torch import serve
from i2vsgg_tpu_torch import config as port_config
from i2vsgg_tpu_torch.data import pipeline
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
from i2vsgg_tpu_torch.ops.conv1 import Conv1Planes
from i2vsgg_tpu_torch.utils.weights import params_from_jax
from i2vsgg_tpu_torch.video import association, metrics

N_CLASSES, N_REL, MD = 4, 5, 4
B, H, W = 2, 64, 80
JAX_CFG = JaxConfig().replace(
    TEST=JaxConfig().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                    RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="float32")
CFG = port_config.Config().replace(
    TEST=port_config.TestConfig(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="float32")


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def models():
    """JAX and port models with the same weights; the RPN and class logits
    scaled up so that no top-k or NMS decision sits on a near-tie."""
    rs = np.random.RandomState(7)
    images = (rs.randn(B, H, W, 3) * 10).astype(np.float32)
    im_info = np.tile([[H, W, 1.0]], (B, 1)).astype(np.float32)
    det = JaxFasterRCNN(num_classes=N_CLASSES, cfg=JAX_CFG, backbone="res10",
                        ic=True, gc=True)
    det_params = np_tree(det.init({"params": jax.random.PRNGKey(0)},
                                  jnp.asarray(images[:1]),
                                  jnp.asarray(im_info[:1]),
                                  mode="inference")["params"])
    det_params["rpn"]["cls_score"]["kernel"] *= 40.0
    det_params["cls_score"]["kernel"] *= 40.0
    sgg = JaxSGGModel(trunk=jax_bb.ResNetTrunk(depth=10, dtype=jnp.float32),
                      vrd=JaxVRDHead(emb_dim=16, fc_dim=32, pooling="align"),
                      n_rel=N_REL)
    prd = rs.randn(N_REL, 300).astype(np.float32)
    ix = jnp.zeros((MD * (MD - 1),), jnp.int32)
    sgg_params = np_tree(sgg.init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, H // 16, W // 16, 1024)), jnp.asarray([H, W, 1.0]),
        jnp.zeros((MD, 4)), ix, ix, jnp.zeros(ix.shape, bool),
        jnp.asarray(prd), method=JaxSGGModel.head_on_features)["params"])
    det_t = FasterRCNN_DA(N_CLASSES, CFG, "res10", ic=True, gc=True)
    det_t.load_state_dict(params_from_jax(det_params))
    sgg_t = SGGModel(VRDHead(emb_dim=16, fc_dim=32, pooling="align"))
    sgg_t.load_state_dict(params_from_jax(sgg_params))
    return dict(det=det, det_params=det_params, sgg=sgg,
                sgg_params=sgg_params, det_t=det_t.eval(),
                sgg_t=sgg_t.eval(), prd=prd, images=images, im_info=im_info)


def close(got, exp, rtol, atol=0.0):
    exp = np.asarray(exp)
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(got.detach().numpy(), exp, rtol=rtol,
                               atol=atol * max(scale, 1.0))


def test_host_planes_frame_program_matches_jax(models):
    m = models
    jax_prog = jax_serve.make_frame_program(
        m["det"], m["det_params"], m["sgg"], m["sgg_params"], m["prd"],
        JAX_CFG, max_det=MD, max_per_class=4)
    exp = jax.tree_util.tree_map(np.asarray, jax_prog(
        JaxConv1Planes.pack(m["images"]), jnp.asarray(m["im_info"])))
    prog = serve.make_frame_program(m["det_t"], m["sgg_t"], m["prd"], CFG,
                                    max_det=MD, max_per_class=4,
                                    device="cpu")
    planes = Conv1Planes.pack(m["images"])
    got = prog(planes, m["im_info"])
    assert planes.planes.dtype == torch.bfloat16
    for k in ("det_valid", "classes", "pair_valid", "ix1", "ix2"):
        np.testing.assert_array_equal(got[k].numpy(), exp[k])
    assert got["det_valid"].any() and got["pair_valid"].any()
    close(got["boxes"], exp["boxes"], 1e-5, 1e-5)
    close(got["scores"], exp["scores"], 1e-4, 1e-6)
    close(got["rel_prob"], exp["rel_prob"], 1e-4, 1e-6)


def _pairs(out, f):
    return {(int(i), int(j)): out["rel_prob"][f][k].numpy()
            for k, (i, j) in enumerate(zip(out["ix1"], out["ix2"]))
            if out["pair_valid"][f][k]}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("buckets", [(2, MD), (1, 3, MD)])
def test_bucketed_program_matches_fused(models, buckets, sparse):
    """Mirrors tests/test_serve.py:126: detections identical, every valid
    pair of the fused program present and equal in the bucketed output.
    ``sparse`` leaves one foreground class (the others' probabilities
    underflow to 0) with at most 2 detections per frame, so that a bucket
    below ``max_det`` runs."""
    m = models
    det, mpc = m["det_t"], 4
    if sparse:
        det, mpc = copy.deepcopy(det), 2
        with torch.no_grad():
            det.cls_score.bias[:2] += 200.0
    kw = dict(max_det=MD, max_per_class=mpc, device="cpu")
    fused = serve.make_frame_program(det, m["sgg_t"], m["prd"], CFG, **kw)
    bucketed = serve.make_bucketed_program(det, m["sgg_t"], m["prd"], CFG,
                                           buckets=buckets, **kw)
    planes = Conv1Planes.pack(m["images"])
    ref = fused(planes, m["im_info"])
    out = bucketed(planes, m["im_info"])
    n = int(ref["det_valid"].sum(1).max())
    assert out["bucket"] == min(b for b in buckets if b >= n)
    assert (out["bucket"] < MD) == sparse
    for k in ("boxes", "scores", "classes", "det_valid"):
        assert torch.equal(out[k], ref[k]), k
    for f in range(B):
        want, got = _pairs(ref, f), _pairs(out, f)
        assert set(want) == set(got)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("buckets", [(8, 4), (4, 4, 8), (2, 4), (4, 16), ()])
def test_bucket_guard_refuses(models, buckets):
    """Unsorted, repeated, or a largest bucket other than max_det (8)."""
    m = models
    with pytest.raises(ValueError):
        serve.make_bucketed_program(m["det_t"], m["sgg_t"], m["prd"], CFG,
                                    buckets=buckets, max_det=8, device="cpu")


def test_dequantize_image_u8_and_bucket_hw_match_jax():
    rs = np.random.RandomState(8)
    u8 = rs.randint(0, 256, (3, 40, 56, 3)).astype(np.uint8)
    info = np.asarray([[40, 56, 1.0], [33, 50, 1.5], [40, 21, 0.5]],
                      np.float32)
    means = port_config.Config().PIXEL_MEANS
    ref = np.asarray(jax_pipeline.dequantize_image_u8(
        jnp.asarray(u8), jnp.asarray(info), means))
    got = pipeline.dequantize_image_u8(torch.from_numpy(u8),
                                       torch.from_numpy(info), means)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # the f32 transport: mean-subtracted pixels, zero padding
    f32 = u8.astype(np.float32) - np.asarray(means, np.float32)
    f32[1, 33:] = 0.0
    f32[1, :, 50:] = 0.0
    f32[2, :, 21:] = 0.0
    np.testing.assert_array_equal(got.numpy(), f32)
    for hw in [(600, 800), (600, 1100), (900, 600), (600, 2000)]:
        assert pipeline.bucket_hw(*hw) == jax_pipeline.bucket_hw(*hw)


def random_output(rs, b=3, md=5, n_rel=4):
    """A program output as numpy: sorted detections with a valid prefix."""
    valid = np.zeros((b, md), bool)
    for f, n in enumerate(rs.randint(0, md + 1, b)):
        valid[f, :n] = True
    ix1, ix2 = serve.make_pair_indices(md)
    boxes = rs.rand(b, md, 4).astype(np.float32) * 200
    boxes[..., 2:] += boxes[..., :2]
    rel = rs.rand(b, len(ix1), n_rel).astype(np.float32)
    return {"boxes": boxes,
            "scores": np.sort(rs.rand(b, md).astype(np.float32))[:, ::-1]
            .copy(),
            "classes": rs.randint(1, 6, (b, md)), "det_valid": valid,
            "rel_prob": rel / rel.sum(-1, keepdims=True),
            "pair_valid": valid[:, ix1] & valid[:, ix2], "ix1": ix1,
            "ix2": ix2}


def jax_tuples(o, f, top_k):
    """tools/serve_video.py's per-frame loop over JAX's detection_output."""
    valid, pv = o["det_valid"][f], o["pair_valid"][f]
    res = jax_metrics.detection_output(
        o["rel_prob"][f][pv], o["boxes"][f][valid], o["classes"][f][valid],
        o["scores"][f][valid], np.cumsum(valid)[o["ix1"][pv]] - 1,
        np.cumsum(valid)[o["ix2"][pv]] - 1, top_k=top_k)
    if res is None:
        return []
    rlp, tconfs, sboxes, oboxes, _ = res
    return [[float(tconfs[t]), [int(c) for c in rlp[t]],
             [sboxes[t].tolist(), oboxes[t].tolist()], t]
            for t in range(len(tconfs))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_output_and_frame_tuples_match_jax(seed):
    rs = np.random.RandomState(seed)
    o = random_output(rs)
    as_torch = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in o.items()}
    for f in range(3):
        valid, pv = o["det_valid"][f], o["pair_valid"][f]
        args = (o["rel_prob"][f][pv], o["boxes"][f][valid],
                o["classes"][f][valid], o["scores"][f][valid],
                np.cumsum(valid)[o["ix1"][pv]] - 1,
                np.cumsum(valid)[o["ix2"][pv]] - 1)
        ref = jax_metrics.detection_output(*args, top_k=7)
        got = metrics.detection_output(*args, top_k=7)
        assert (ref is None) == (got is None)
        if ref is not None:
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
        assert serve.frame_relation_tuples(as_torch, f, top_k=7) == \
            jax_tuples(o, f, 7)


def video_frames(rs, n_frames=14, n_tracks=4):
    """Per-frame relation tuples of one video: tracks that drift by small
    steps (IoU around the 0.5 merge threshold), equal confidences, and
    empty frames at the start, in the middle and at the end."""
    tracks = [{"trip": [int(rs.randint(1, 6)), int(rs.randint(4)),
                        int(rs.randint(1, 6))],
               "s": rs.rand(4) * 100, "o": rs.rand(4) * 100,
               "conf": float(rs.choice([0.5, 0.5, rs.rand()]))}
              for _ in range(n_tracks)]
    for t in tracks:
        for k in ("s", "o"):
            t[k][2:] = t[k][:2] + 20 + rs.rand(2) * 40
    frames = []
    for i in range(n_frames):
        preds = []
        if i not in (0, 6, 7, n_frames - 1):
            for r, t in enumerate(tracks):
                step = rs.uniform(-6, 6, 2)
                for k in ("s", "o"):
                    t[k] = t[k] + np.concatenate([step, step])
                preds.append([t["conf"], list(t["trip"]),
                              [t["s"].tolist(), t["o"].tolist()], r])
        frames.append([i, preds])
    return frames


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_association_and_evaluate_match_jax(seed):
    rs = np.random.RandomState(100 + seed)
    fr = {f"v{v}": video_frames(rs) for v in range(3)}
    fr["empty"] = [[i, []] for i in range(12)]
    objects = [f"o{i}" for i in range(6)]
    predicates = [f"p{i}" for i in range(4)]
    ref = jax_assoc.association(copy.deepcopy(fr), objects=objects,
                                predicates=predicates)
    got = association.association(copy.deepcopy(fr), objects=objects,
                                  predicates=predicates)
    assert got == ref
    assert sum(len(v) for v in got.values()) > 0
    # ground truth: the association itself; predictions: shifted, rescored
    gt = {k: v for k, v in ref.items() if v}
    pred = copy.deepcopy(gt)
    for rels in pred.values():
        for r in rels:
            r["score"] = float(rs.rand())
            r["sub_traj"] = [[b[0] + 9, b[1], b[2] + 9, b[3]]
                             for b in r["sub_traj"]]
    kw = dict(verbose=False)
    assert (metrics.evaluate(copy.deepcopy(pred), gt, **kw)
            == jax_metrics.evaluate(copy.deepcopy(pred), gt, **kw))
    rec = {"v0": [{"sub_score": rs.rand(6).tolist(),
                   "obj_score": rs.rand(6).tolist(),
                   "pre_score": rs.rand(4).tolist(),
                   "triplet": [int(rs.randint(6)), int(rs.randint(4)),
                               int(rs.randint(6))]} for _ in range(5)]}
    assert (metrics.evaluate_recognition(rec, verbose=False)
            == jax_metrics.evaluate_recognition(rec, verbose=False))
    s, o_, r, prior = (rs.rand(5, 6), rs.rand(5, 6), rs.rand(5, 4),
                       rs.rand(5, 4))
    for a, b in zip(metrics.recognition_output(s, o_, r, prior, 4),
                    jax_metrics.recognition_output(s, o_, r, prior, 4)):
        np.testing.assert_array_equal(a, b)
