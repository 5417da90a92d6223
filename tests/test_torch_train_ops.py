"""The pieces of the port's Stage A training against the JAX package on the
CPU: the box ops of the targets, anchor and roi targets, the RoI ops'
backwards against ``jax.vjp``, the GRL, the training inits, the clip, the
checkpoints' training halves and the ``--pretrained_backbone`` maps.

Tolerances: box ops rtol 1e-6; targets under
``I2VSGG_DETERMINISTIC_SAMPLING=1`` with labels and weights equal and
regression targets rtol 1e-5 (in random mode, where jax.random and torch
draw different numbers, the counts of fg and bg anchors and rois are
equal); RoIAlignAvg's backward rtol 1e-5 on f32 maps (atol 1e-5 of the
largest magnitude) and within one bf16 ulp on bf16 maps (plus 2^-20 of the
largest magnitude where a sum cancels to near 0, >= 99.9 % bit-equal, as
tests/test_torch_roi_align.py holds the forward); RoIPool's backward equal
on f32 maps, with tied maxima and empty and out-of-map bins.
"""

import math
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import chip_smoke
from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.models import targets as jax_targets
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.ops import boxes as jax_boxes
from i2vsgg_tpu.ops import roi_align as jax_ra
from i2vsgg_tpu.ops import roi_pool as jax_rp
from i2vsgg_tpu.ops.anchors import generate_anchors, shifted_anchors
from i2vsgg_tpu.utils import torch_import as jax_ti
from i2vsgg_tpu_torch.config import Config
from i2vsgg_tpu_torch.models import targets
from i2vsgg_tpu_torch.models.discriminators import NetDStyle, grad_reverse
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.inits import init_module
from i2vsgg_tpu_torch.models.layers import Conv, Dense
from i2vsgg_tpu_torch.ops import boxes
from i2vsgg_tpu_torch.ops import roi_align as ra
from i2vsgg_tpu_torch.ops import roi_pool as rp
from i2vsgg_tpu_torch.train import checkpoint
from i2vsgg_tpu_torch.train.optim import ReferenceSGD, step_decay_schedule
from i2vsgg_tpu_torch.utils import torch_import as ti
from i2vsgg_tpu_torch.utils.weights import params_from_jax


def T(a):
    return torch.as_tensor(np.array(a))


def rand_boxes(rs, n, h=128, w=160, lo=6, hi=60):
    x1 = rs.uniform(0, w - lo, n)
    y1 = rs.uniform(0, h - lo, n)
    bw, bh = rs.uniform(lo, hi, (2, n))
    return np.stack([x1, y1, np.minimum(x1 + bw, w - 1),
                     np.minimum(y1 + bh, h - 1)], 1).astype(np.float32)


def gt_padded(rs, k=4, pad=2, n_cls=6):
    gt = np.zeros((k + pad, 5), np.float32)
    gt[:k, :4] = rand_boxes(rs, k, lo=16)
    gt[:k, 4] = rs.randint(1, n_cls, k)
    return gt


# -- boxes -------------------------------------------------------------------

def test_box_ops_match_jax():
    rs = np.random.RandomState(0)
    a, b = rand_boxes(rs, 30), rand_boxes(rs, 30)
    np.testing.assert_allclose(
        boxes.encode_boxes(T(a), T(b)).numpy(),
        np.asarray(jax_boxes.encode_boxes(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)
    gt = gt_padded(rs)
    cand = np.concatenate([a, np.zeros((3, 4), np.float32)])  # padded rows
    got = boxes.pairwise_iou_padded(T(cand), T(gt)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_boxes.pairwise_iou_padded(
        jnp.asarray(cand), jnp.asarray(gt))), rtol=1e-6, atol=1e-7)
    assert (got[-3:] == -1).all() and (got[:, -2:] <= 0).all()
    pred, tgt = rs.randn(2, 3, 40, 4).astype(np.float32)
    w_in = (rs.rand(3, 40, 4) > 0.5).astype(np.float32)
    w_out = rs.rand(3, 40, 4).astype(np.float32)
    for sigma, dims in ((1.0, (-1,)), (3.0, (-1, -2))):
        np.testing.assert_allclose(
            float(boxes.smooth_l1_loss(T(pred), T(tgt), T(w_in), T(w_out),
                                       sigma, dims)),
            float(jax_boxes.smooth_l1_loss(*map(jnp.asarray, (pred, tgt,
                                                              w_in, w_out)),
                                           sigma, dims)), rtol=1e-6)


# -- targets -----------------------------------------------------------------

def anchor_case(seed):
    rs = np.random.RandomState(seed)
    base = generate_anchors(scales=(2, 4, 8))
    anchors = np.asarray(shifted_anchors(8, 10, 16, base))
    return anchors, gt_padded(rs), np.asarray([128, 160, 1.0], np.float32)


def roi_case(seed, n=60, pad=12):
    rs = np.random.RandomState(seed)
    gt = gt_padded(rs)
    # half the proposals jittered around the gt boxes, so that fg exists
    near = gt[rs.randint(0, 4, n // 2), :4] + rs.randn(n // 2, 4) * 4
    rois = np.zeros((n + pad, 5), np.float32)
    rois[:n, 1:] = np.concatenate([near, rand_boxes(rs, n - n // 2)])
    valid = np.arange(n + pad) < n
    return rois, valid, gt


ANCHOR_KW = dict(batch_size=64)
ROI_KW = dict(rois_per_image=32)


@pytest.mark.parametrize("seed", [0, 1])
def test_anchor_targets_match_jax_deterministic(seed, monkeypatch):
    monkeypatch.setenv("I2VSGG_DETERMINISTIC_SAMPLING", "1")
    anchors, gt, info = anchor_case(seed)
    want = jax_targets.anchor_targets(jax.random.PRNGKey(0),
                                      jnp.asarray(anchors), jnp.asarray(gt),
                                      jnp.asarray(info), **ANCHOR_KW)
    got = targets.anchor_targets(None, T(anchors), T(gt), T(info),
                                 **ANCHOR_KW)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels == 1).any() and (got.labels == 0).any()
    for k in ("inside_weights", "outside_weights"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_proposal_targets_match_jax_deterministic(seed, monkeypatch):
    monkeypatch.setenv("I2VSGG_DETERMINISTIC_SAMPLING", "1")
    rois, valid, gt = roi_case(seed)
    want = jax_targets.proposal_targets(
        jax.random.PRNGKey(0), jnp.asarray(rois), jnp.asarray(valid),
        jnp.asarray(gt), 1, **ROI_KW)
    got = targets.proposal_targets(None, T(rois), T(valid), T(gt), 1,
                                   **ROI_KW)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels > 0).any() and (got.labels == 0).any()
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    for k in ("inside_weights", "outside_weights"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-5,
                               atol=1e-6)


def test_targets_random_mode_counts_match_jax(monkeypatch):
    """Random mode: different draws, the same counts of fg and bg anchors
    and rois (and so the same fg fraction); the port's draws come from the
    generator (reproducible) and are not the first-k of the deterministic
    mode."""
    monkeypatch.delenv("I2VSGG_DETERMINISTIC_SAMPLING", raising=False)
    anchors, gt, info = anchor_case(0)
    want = jax_targets.anchor_targets(jax.random.PRNGKey(0),
                                      jnp.asarray(anchors), jnp.asarray(gt),
                                      jnp.asarray(info), **ANCHOR_KW)
    runs = [targets.anchor_targets(torch.Generator().manual_seed(s),
                                   T(anchors), T(gt), T(info), **ANCHOR_KW)
            for s in (0, 0, 1)]
    wl = np.asarray(want.labels)
    for got in runs:
        for v in (0, 1):
            assert int((got.labels == v).sum()) == int((wl == v).sum()), v
    assert torch.equal(runs[0].labels, runs[1].labels)
    assert not torch.equal(runs[0].labels, runs[2].labels)

    rois, valid, gt = roi_case(0)
    want = jax_targets.proposal_targets(
        jax.random.PRNGKey(0), jnp.asarray(rois), jnp.asarray(valid),
        jnp.asarray(gt), 0, **ROI_KW)
    got = targets.proposal_targets(torch.Generator().manual_seed(0), T(rois),
                                   T(valid), T(gt), 0, **ROI_KW)
    wl = np.asarray(want.labels)
    assert int((got.labels > 0).sum()) == int((wl > 0).sum()) > 0
    assert int((got.labels == 0).sum()) == int((wl == 0).sum()) > 0


# -- RoI backwards -----------------------------------------------------------

def rand_rois(rs, n, b, h, w):
    xy = rs.rand(b * n, 4) * [w * 1.2, h * 1.2, w * 1.2, h * 1.2] - 40
    bx = np.concatenate([np.minimum(xy[:, :2], xy[:, 2:]),
                         np.maximum(xy[:, :2], xy[:, 2:])], 1)
    return np.concatenate([np.repeat(np.arange(b), n)[:, None], bx],
                          1).astype(np.float32)


def bf16_ulp(x):
    a = np.abs(np.asarray(x, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_backward_matches_jax_vjp(dtype):
    rs = np.random.RandomState(0)
    b, h, w, c = 2, 9, 12, 16
    f = rs.randn(b, h, w, c).astype(np.float32)
    rois = np.concatenate([
        rand_rois(rs, 10, b, h * 16, w * 16),
        chip_smoke.align_edge_rois("cpu", b).numpy()])
    rois = rois[np.argsort(rois[:, 0], kind="stable")]        # grouped
    g = rs.randn(rois.shape[0], 7, 7, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fj = jnp.asarray(f).astype(jdt)
    _, vjp = jax.vjp(lambda x: jax_ra.roi_align_avg(x, jnp.asarray(rois),
                                                    7, 7, 1 / 16), fj)
    want = np.asarray(vjp(jnp.asarray(g).astype(jdt))[0].astype(jnp.float32))
    ft = torch.from_numpy(f).to(getattr(torch, dtype)).requires_grad_(True)
    out = ra.roi_align_avg(ft, torch.from_numpy(rois), 7, 7, 1 / 16)
    out.backward(torch.from_numpy(g).to(ft.dtype))
    got = ft.grad.float().numpy()
    assert ra.roi_align_avg.launches == 0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        # the same f32 sums in another order, rounded once: one bf16 ulp,
        # and where the sum cancels to near 0, f32's error on the terms
        d = np.abs(got - want)
        assert (d <= bf16_ulp(want) + 2.0 ** -20 * np.abs(want).max()).all()
        assert (d == 0).mean() >= 0.999
    # the same function as autograd of the plain version
    fp = torch.from_numpy(f).requires_grad_(True)
    ra.roi_align_avg_plain(fp, torch.from_numpy(rois)).backward(
        torch.from_numpy(g))
    if dtype == "float32":
        np.testing.assert_allclose(got, fp.grad.numpy(), rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_roi_pool_backward_matches_jax_vjp_with_ties():
    """A map after a ReLU with small integer values: most bins hold tied
    maxima (many all zero); rois partly and wholly outside the map, and
    degenerate ones. JAX's VJP splits a bin's gradient evenly among its tied
    maxima; so must the port's. Bins here span at most 4 cells a side and
    the cotangents are multiples of 144 = (lcm 1..4)^2, so every split and
    every sum is an exact f32 integer and the two must be equal."""
    rs = np.random.RandomState(0)
    b, h, w, c = 2, 10, 13, 8
    f = np.maximum(rs.randint(-3, 3, (b, h, w, c)), 0).astype(np.float32)
    edge = np.asarray([[1, -40, -40, 60, 50], [1, 300, 300, 400, 400],
                       [1, 0, 0, 0, 0], [1, 10, 10, 12, 150],
                       [1, 150, 20, 260, 190]], np.float32)
    rois = np.concatenate([rand_rois(rs, 12, b, h * 16, w * 16), edge])
    rois = rois[np.argsort(rois[:, 0], kind="stable")]
    g = (rs.randint(-4, 5, (rois.shape[0], 7, 7, c)) * 144).astype(
        np.float32)
    _, vjp = jax.vjp(lambda x: jax_rp.roi_pool(x, jnp.asarray(rois), 7, 7,
                                               1 / 16, grouped=True),
                     jnp.asarray(f))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    ft = torch.from_numpy(f).requires_grad_(True)
    out = rp.roi_pool(ft, torch.from_numpy(rois), 7, 7, 1 / 16)
    out.backward(torch.from_numpy(g))
    assert rp.roi_pool.launches == 0
    np.testing.assert_array_equal(ft.grad.numpy(), want)
    # ties were split: some cell got a share that is not a multiple of 144
    assert (want % 144 != 0).any()
    # a chunk size that splits the rois gives the same sum
    np.testing.assert_array_equal(
        rp.roi_pool_backward(torch.from_numpy(g), torch.from_numpy(f),
                             torch.from_numpy(rois), chunk=5).numpy(), want)


# -- GRL, inits, optimizer -----------------------------------------------------

def test_grl_reverses_and_scales():
    """Mirror of tests/test_netd_style.py:59 (the gradient wrt the input
    scales with -lambda), and the identity forward."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(1, 4, 4, 512).astype(np.float32))
    mod = init_module(NetDStyle(torch.float32),
                      torch.Generator().manual_seed(0))

    def grad(lamb):
        xi = x.clone().requires_grad_(True)
        (mod(xi, lamb, prob=True)[0] ** 2).sum().backward()
        return xi.grad
    g_pos, g_neg, g_half = grad(1.0), grad(-1.0), grad(0.5)
    np.testing.assert_allclose(g_pos.numpy(), -g_neg.numpy(), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(g_half.numpy(), 0.5 * g_pos.numpy(),
                               rtol=1e-5, atol=1e-9)
    assert float(g_pos.abs().sum()) > 0
    xi = x.clone().requires_grad_(True)
    y = grad_reverse(xi, 0.3)
    assert torch.equal(y, x)
    y.sum().backward()
    assert torch.allclose(xi.grad, torch.full_like(x, -0.3))


def _std(t):
    return float(t.double().std())


def test_detector_init_distributions():
    """Mirror of tests/test_inits.py:30: the reference's head inits, and
    flax's lecun_normal (truncated at 2 std) on the rest; the same
    distributions as JAX's init of the same tree."""
    cfg = Config().replace(COMPUTE_DTYPE="float32")
    m = init_module(FasterRCNN_DA(6, cfg, "res10", ic=True, gc=True,
                                  training_tree=True),
                    torch.Generator().manual_seed(0))
    for name in ("conv", "cls_score", "bbox_pred"):
        conv = getattr(m.rpn, name)
        assert abs(_std(conv.weight) - 0.01) < 0.002, name
        assert float(conv.bias.abs().max()) == 0.0
    assert abs(_std(m.cls_score.weight) - 0.01) < 0.002
    assert abs(_std(m.bbox_pred.weight) - 0.001) < 0.0002
    for name in ("conv1", "conv2", "conv3"):
        assert abs(_std(getattr(m.netD_pixel, name).weight) - 0.01) < 0.003
    for name in ("fc_1", "fc_2"):
        fc = getattr(m.netD_style, name)
        assert abs(_std(fc.weight) - math.sqrt(2 / 2560)) < 0.003
        bound = 1 / math.sqrt(512)
        assert float(fc.bias.abs().max()) <= bound
        assert float(fc.bias.abs().max()) > 0.5 * bound
    # lecun_normal: variance 1/fan_in, nothing past 2 (pre-scale) std
    wt = m.trunk.layer3.block0.conv2.weight
    fan_in = wt[0].numel()
    assert abs(_std(wt) * math.sqrt(fan_in) - 1.0) < 0.02
    assert float(wt.abs().max()) <= 2 / 0.87962566103423978 / math.sqrt(
        fan_in) * (1 + 1e-6)
    # against JAX's init of the same tree: each tensor's std within 5 %
    jcfg = JaxConfig().replace(COMPUTE_DTYPE="float32")
    jm = JaxFasterRCNN(num_classes=6, cfg=jcfg, backbone="res10", ic=True,
                       gc=True)
    jp = jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, 64, 80, 3)), jnp.asarray([[64, 80, 1.0]]),
        jnp.zeros((1, 5, 5)), mode="train_source"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "sampling2": jax.random.PRNGKey(2),
         "dropout": jax.random.PRNGKey(3)})["params"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in m.named_parameters():
        if p.numel() >= 4096:
            assert abs(_std(p) / _std(want[name]) - 1) < 0.05, name


class Tiny(nn.Module):
    """The JAX checkpoint tests' tree (tests/test_checkpoint.py:19)."""

    def __init__(self, n_cls=4, seed=0):
        super().__init__()
        self.trunk = nn.Module()
        self.trunk.conv1 = Conv(3, 8, 3, bias=False)
        self.trunk.layer1 = Conv(8, 8, 1)
        self.rpn = nn.Module()
        self.rpn.conv = Conv(8, 8, 1, bias=False)
        self.rpn.cls_score = Conv(8, 2, 1)
        self.cls_score = Dense(8, n_cls)
        self.bbox_pred = Dense(8, 4 * n_cls)
        self.netD_pixel = nn.Module()
        self.netD_pixel.conv1 = Conv(8, 4, 1, bias=False)
        self.netD_style = nn.Module()
        self.netD_style.fc = Dense(8, 1)
        init_module(self, torch.Generator().manual_seed(seed))


def _clip_case(frozen_scale):
    m = Tiny()
    opt = ReferenceSGD(m, 1.0, Config(), clip_norm=1.0)
    for name, p in m.named_parameters():
        p.grad = torch.full_like(p, 3.0)
    # what autograd would give a frozen param is never read: it has none
    m.trunk.conv1.weight.grad = torch.full_like(m.trunk.conv1.weight,
                                                frozen_scale)
    return m, opt


def test_clip_ignores_frozen_and_matches_torch():
    """Mirror of tests/test_optim_clip.py:31/45: the norm is over the
    non-frozen grads (a frozen grad of any size changes nothing), the clip
    scales them by clip / norm, as ``clip_grad_norm_`` does, and frozen
    params get no update."""
    m, opt = _clip_case(0.0)
    big, opt_big = _clip_case(1e6)
    norm = float(opt.clip())
    assert norm == pytest.approx(float(opt_big.clip()))
    trainable = [p for n, p in Tiny().named_parameters()
                 if n != "trunk.conv1.weight"]
    want = math.sqrt(sum(9.0 * p.numel() for p in trainable))
    assert norm == pytest.approx(want, rel=1e-6)
    for (n, p), (_, q) in zip(m.named_parameters(), big.named_parameters()):
        if n != "trunk.conv1.weight":
            assert torch.equal(p.grad, q.grad)
            np.testing.assert_allclose(p.grad.numpy(), 3.0 / want,
                                       rtol=1e-6)
    ref = [torch.zeros_like(p).requires_grad_(True) for p in trainable]
    for r in ref:
        r.grad = torch.full_like(r, 3.0)
    torch.nn.utils.clip_grad_norm_(ref, 1.0)
    np.testing.assert_allclose(ref[0].grad.numpy(), 3.0 / want, rtol=1e-5)
    w0 = m.trunk.conv1.weight.detach().clone()
    opt.step(0)
    assert torch.equal(m.trunk.conv1.weight, w0)
    # weight: -lr * (g * scale + wd * p); bias at twice the lr, no decay
    assert opt.opt.param_groups[1]["lr"] == 2.0


def test_step_decay_schedule():
    s = step_decay_schedule(1e-3, 2, 0.1, steps_per_epoch=5)
    assert [s(i) for i in (0, 9, 10, 19, 20)] == pytest.approx(
        [1e-3, 1e-3, 1e-4, 1e-4, 1e-5])


# -- checkpoints ---------------------------------------------------------------

def stepped(seed=0, n_cls=4):
    m = Tiny(n_cls, seed)
    opt = ReferenceSGD(m, 1e-3, Config())
    for p in opt.params():
        p.grad = torch.ones_like(p)
    opt.step(0)
    return m, opt


def test_full_resume_roundtrip(tmp_path):
    m, opt = stepped()
    checkpoint.save_checkpoint(str(tmp_path), m.state_dict(), 7,
                               {"session": 1, "epoch": 3,
                                "pooling_mode": "align"},
                               optimizer_state=opt.state_dict())
    assert checkpoint.latest_step(str(tmp_path)) == 7
    fresh = Tiny(seed=99)
    fopt = ReferenceSGD(fresh, 1e-3, Config())
    assert checkpoint.restore_full(str(tmp_path), 7, fresh, fopt) == 7
    for (n, p), q in zip(m.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), n
    mom, fmom = opt.momentum(), fopt.momentum()
    assert set(mom) == set(fmom) and len(mom) == 12
    assert all(torch.equal(mom[k], fmom[k]) for k in mom)
    assert checkpoint.load_metadata(str(tmp_path), 7)["pooling_mode"] == \
        "align"


def test_detector_init_skips_heads(tmp_path):
    """The reference's exclusion list: netD_pixel and the RPN/RCNN
    cls/bbox heads keep their init; the trunk, the RPN conv and netD_style
    load."""
    m, _ = stepped()
    checkpoint.save_checkpoint(str(tmp_path), m.state_dict(), 7)
    init = Tiny(seed=42)
    before = {k: v.clone() for k, v in init.state_dict().items()}
    checkpoint.restore_detector_init(str(tmp_path), 7, init)
    got, src = init.state_dict(), m.state_dict()
    for k in got:
        skipped = k.split(".")[0] in ("netD_pixel", "cls_score",
                                      "bbox_pred") or \
            k.startswith("rpn.cls_score")
        assert torch.equal(got[k], before[k] if skipped else src[k]), k


def test_intersection_keeps_mismatched_heads(tmp_path):
    m, _ = stepped()
    checkpoint.save_checkpoint(str(tmp_path), m.state_dict(), 7)
    init = Tiny(n_cls=9, seed=42)
    fresh = init.cls_score.weight.detach().clone()
    stats = checkpoint.restore_intersection(str(tmp_path), 7, init)
    assert torch.equal(init.trunk.conv1.weight, m.trunk.conv1.weight)
    assert torch.equal(init.cls_score.weight, fresh)
    assert stats["copied"] == stats["named"] - 4


def test_gc_keeps_last_k_and_best(tmp_path):
    m, opt = stepped()
    metrics = {1: 0.10, 2: 0.90, 3: 0.50, 4: 0.40, 5: 0.30}
    for step, v in metrics.items():
        checkpoint.save_checkpoint(str(tmp_path), m.state_dict(), step,
                                   {"epoch": step}, metric=v, keep_last=2,
                                   optimizer_state=opt.state_dict())

    def kept():
        return sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                      if d.startswith("step_"))
    assert checkpoint.best_checkpoint(str(tmp_path))["step"] == 2
    assert kept() == [2, 4, 5]
    assert checkpoint.restore_full(str(tmp_path), 2, Tiny(),
                                   ReferenceSGD(Tiny(), 1e-3, Config())) == 2
    checkpoint.gc_checkpoints(str(tmp_path), 1)
    assert kept() == [2, 5]


# -- --pretrained_backbone maps -----------------------------------------------

def torchvision_resnet_sd(rs, depth=10):
    from i2vsgg_tpu_torch.models.backbones import RESNET_STAGES
    sd = {"conv1.weight": rs.randn(64, 3, 7, 7)}

    def bn(p, c):
        sd.update({f"{p}.weight": rs.rand(c) + 0.5, f"{p}.bias": rs.randn(c),
                   f"{p}.running_mean": rs.randn(c),
                   f"{p}.running_var": rs.rand(c) + 0.5})
    bn("bn1", 64)
    cin = 64
    for li, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                         RESNET_STAGES[depth])):
        for i in range(n):
            p = f"layer{li + 1}.{i}"
            sd[f"{p}.conv1.weight"] = rs.randn(planes, cin, 1, 1)
            sd[f"{p}.conv2.weight"] = rs.randn(planes, planes, 3, 3)
            sd[f"{p}.conv3.weight"] = rs.randn(planes * 4, planes, 1, 1)
            for j, c in ((1, planes), (2, planes), (3, planes * 4)):
                bn(f"{p}.bn{j}", c)
            if i == 0:
                sd[f"{p}.downsample.0.weight"] = rs.randn(planes * 4, cin, 1,
                                                          1)
                bn(f"{p}.downsample.1", planes * 4)
            cin = planes * 4
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}


def vgg16_sd(rs):
    sd, cin = {}, 3
    convs = [v for v in (64, 64, 128, 128, 256, 256, 256, 512, 512, 512,
                         512, 512, 512)]
    for idx, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                         convs):
        sd[f"features.{idx}.weight"] = rs.randn(cout, cin, 3, 3)
        sd[f"features.{idx}.bias"] = rs.randn(cout)
        cin = cout
    sd["classifier.0.weight"] = rs.randn(64, 512 * 49)
    sd["classifier.0.bias"] = rs.randn(64)
    sd["classifier.3.weight"] = rs.randn(64, 64)
    sd["classifier.3.bias"] = rs.randn(64)
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}


def test_pretrained_maps_match_jax():
    """A seeded torchvision-layout ResNet state dict and a VGG16 one
    through both packages' maps: the trees are equal, name for name and
    value for value (VGG16's fc6/fc7 narrowed to 64 rows, see below)."""
    rs = np.random.RandomState(0)
    sd = torchvision_resnet_sd(rs)
    got = {**ti.prefixed("trunk", ti.resnet_trunk_params(sd, 10)),
           **ti.prefixed("head", ti.resnet_head_params(sd, 10))}
    want = params_from_jax({"trunk": jax_ti.resnet_trunk_params(sd, 10),
                            "head": jax_ti.resnet_head_params(sd, 10)})
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    # and into the port's detector, strictly
    cfg = Config().replace(COMPUTE_DTYPE="float32")
    det = FasterRCNN_DA(6, cfg, "res10")
    ti.merge_imported(det, got)
    assert torch.equal(det.trunk.bn1.var, sd["bn1.running_var"])

    sd = vgg16_sd(rs)
    got = ti.prefixed("trunk", ti.vgg16_trunk_params(sd))
    want = params_from_jax({"trunk": jax_ti.vgg16_trunk_params(sd)})
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    # fc6/fc7: JAX's map reshapes fc6 to 4096 rows; at the narrowed width
    # the port's is held to the function it must keep: the torchvision
    # layer on the CHW flatten equals the mapped one on the HWC flatten
    head = ti.vgg16_head_params(sd)
    x = torch.from_numpy(rs.randn(3, 7, 7, 512).astype(np.float32))
    ref = torch.nn.functional.linear(x.permute(0, 3, 1, 2).reshape(3, -1),
                                     sd["classifier.0.weight"],
                                     sd["classifier.0.bias"])
    out = torch.nn.functional.linear(x.reshape(3, -1), head["fc6.weight"],
                                     head["fc6.bias"])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-3)
    assert torch.equal(head["fc7.weight"], sd["classifier.3.weight"])
