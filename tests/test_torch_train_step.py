"""Stage A's training step in the port against the JAX package on the CPU,
at the tiny configuration of tests/test_serve.py (res10, 64x80 frames,
``RPN_PRE/POST_NMS_TOP_N`` 200/32, target 16, ``BATCH_SIZE`` 16,
``RPN_BATCHSIZE`` 32, ``MAX_NUM_GT_BOXES`` 5) with anchor scales (1, 2, 4),
so that 64x80 frames hold anchors inside and the RPN losses are not 0.

One JAX training init (``mode="train_source"``) is carried into the port's
training tree with ``params_from_jax`` (a strict load: the trees are equal),
and both run under ``I2VSGG_DETERMINISTIC_SAMPLING=1``, where the anchor and
roi samples are equal. The RPN class kernel is scaled by 40, as the earlier
port tests do, so that no proposal's rank sits on a float near-tie. f32
compute (conftest sets JAX's matmul precision to "highest").

Tolerances: every loss term rtol 1e-4; every trainable parameter's gradient
within 1e-3 of its norm and at cosine >= 0.9999; the parameters after two
SGD steps (momentum, DOUBLE_BIAS, decay, the clip at 10) rtol 1e-5 with an
atol of 1e-3 of the tensor's largest update, the second step taken from
JAX's ``TrainState`` after the first, carried across (its momentum buffers
through ``params_from_jax``): two runs apart for two steps part further
than that where the first step's last bits move a near-zero input of
netD_style's signed square root or of a ReLU. The bf16-compute case holds
the losses
at rtol 2e-2 and the gradients at cosine >= 0.99: bf16 keeps 8 significant
bits (2^-8 = 3.9e-3 a rounding) and the two packages round convolutions
and their sums in different orders.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import optax

from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.train import det_da as jax_det_da
from i2vsgg_tpu.train.optim import make_label_fn, sgd_reference
from i2vsgg_tpu_torch.config import Config, TestConfig, TrainConfig
from i2vsgg_tpu_torch.models import backbones as port_bb
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.layers import init_weights
from i2vsgg_tpu_torch.train import det_da
from i2vsgg_tpu_torch.train.optim import ReferenceSGD, jax_path, param_label
from i2vsgg_tpu_torch.utils.weights import params_from_jax

N_CLASSES = 6
B, H, W = 2, 64, 80
TRAIN = dict(RPN_PRE_NMS_TOP_N=200, RPN_POST_NMS_TOP_N=32,
             RPN_POST_NMS_TOP_N_TARGET=16, RPN_BATCHSIZE=32, BATCH_SIZE=16,
             MAX_NUM_GT_BOXES=5)
TEST = dict(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16)
COMMON = dict(COMPUTE_DTYPE="float32", ANCHOR_SCALES=(1, 2, 4))
LOSS = dict(eta=0.1, eta_style=0.01, style_lambda=1.0)
LR, CLIP = 1e-3, 10.0


def jax_cfg(**kw):
    c = JaxConfig()
    return c.replace(TRAIN=c.TRAIN.__class__(**TRAIN),
                     TEST=c.TEST.__class__(**TEST), **{**COMMON, **kw})


def port_cfg(**kw):
    return Config().replace(TRAIN=TrainConfig(**TRAIN),
                            TEST=TestConfig(**TEST), **{**COMMON, **kw})


def make_batches(seed=0):
    rs = np.random.RandomState(seed)
    im_info = np.tile([[H, W, 1.0]], (B, 1)).astype(np.float32)
    gt = np.zeros((B, 5, 5), np.float32)
    for b in range(B):
        for k in range(3):
            x1, y1 = rs.uniform(0, 40, 2)
            w, h = rs.uniform(8, 30, 2)
            gt[b, k] = [x1, y1, min(x1 + w, W - 1), min(y1 + h, H - 1),
                        rs.randint(1, N_CLASSES)]
    src = {"image": (rs.randn(B, H, W, 3) * 10).astype(np.float32),
           "im_info": im_info, "gt_boxes": gt}
    tgt = {"image": (rs.randn(B, H, W, 3) * 10).astype(np.float32),
           "im_info": im_info}
    return src, tgt


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(autouse=True)
def deterministic_sampling(monkeypatch):
    monkeypatch.setenv("I2VSGG_DETERMINISTIC_SAMPLING", "1")


@pytest.fixture()
def no_dropout(monkeypatch):
    """VGG16's head dropout off in both packages (JAX's ``train_source``
    always draws it)."""
    class Identity(flax_nn.Module):
        rate: float = 0.0
        deterministic: bool = True

        def __call__(self, x):
            return x
    monkeypatch.setattr(flax_nn, "Dropout", Identity)
    monkeypatch.setattr(port_bb.VGG16Head, "dropout_rate", 0.0)


@functools.cache
def jax_init(backbone):
    """JAX's training init (``mode="train_source"``, jitted), numpy leaves,
    the RPN class kernel scaled by 40. The tree does not depend on ic, gc,
    the pooling mode or the compute dtype: both discriminators are built
    whole in training."""
    src, _ = make_batches()
    jm = JaxFasterRCNN(num_classes=N_CLASSES, cfg=jax_cfg(),
                       backbone=backbone, ic=True, gc=True)
    init = jax.jit(lambda rngs, *a: jm.init(rngs, *a, mode="train_source"))
    params = np_tree(init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "sampling2": jax.random.PRNGKey(2),
         "dropout": jax.random.PRNGKey(3)},
        jnp.asarray(src["image"]), jnp.asarray(src["im_info"]),
        jnp.asarray(src["gt_boxes"]))["params"])
    params = jax.tree_util.tree_map(lambda a: a.copy(), params)
    params["rpn"]["cls_score"]["kernel"] *= 40.0
    return params


def init_pair(backbone, ic, gc, jcfg, pcfg):
    """The JAX module and init, and the port's training tree loaded from
    it (a strict load)."""
    jm = JaxFasterRCNN(num_classes=N_CLASSES, cfg=jcfg, backbone=backbone,
                       ic=ic, gc=gc)
    params = jax_init(backbone)
    pm = FasterRCNN_DA(N_CLASSES, pcfg, backbone, ic=ic, gc=gc,
                       training_tree=True)
    pm.load_state_dict(params_from_jax(params))
    return jm, params, pm


def jax_grad_fn(jm, cr):
    def loss(p, bs, bt):
        return jax_det_da.det_da_loss(
            p, jm, bs, bt, {"sampling": jax.random.PRNGKey(1),
                            "sampling2": jax.random.PRNGKey(2),
                            "dropout": jax.random.PRNGKey(3)},
            cr=cr, **LOSS)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def T(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def J(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def check_grads(pm, jax_grads, cos_min=0.9999, frac=1e-3):
    ref = params_from_jax(np_tree(jax_grads))
    n = 0
    for name, p in pm.named_parameters():
        if not p.requires_grad:
            continue
        g, r = p.grad.double(), ref[name].double()
        norm = float(r.norm())
        assert float((g - r).abs().max()) <= frac * max(norm, 1e-12), name
        if norm > 0:
            cos = float((g * r).sum() / (g.norm() * r.norm()))
            assert cos >= cos_min, (name, cos)
        n += 1
    return n


def check_params(pm, want_tree, before_tree, rtol=1e-5):
    """Each parameter at rtol 1e-5, with an atol of 1e-3 of the largest
    magnitude of that tensor's update (the gradients' tolerance carried
    into the update: a bias that starts at 0 is all update)."""
    want = params_from_jax(want_tree)
    before = params_from_jax(before_tree)
    for name, p in pm.named_parameters():
        w = want[name].numpy()
        step = float(np.abs(w - before[name].numpy()).max())
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=rtol,
                                   atol=max(1e-3 * step, 1e-12),
                                   err_msg=name)


def jax_traces(opt_state):
    """The optax state's momentum traces as one params-shaped tree of
    numpy arrays (the masked leaves of each group dropped)."""
    out = {}

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                merge(dst.setdefault(k, {}), v)
            elif isinstance(v, (np.ndarray, jax.Array)):
                dst[k] = np.asarray(v)
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState)):
        if isinstance(leaf, optax.TraceState):
            merge(out, leaf.trace)
    return out


CASES = {
    # name: (backbone, ic, gc, cr, config overrides); RoIPool's backward
    # under POOLING_MODE=pool in the case without cr
    "res10_icgc_pool": ("res10", True, True, False, {"POOLING_MODE": "pool"}),
    "res10_icgc_cr": ("res10", True, True, True, {}),
    "vgg16_no_dropout": ("vgg16", True, True, False, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case, no_dropout):
    """Losses and gradients of a step, and the parameters after two SGD
    steps: the first from the common init, the second from JAX's state
    after its first step, carried across with its momentum buffers."""
    backbone, ic, gc, cr, over = CASES[case]
    jcfg, pcfg = jax_cfg(**over), port_cfg(**over)
    jm, p0, pm = init_pair(backbone, ic, gc, jcfg, pcfg)
    src, tgt = make_batches()
    grad_fn = jax_grad_fn(jm, cr)
    tx = sgd_reference(LR, jcfg, clip_norm=CLIP)
    update = jax.jit(tx.update)

    (_, jm0), g0 = grad_fn(p0, J(src), J(tgt))
    jm0 = {k: float(v) for k, v in jm0.items()}
    opt = ReferenceSGD(pm, LR, pcfg, clip_norm=CLIP)
    opt.zero_grad()
    loss, m0 = det_da.det_da_loss(pm, T(src), T(tgt),
                                  det_da.step_generator("cpu", 0, 0), cr=cr,
                                  **LOSS)
    loss.backward()
    assert set(m0) == set(jm0)
    for k in jm0:
        np.testing.assert_allclose(float(m0[k]), jm0[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert jm0["loss_rpn_cls"] > 0 and jm0["fg_cnt"] > 0
    assert check_grads(pm, g0) > 20
    opt.step(0)
    upd, s1 = update(g0, tx.init(p0), p0)
    p1 = np_tree(optax.apply_updates(p0, upd))
    check_params(pm, p1, p0)

    # step 2 from JAX's state after step 1, momentum included
    (_, jm1), g1 = grad_fn(p1, J(src), J(tgt))
    upd, _ = update(g1, s1, p1)
    p2 = np_tree(optax.apply_updates(p1, upd))
    pm.load_state_dict(params_from_jax(p1))
    opt = ReferenceSGD(pm, LR, pcfg, clip_norm=CLIP)
    opt.load_momentum(params_from_jax(jax_traces(s1)))
    m1 = det_da.train_step(det_da.TrainState(pm, opt, step=1), T(src),
                           T(tgt), cr=cr, **LOSS)
    for k in jm1:
        np.testing.assert_allclose(float(m1[k]), float(jm1[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    check_params(pm, p2, p1)


def test_train_step_bf16_matches_jax():
    """bf16 compute with f32 parameters (the drivers' default), ic+gc+cr:
    the losses within 2e-2 and every gradient at cosine >= 0.99 (see the
    module docstring for why bf16 holds no closer)."""
    jcfg = jax_cfg(COMPUTE_DTYPE="bfloat16")
    pcfg = port_cfg(COMPUTE_DTYPE="bfloat16")
    jm, params, pm = init_pair("res10", True, True, jcfg, pcfg)
    src, tgt = make_batches()
    (_, jm0), g0 = jax_grad_fn(jm, True)(params, J(src), J(tgt))
    ReferenceSGD(pm, LR, pcfg)
    loss, m0 = det_da.det_da_loss(pm, T(src), T(tgt),
                                  det_da.step_generator("cpu", 0, 0),
                                  cr=True, **LOSS)
    loss.backward()
    for k in jm0:
        np.testing.assert_allclose(float(m0[k]), float(jm0[k]), rtol=2e-2,
                                   atol=1e-4, err_msg=k)
    ref = params_from_jax(np_tree(g0))
    for name, p in pm.named_parameters():
        if p.requires_grad and float(ref[name].norm()) > 0:
            g, r = p.grad.double(), ref[name].double()
            cos = float((g * r).sum() / (g.norm() * r.norm()))
            assert cos >= 0.99, (name, cos)


@pytest.mark.parametrize("backbone", ["res10", "vgg16"])
def test_param_labels_match_jax(backbone):
    """Every parameter's optimizer group by JAX's ``make_label_fn`` on the
    JAX tree and by the port's ``param_label`` on the port's names: equal
    on every parameter; JAX's frozen FrozenBN leaves are the port's
    buffers (out of the optimizer); frozen params stop requiring grad."""
    jm, params, pm = init_pair(backbone, True, True, jax_cfg(), port_cfg())
    labels = make_label_fn(("trunk/conv1", "trunk/bn1"))(params)
    flat = {"/".join(getattr(k, "key", str(k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(labels)[0]}
    port = {jax_path(n): param_label(n) for n, _ in pm.named_parameters()}
    buffers = {jax_path(n) for n, _ in pm.named_buffers()}
    assert set(flat) == set(port) | buffers
    assert {k: flat[k] for k in port} == port
    assert all(flat[k] == "frozen" for k in buffers)
    ReferenceSGD(pm, LR, port_cfg())
    frozen = {n for n, p in pm.named_parameters() if not p.requires_grad}
    assert frozen == {n for n, _ in pm.named_parameters()
                      if param_label(n) == "frozen"}
    assert frozen, "conv1 is frozen"


def test_rpn_heads_get_no_gradient_from_rcnn_losses():
    """Mirror of tests/test_faster_rcnn.py:79: the RPN outputs are detached
    before the proposals, so the RCNN losses leave the RPN heads without
    gradient and reach the trunk through the pooled features."""
    _, _, pm = init_pair("res10", True, True, jax_cfg(), port_cfg())
    src, _ = make_batches()
    out = pm.train_source(*T(src).values(),
                          generator=det_da.step_generator("cpu", 0, 0))
    (out["rcnn_loss_cls"] + out["rcnn_loss_bbox"]).backward()
    for name in ("conv", "cls_score", "bbox_pred"):
        for p in getattr(pm.rpn, name).parameters():
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, name
    assert float(pm.trunk.layer3.block0.conv1.weight.grad.norm()) > 0


def test_det_losses_decrease_over_steps(monkeypatch):
    """Mirror of tests/test_faster_rcnn.py:226: repeated steps on one batch
    drive the detection losses down (signs of the updates, the GRL's
    direction, frozen BN), with random sampling from a fixed generator."""
    monkeypatch.delenv("I2VSGG_DETERMINISTIC_SAMPLING")
    _, _, pm = init_pair("res10", True, True, jax_cfg(), port_cfg())
    src, tgt = make_batches()
    state = det_da.TrainState(pm, ReferenceSGD(pm, 2e-3, port_cfg()))
    losses = []
    for i in range(12):
        state.step = 0                       # the same roi sample each step
        m = det_da.train_step(state, T(src), T(tgt), eta=1e-4,
                              eta_style=1e-5, style_lambda=1e-3, cr=False)
        det = float(m["loss_rcnn_cls"]) + float(m["loss_rcnn_box"])
        assert np.isfinite(det), i
        losses.append(det)
    assert np.mean(losses[-3:]) < losses[0], losses


def test_chain_raises_under_grad(monkeypatch):
    """The bottleneck chain (B4) is forward-only: with the switch on and
    grad enabled on a trainable tail, the stage raises and says why; under
    ``no_grad`` (serving) it runs the chain."""
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", "1")
    stage = port_bb.ResNetStage(256, 128, 3, 1, dtype=torch.float32)
    init_weights(stage, torch.Generator().manual_seed(0))
    x = torch.randn(1, 256, 8, 10)
    with pytest.raises(ValueError, match="forward-only"):
        stage(x)
    calls = []
    real = port_bb.bottleneck_chain
    monkeypatch.setattr(port_bb, "bottleneck_chain",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        assert stage(x).shape == (1, 512, 8, 10)
    assert calls == [1]
