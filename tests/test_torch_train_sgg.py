"""Stage B's training step in the port against the JAX package on the CPU,
at the tiny configuration of tests/test_sgg.py: res10, 64x80 frames, 5
padded GT boxes and 8 padded pairs an image, 7 predicates, a head of
``emb_dim`` 32 and ``fc_dim`` 64 with ``spatial_type`` 2 and
``use_obj_visual``, f32 compute (conftest sets JAX's matmul precision to
"highest").

One JAX init crosses into the port with ``params_from_jax`` (a strict
load). Dropout is on: the two packages cannot draw the same masks, so the
test recovers JAX's from one application of its head with
``capture_intermediates`` (``Dropout_0``/``Dropout_1`` hold the dropped
outputs, ``fc6``/``fc7`` the inputs to their ReLUs: where relu(fc) > 0 the
unit was kept iff its output is not 0; elsewhere it is 0 either way, and so
is its gradient) and feeds them to the port by replacing
``models/sgg.py::dropout``. Under ``jax.vmap`` every image of a batch gets
the same masks (one key), as the port's step draws them.

Tolerances: the loss rtol 1e-5; every ``vrd`` gradient within 1e-4 of its
norm and at cosine >= 0.99999; the parameters after the SGD update rtol
1e-5 with an atol of 1e-3 of the tensor's largest update (a tensor's update
carries the gradients' tolerance; tests/test_torch_train_step.py's rule);
``bce_multilabel_loss`` rtol 1e-6.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.models.backbones import ResNetTrunk as JaxResNetTrunk
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.models.sgg import SGGModel as JaxSGGModel
from i2vsgg_tpu.models.sgg import VRDHead as JaxVRDHead
from i2vsgg_tpu.models.sgg import bce_multilabel_loss as jax_bce
from i2vsgg_tpu.train import checkpoint as jax_ckpt
from i2vsgg_tpu.train import sgg as jax_sgg
from i2vsgg_tpu.train.det_da import TrainState as JaxTrainState
from i2vsgg_tpu.train.det_da import create_train_state
from i2vsgg_tpu_torch.config import Config
from i2vsgg_tpu_torch.models import sgg as sgg_mod
from i2vsgg_tpu_torch.models.backbones import ResNetTrunk
from i2vsgg_tpu_torch.models.inits import init_module
from i2vsgg_tpu_torch.models.layers import Conv, Dense
from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
from i2vsgg_tpu_torch.train import checkpoint
from i2vsgg_tpu_torch.train import sgg
from i2vsgg_tpu_torch.train.det_da import TrainState, step_generator
from i2vsgg_tpu_torch.train.optim import jax_path, param_label
from i2vsgg_tpu_torch.utils.weights import params_from_jax
from tests.test_torch_train_step import check_params, jax_traces, np_tree
from tools import jax_to_torch_checkpoint

N_REL, G, P = 7, 5, 8
B, H, W = 2, 64, 80
EMB, FC = 32, 64
LR = 1e-3


def make_batch(seed=0):
    """Two images: the first with 5 valid pairs (multi-label rows), the
    second with none."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    for b in range(B):
        for k in range(G):
            x1, y1 = rs.uniform(0, 40, 2)
            w, h = rs.uniform(8, 30, 2)
            boxes[b, k] = [x1, y1, min(x1 + w, W - 1), min(y1 + h, H - 1)]
    ix1 = rs.randint(0, G, (B, P)).astype(np.int32)
    ix2 = ((ix1 + 1 + rs.randint(0, G - 1, (B, P))) % G).astype(np.int32)
    pv = np.zeros((B, P), bool)
    pv[0, :5] = True
    labels = (rs.rand(B, P, N_REL) < 0.3).astype(np.float32)
    return {"image": (rs.randn(B, H, W, 3) * 10).astype(np.float32),
            "im_info": np.tile([[H, W, 1.0]], (B, 1)).astype(np.float32),
            "obj_boxes": boxes, "ix1": ix1, "ix2": ix2, "pair_valid": pv,
            "rel_labels": labels}


def J(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def T(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["ix1"], out["ix2"] = out["ix1"].long(), out["ix2"].long()
    return out


def prd_vecs():
    return np.random.RandomState(1).randn(N_REL, 300).astype(np.float32)


def jax_model(pooling):
    return JaxSGGModel(trunk=JaxResNetTrunk(depth=10, dtype=jnp.float32),
                       vrd=JaxVRDHead(emb_dim=EMB, fc_dim=FC,
                                      pooling=pooling),
                       n_rel=N_REL)


def port_model(pooling):
    return SGGModel(VRDHead(emb_dim=EMB, fc_dim=FC, pooling=pooling),
                    trunk=ResNetTrunk(depth=10, dtype=torch.float32))


@functools.cache
def jax_init(pooling):
    """JAX's init of the tiny model (numpy leaves); the tree does not
    depend on the pooling."""
    jm = jax_model(pooling)
    b = make_batch()
    p = jax.jit(lambda k: jm.init(
        {"params": k, "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(b["image"][:1]), jnp.asarray(b["im_info"][0]),
        jnp.asarray(b["obj_boxes"][0]), jnp.zeros((G,), jnp.int32),
        jnp.asarray(b["ix1"][0]), jnp.asarray(b["ix2"][0]),
        jnp.asarray(b["pair_valid"][0]), jnp.asarray(prd_vecs()))["params"])(
        jax.random.PRNGKey(0))
    return np_tree(p)


def init_pair(pooling):
    jm = jax_model(pooling)
    params = jax_init(pooling)
    pm = port_model(pooling)
    pm.load_state_dict(params_from_jax(params))
    return jm, params, pm


def jax_masks(jm, params, batch, key):
    """JAX's dropout masks of ``key`` after fc6 and fc7, as bool tensors
    (from its head on the first image: every image draws the same)."""
    _, st = jm.apply(
        {"params": params}, batch["image"][:1], batch["im_info"][0],
        batch["obj_boxes"][0], jnp.zeros((G,), jnp.int32), batch["ix1"][0],
        batch["ix2"][0], batch["pair_valid"][0], jnp.asarray(prd_vecs()),
        deterministic=False, rngs={"dropout": key},
        capture_intermediates=True, mutable=["intermediates"])
    inter = st["intermediates"]["vrd"]
    masks = []
    for fc, drop in (("fc6", "Dropout_0"), ("fc7", "Dropout_1")):
        pre = np.asarray(inter[fc]["__call__"][0])
        out = np.asarray(inter[drop]["__call__"][0])
        masks.append(torch.from_numpy(np.where(pre > 0, out != 0, True)))
    return masks


class FedMasks:
    """Stands in for ``models/sgg.py::dropout``: applies ``masks`` (fc6's,
    fc7's) in turn, as flax's Dropout does (kept units / (1 - rate)), and
    counts its calls."""

    def __init__(self, masks):
        self.masks, self.calls = masks, 0

    def __call__(self, x, rate, generator):
        assert isinstance(generator, torch.Generator) and rate == 0.5
        keep = self.masks[self.calls % 2]
        self.calls += 1
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def jax_grad_fn(jm):
    def loss(p, batch, prd, key):
        return jax_sgg.sgg_loss(p, jm, batch, prd, {"dropout": key})
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def check_vrd_grads(pm, jax_grads, frac=1e-4, cos_min=0.99999):
    ref = params_from_jax(np_tree(jax_grads))
    n = 0
    for name, p in pm.named_parameters():
        if not name.startswith("vrd."):
            assert p.grad is None and not p.requires_grad, name
            continue
        g, r = p.grad.double(), ref[name].double()
        norm = float(r.norm())
        assert float((g - r).abs().max()) <= frac * max(norm, 1e-12), name
        if norm > 0:
            cos = float((g * r).sum() / (g.norm() * r.norm()))
            assert cos >= cos_min, (name, cos)
        n += 1
    return n


# -- the loss and the pair batch -----------------------------------------

@pytest.mark.parametrize("valid", ["all", "half", "none"])
def test_bce_multilabel_loss_matches_jax(valid):
    rs = np.random.RandomState(2)
    scores = rs.uniform(-1, 1, (P, N_REL)).astype(np.float32)
    labels = (rs.rand(P, N_REL) < 0.3).astype(np.float32)
    pv = {"all": np.ones(P, bool), "half": np.arange(P) % 2 == 0,
          "none": np.zeros(P, bool)}[valid]
    got = float(sgg_mod.bce_multilabel_loss(
        torch.from_numpy(scores), torch.from_numpy(labels),
        torch.from_numpy(pv)))
    want = float(jax_bce(jnp.asarray(scores), jnp.asarray(labels),
                         jnp.asarray(pv)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if valid == "none":
        assert got == 0.0
    else:
        assert got > 0


@pytest.mark.parametrize("case", ["merge", "out_of_range", "overflow"])
def test_build_pair_batch_matches_jax(case):
    rels, n_boxes, max_pairs = {
        # (0, 1) twice with two predicates -> one multi-label row
        "merge": ([(0, 2, 1), (0, 4, 1), (1, 0, 2), (0, 2, 1)], 3, 4),
        # a box index past n_boxes or a predicate past n_rel is dropped
        "out_of_range": ([(9, 1, 0), (0, 1, 3), (0, N_REL, 1), (1, 3, 0)],
                         3, 4),
        # pairs past max_pairs are dropped; a label of a kept pair is not
        "overflow": ([(0, 1, 1), (1, 1, 0), (0, 2, 2), (2, 5, 0),
                      (1, 6, 0)], 3, 2),
    }[case]
    got = sgg.build_pair_batch(rels, n_boxes, max_pairs, N_REL)
    want = jax_sgg.build_pair_batch(rels, n_boxes, max_pairs, N_REL)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ix1, ix2, labels, valid = got
    if case == "merge":
        assert valid.sum() == 2 and labels[0, 2] == labels[0, 4] == 1.0
    elif case == "out_of_range":
        assert valid.sum() == 1 and (ix1[0], ix2[0]) == (1, 0)
    else:
        assert valid.sum() == 2 and labels[1, 6] == 1.0


# -- the optimizer's groups -------------------------------------------------

def jax_sgg_labels(params):
    """JAX's ``sgg_optimizer`` group of every leaf, read from one update of
    ones on ones: 'frozen' (zero), 'bias' (2 x lr, no decay) or 'weight'
    (lr x (1 + decay))."""
    tx = jax_sgg.sgg_optimizer(1.0, JaxConfig())
    ones = jax.tree_util.tree_map(np.ones_like, params)
    upd, _ = tx.update(ones, tx.init(ones), ones)
    kinds = {0.0: "frozen", -2.0: "bias", -1.0005: "weight"}
    flat = jax.tree_util.tree_flatten_with_path(np_tree(upd))[0]
    out = {}
    for path, v in flat:
        vals = set(np.round(v.ravel().astype(np.float64), 6).tolist())
        assert len(vals) == 1, path
        out["/".join(getattr(k, "key", str(k)) for k in path)] = \
            kinds[vals.pop()]
    return out


def test_param_labels_match_jax():
    """Every parameter's group under the port's ``sgg_optimizer`` equals
    JAX's on the same flax path: the trunk frozen (JAX's FrozenBN leaves
    are the port's buffers, out of the optimizer), the vrd weights and
    biases in theirs; ``param_label``'s bn rule catches no vrd name."""
    _, params, pm = init_pair("pool")
    want = jax_sgg_labels(params)
    opt = sgg.sgg_optimizer(pm, LR, Config())
    got = {jax_path(n): param_label(n, sgg.SGG_FROZEN_PREFIXES)
           for n, _ in pm.named_parameters()}
    buffers = {jax_path(n) for n, _ in pm.named_buffers()}
    assert set(want) == set(got) | buffers
    assert {k: want[k] for k in got} == got
    assert all(want[k] == "frozen" for k in buffers)
    assert {n for n, p in pm.named_parameters() if p.requires_grad} == {
        n for n, _ in pm.named_parameters() if n.startswith("vrd.")}
    assert {g: len(v) for g, v in opt.groups.items()} == {
        g: sum(1 for k, v in got.items() if v == g and k.startswith("vrd/"))
        for g in ("weight", "bias")}
    assert opt.clip_norm == 0.0


# -- the step against JAX ------------------------------------------------

@pytest.mark.parametrize("pooling", ["pool", "align"])
def test_train_step_matches_jax(pooling, monkeypatch):
    """One step with dropout on (JAX's masks) for two images, one without a
    valid pair: the loss, every vrd gradient and the parameters after the
    update; the trunk and its buffers bit-unchanged; the RoI op of the head
    runs once an image, forward only."""
    jm, p0, pm = init_pair(pooling)
    batch = make_batch()
    key = jax.random.PRNGKey(5)
    (_, jmet), g0 = jax_grad_fn(jm)(p0, J(batch), jnp.asarray(prd_vecs()),
                                    key)
    tx = jax_sgg.sgg_optimizer(LR, JaxConfig())
    upd, _ = jax.jit(tx.update)(g0, tx.init(p0), p0)
    p1 = np_tree(optax.apply_updates(p0, upd))

    fed = FedMasks(jax_masks(jm, p0, J(batch), key))
    monkeypatch.setattr(sgg_mod, "dropout", fed)
    op = "roi_align_avg" if pooling == "align" else "roi_pool"
    pooled = []
    real = getattr(sgg_mod, op)

    def spy(features, *a, **k):
        pooled.append(features.requires_grad)
        return real(features, *a, **k)
    monkeypatch.setattr(sgg_mod, op, spy)
    trunk0 = {k: v.clone() for k, v in pm.trunk.state_dict().items()}
    opt = sgg.sgg_optimizer(pm, LR, Config())
    opt.zero_grad()
    loss, m = sgg.sgg_loss(pm, T(batch), torch.from_numpy(prd_vecs()),
                           lambda: step_generator("cpu", 0, 0))
    loss.backward()
    assert fed.calls == 2 * B and pooled == [False] * B
    np.testing.assert_allclose(float(loss.detach()), float(jmet["loss"]),
                               rtol=1e-5)
    assert int(m["n_pairs"]) == int(jmet["n_pairs"]) == 5
    assert check_vrd_grads(pm, g0) > 20
    opt.step(0)
    check_params(pm, p1, p0)
    for k, v in pm.trunk.state_dict().items():
        assert torch.equal(v, trunk0[k]), k


def test_two_steps_with_decay_match_jax(monkeypatch):
    """Two steps with ``decay_spe`` 1 (lr x0.9 between them), each with its
    own JAX masks: the momentum is carried and the parameters after both
    equal JAX's ``make_sgg_train_step``'s."""
    jm, p0, pm = init_pair("pool")
    batch = make_batch(3)
    jcfg = JaxConfig()
    tx = jax_sgg.sgg_optimizer(lambda step: LR * (0.9 ** (step // 1)), jcfg)
    state = create_train_state(p0, tx)
    step_fn = jax_sgg.make_sgg_train_step(jm, tx)
    key = jax.random.PRNGKey(7)
    prd = jnp.asarray(prd_vecs())
    masks, jloss = [], []
    for i in range(2):
        k = jax.random.fold_in(key, i)
        # the masks where the step's own fc6/fc7 outputs are positive
        masks.append(jax_masks(jm, np_tree(state.params), J(batch), k))
        state, met = step_fn(state, J(batch), prd, k)
        jloss.append(float(met["loss"]))
    p2 = np_tree(state.params)

    opt = sgg.sgg_optimizer(pm, lambda step: LR * (0.9 ** (step // 1)),
                            Config())
    st = TrainState(pm, opt, seed=0)
    for i in range(2):
        monkeypatch.setattr(sgg_mod, "dropout", FedMasks(masks[i]))
        m = sgg.train_step(st, T(batch), torch.from_numpy(prd_vecs()))
        np.testing.assert_allclose(float(m["loss"]), jloss[i], rtol=1e-5)
    assert st.step == 2
    assert [g["lr"] for g in opt.opt.param_groups] == pytest.approx(
        [LR * 0.9, 2 * LR * 0.9])
    check_params(pm, p2, p0)
    # the momentum after two steps: JAX's traces
    want = params_from_jax(jax_traces(state.opt_state))
    for name, buf in opt.momentum().items():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * float(
                                       want[name].abs().max()), err_msg=name)


def test_int8_head_refuses_training():
    pm = SGGModel(VRDHead(emb_dim=EMB, fc_dim=FC, int8_fc=True),
                  trunk=ResNetTrunk(depth=10, dtype=torch.float32))
    batch = T(make_batch())
    with pytest.raises(ValueError, match="serving-only"):
        sgg.sgg_loss(pm, batch, torch.from_numpy(prd_vecs()),
                     lambda: step_generator("cpu", 0, 0))


# -- dropout, the head's init, the Stage B restore ----------------------------

def test_dropout_statistics():
    """On a generator: the kept share within 5 binomial standard deviations
    of 0.5, kept values x2 exactly, the same draw for the same (seed,
    step) and another for another step; in eval no dropout runs."""
    x = torch.rand(400, 640) + 0.5
    y = sgg_mod.dropout(x, 0.5, step_generator("cpu", 3, 7))
    kept = y != 0
    n = x.numel()
    assert abs(int(kept.sum()) - n / 2) <= 5 * math.sqrt(n * 0.25)
    assert torch.equal(y[kept], x[kept] * 2)
    assert torch.equal(y, sgg_mod.dropout(x, 0.5,
                                          step_generator("cpu", 3, 7)))
    assert not torch.equal(y, sgg_mod.dropout(x, 0.5,
                                              step_generator("cpu", 3, 8)))
    assert sgg_mod.dropout(x, 0.0, step_generator("cpu", 3, 7)) is x

    _, _, pm = init_pair("pool")
    b = T(make_batch())
    fmap = pm.frozen_map(b["image"][:1])
    args = (fmap, b["im_info"][0], b["obj_boxes"][0], b["ix1"][0],
            b["ix2"][0], b["pair_valid"][0], torch.from_numpy(prd_vecs()))
    with torch.no_grad():
        served = pm.head_on_features(*args)["scores"]
        pm.eval()
        assert torch.equal(pm.train_head(
            *args, step_generator("cpu", 0, 0))["scores"], served)
        pm.train()
        assert not torch.equal(pm.train_head(
            *args, step_generator("cpu", 0, 0))["scores"], served)


def test_head_init_is_torch_default_uniform():
    """``init_module`` draws every torch-default layer of the head (all of
    them, as JAX's ``torch_linear_kernel``/``torch_linear_bias``) uniform
    in +-1/sqrt(fan_in): inside the bound, with the variance of a uniform
    draw, bound^2 / 3 (a normal of that variance leaves the bound)."""
    head = init_module(VRDHead(emb_dim=300, fc_dim=256),
                       torch.Generator().manual_seed(0))
    layers = [(n, m) for n, m in head.named_modules()
              if isinstance(m, (Dense, Conv))]
    assert len(layers) == 13
    for name, m in layers:
        bound = 1.0 / math.sqrt(m.weight[0].numel())
        assert m.init_bound == m.bias_bound == pytest.approx(bound), name
        for t in (m.weight, m.bias):
            assert float(t.abs().max()) <= bound, name
            assert float(t.abs().max()) > 0.9 * bound or t.numel() < 64, name
        if m.weight.numel() >= 10_000:
            var = float(m.weight.double().var())
            assert abs(var / (bound ** 2 / 3) - 1) < 0.05, (name, var)


def test_restore_sgg_init_copies_the_trunk_only(tmp_path):
    """From a Stage A checkpoint (JAX's res10 detector init, saved by JAX
    and converted to the port's format): the port copies every ``trunk.*``
    tensor, FrozenBN buffers included, and nothing of ``vrd``; its stats
    equal JAX's ``_merge_filtered`` with ``keep_only_roots=("trunk",)`` on
    the same trees."""
    cfg = JaxConfig().replace(COMPUTE_DTYPE="float32")
    det = JaxFasterRCNN(num_classes=6, cfg=cfg, backbone="res10", ic=True,
                        gc=True)
    dp = np_tree(jax.jit(lambda k: det.init(
        {"params": k}, jnp.zeros((1, 64, 80, 3)),
        jnp.asarray([[64, 80, 1.0]]), mode="inference")["params"])(
        jax.random.PRNGKey(3)))
    rs = np.random.RandomState(4)

    def stats_of(node):
        # FrozenBN statistics other than the init's, so that copying them
        # shows
        for k, v in node.items():
            if isinstance(v, dict):
                stats_of(v)
            elif k in ("mean", "var"):
                node[k] = rs.uniform(0.5, 2.0, v.shape).astype(v.dtype)
    stats_of(dp["trunk"])
    jdir = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(jdir, JaxTrainState(dp, {}, jnp.zeros(
        (), jnp.int32)), 1, metadata={"pooling_mode": "align"})
    tdir = str(tmp_path / "port")
    jax_to_torch_checkpoint.main([f"{jdir}/1", tdir])

    pm = init_module(port_model("pool"), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    stats = checkpoint.restore_sgg_init(tdir, 1, pm)
    ckpt = checkpoint.load_state_dict(tdir, 1)
    for k, v in pm.state_dict().items():
        if k.startswith("trunk."):
            assert torch.equal(v, ckpt[k]), k
        else:
            assert torch.equal(v, before[k]), k
    assert not torch.equal(pm.trunk.bn1.var, before["trunk.bn1.var"])
    want = {}
    jax_ckpt._merge_filtered(jax_init("pool"), dp, skip=(),
                             keep_only_roots=("trunk",), stats=want)
    assert stats == want
    assert stats["copied"] == stats["named"] == sum(
        1 for k in pm.state_dict() if k.startswith("trunk."))
