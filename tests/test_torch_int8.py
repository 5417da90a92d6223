"""The port's int8 serving levers against the JAX package on the CPU.

The round-5 reference configuration (``BENCH_r05.json``: ``int8fc
int8trunk[1:layer2,layer3,layer4,@3x3] static-acts bf16w``), built as
``bench.py --int8-fc6 --int8-trunk-scope 1:layer2,layer3,layer4,@3x3
--int8-static-acts runs/calib/act_scales_res101.json`` builds it:
``bf16_storage_cast``, ``quantize_dense_params``, ``quantize_trunk_params``
with the calibration file's static scales, and ``I2VSGG_INT8_TRUNK`` set,
read at forward time. Checked here:

* ``params_from_jax`` carries JAX's int8 trees (trunk and dense towers)
  into the port's quantized modules;
* the port's ``quantize_trunk_params`` / ``quantize_dense_params`` give
  int8 taps, ``kernel_scale`` and ``act_scale`` bit-equal to JAX's, for
  several scopes, a scalar scale and the calibration file, and the same
  ``KeyError`` for a conv the calibration lacks;
* ``BNConv``'s int8 branches and ``DenseInt8``, fed the same input as JAX's:
  bit-equal (int32 products are exact on both sides: XLA's int8 ops, the
  port's float64 plain version);
* the env switch's scope (substring of the joined path, ``@3x3``) quantizes
  the convs ``quantize_trunk_params`` does: the two paths are bit-equal;
* the plain B6 (``ops/conv1_int8.py``) against
  ``conv1_bn_relu_int8_pallas(interpret=True)`` at the JAX test's shapes,
  and on non-integer inputs that take the clamp and the half-to-even tie;
* the whole int8 frame program at res10 64x80 bf16 (bounds below);
* ``ResNetStage`` refuses int8 weights under the chain switch, and the
  CPU quality-gate and calibration modes raise.

The whole program (2 frames of 64x80, res10 ic+gc, 4 classes, ``max_det``
4, SGG head under ``align`` with int8 fc6/fc7, detector weights scaled as in
tests/test_torch_bf16.py) is held to JAX's slot by slot: classes, validity
and pair validity equal; boxes within 0.05 px, scores within 5e-3 and
``rel_prob`` within 5e-3 (the res10 bounds of tests/test_torch_bf16.py).
bf16 convolutions round in another order in XLA and oneDNN, and a static
or dynamic int8 quantization of two inputs one bf16 ulp apart can land one
step apart; the largest differences measured (1 and 6 threads) were
7.6e-6 px (boxes), 1.8e-7 (scores) and 2.1e-4 (``rel_prob``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from i2vsgg_tpu import serve as jax_serve
from i2vsgg_tpu.config import Config as JaxConfig
from i2vsgg_tpu.models import backbones as jax_bb
from i2vsgg_tpu.models.faster_rcnn import FasterRCNN_DA as JaxFasterRCNN
from i2vsgg_tpu.models.sgg import DenseInt8 as JaxDenseInt8
from i2vsgg_tpu.models.sgg import SGGModel as JaxSGGModel
from i2vsgg_tpu.models.sgg import VRDHead as JaxVRDHead
from i2vsgg_tpu.ops.pallas.conv1_int8_kernel import (
    DEFAULT_PIXEL_MEANS, conv1_bn_relu_int8_pallas)
from i2vsgg_tpu.utils import params as jax_params
from i2vsgg_tpu_torch import config as port_config
from i2vsgg_tpu_torch import serve
from i2vsgg_tpu_torch.models import backbones as bb
from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
from i2vsgg_tpu_torch.models.layers import init_weights
from i2vsgg_tpu_torch.models.sgg import DenseInt8, SGGModel, VRDHead
from i2vsgg_tpu_torch.ops import conv1_int8 as c8
from i2vsgg_tpu_torch.ops import int8 as int8_ops
from i2vsgg_tpu_torch.utils.params import (bf16_storage_cast, load_act_scales,
                                           quantize_dense_params,
                                           quantize_trunk_params)
from i2vsgg_tpu_torch.utils.weights import params_from_jax
import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
CALIB = ROOT / "runs" / "calib" / "act_scales_res101.json"
SCOPE = "layer2,layer3,layer4,@3x3"
N_CLASSES, N_REL, MD = 4, 5, 4
B, H, W = 2, 64, 80
JAX_CFG = JaxConfig().replace(
    TEST=JaxConfig().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                    RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="bfloat16")
CFG = port_config.Config().replace(
    TEST=port_config.TestConfig(RPN_PRE_NMS_TOP_N=100, RPN_POST_NMS_TOP_N=16),
    COMPUTE_DTYPE="bfloat16")
BOX_TOL, SCORE_TOL, REL_PROB_TOL = 0.05, 5e-3, 5e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def T(a):
    """numpy (bf16 leaves as their bits) -> torch, dtype kept."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def calib() -> dict:
    with open(CALIB) as f:
        return json.load(f)["scales"]


@pytest.fixture(scope="module")
def trees():
    """JAX's res10 detector and int8-fc SGG trees (f32, as initialized),
    the images and predicate vectors."""
    rs = np.random.RandomState(0)
    images = (rs.randn(B, H, W, 3) * 10).astype(np.float32)
    im_info = np.tile([[H, W, 1.0]], (B, 1)).astype(np.float32)
    det = JaxFasterRCNN(num_classes=N_CLASSES, cfg=JAX_CFG, backbone="res10",
                        ic=True, gc=True)
    det_params = np_tree(det.init({"params": jax.random.PRNGKey(0)},
                                  jnp.asarray(images[:1]),
                                  jnp.asarray(im_info[:1]),
                                  mode="inference")["params"])
    # detections that are not degenerate (tests/test_torch_bf16.py)
    det_params["rpn"]["cls_score"]["kernel"] *= 40.0
    det_params["rpn"]["bbox_pred"]["kernel"] *= 0.1
    det_params["bbox_pred"]["kernel"] *= 0.1
    sgg = JaxSGGModel(
        trunk=jax_bb.ResNetTrunk(depth=10, dtype=jnp.bfloat16),
        vrd=JaxVRDHead(emb_dim=16, fc_dim=32, pooling="align",
                       dtype=jnp.bfloat16, int8_fc=True), n_rel=N_REL)
    prd = rs.randn(N_REL, 300).astype(np.float32)
    ix = jnp.zeros((MD * (MD - 1),), jnp.int32)
    sgg_params = np_tree(sgg.init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, H // 16, W // 16, 1024)), jnp.asarray([H, W, 1.0]),
        jnp.zeros((MD, 4)), ix, ix, jnp.zeros(ix.shape, bool),
        jnp.asarray(prd), method=JaxSGGModel.head_on_features)["params"])
    return dict(det=det, det_params=det_params, sgg=sgg,
                sgg_params=sgg_params, prd=prd, images=images,
                im_info=im_info)


def port_det(det_params):
    m = FasterRCNN_DA(N_CLASSES, CFG, "res10", ic=True, gc=True)
    m.load_state_dict(params_from_jax(det_params))
    return m.eval()


def assert_same_state(module, jax_tree):
    """The module's state dict equals ``params_from_jax(jax_tree)`` key for
    key, dtype for dtype, bit for bit."""
    got = module.state_dict()
    want = params_from_jax(np_tree(jax_tree))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("which", ["trunk", "dense"])
def test_params_from_jax_carries_int8_trees(trees, which):
    """JAX's quantized trees move into port modules quantized the same way
    (``load_state_dict`` strict): int8 kernels transposed and int8, the
    scales f32, ``act_scale`` 0-d."""
    if which == "trunk":
        tree = jax_params.quantize_trunk_params(
            jax_params.bf16_storage_cast(trees["det_params"]), SCOPE,
            calib())
        module = FasterRCNN_DA(N_CLASSES, CFG, "res10", ic=True, gc=True)
        conv = "trunk.layer3.block0.conv2"
        jax_k = tree["trunk"]["layer3"]["block0"]["conv2"]["kernel"]
        quantize = lambda m: quantize_trunk_params(m, SCOPE, calib())  # noqa
    else:
        tree = jax_params.quantize_dense_params(
            jax_params.bf16_storage_cast(trees["sgg_params"]))
        module = SGGModel(VRDHead(emb_dim=16, fc_dim=32, int8_fc=True))
        conv = "vrd.fc6"
        jax_k = tree["vrd"]["fc6"]["kernel"]
        quantize = quantize_dense_params
    sd = params_from_jax(np_tree(tree))
    w = sd[conv + ".weight"]
    assert w.dtype == torch.int8
    want = np.asarray(jax_k)
    want = (want.transpose(3, 2, 0, 1) if want.ndim == 4 else want.T)
    np.testing.assert_array_equal(w.numpy(), want)
    assert sd[conv + ".kernel_scale"].dtype == torch.float32
    if which == "trunk":
        assert sd[conv + ".act_scale"].shape == ()
    quantize(bf16_storage_cast(module)).load_state_dict(sd)
    assert_same_state(module, tree)


@pytest.mark.parametrize("scope,acts", [
    ("layer3", None),
    (SCOPE, "calib"),
    ("layer3,layer4", 0.05),
    ("", None),
], ids=["layer3", "l234_3x3_calibrated", "scalar", "every_block"])
def test_quantize_trunk_params_bit_equal_to_jax(trees, scope, acts):
    acts = calib() if acts == "calib" else acts
    tree = jax_params.quantize_trunk_params(
        jax_params.bf16_storage_cast(trees["det_params"]), scope, acts)
    module = bf16_storage_cast(FasterRCNN_DA(N_CLASSES, CFG, "res10",
                                             ic=True, gc=True))
    module.load_state_dict(params_from_jax(np_tree(
        jax_params.bf16_storage_cast(trees["det_params"]))))
    quantize_trunk_params(module, scope, acts)
    assert_same_state(module, tree)
    n_int8 = sum(p.dtype == torch.int8 for p in module.parameters())
    # res10: one block a stage; layer4's 1x1s stay float
    assert n_int8 == {"layer3": 4, SCOPE: 3, "layer3,layer4": 5,
                      "": 13}[scope]


def test_quantize_trunk_params_missing_calibration_raises(trees):
    acts = {k: v for k, v in calib().items()
            if k != "trunk/layer3/block0/conv2"}
    with pytest.raises(KeyError, match="trunk/layer3/block0/conv2"):
        jax_params.quantize_trunk_params(trees["det_params"], SCOPE, acts)
    module = FasterRCNN_DA(N_CLASSES, CFG, "res10", ic=True, gc=True)
    with pytest.raises(KeyError, match="trunk/layer3/block0/conv2"):
        quantize_trunk_params(module, SCOPE, acts)


def test_quantize_dense_params_bit_equal_to_jax(trees):
    cast = jax_params.bf16_storage_cast(trees["sgg_params"])
    tree = jax_params.quantize_dense_params(cast)
    module = bf16_storage_cast(SGGModel(VRDHead(emb_dim=16, fc_dim=32,
                                                int8_fc=True)))
    module.load_state_dict(params_from_jax(np_tree(cast)))
    quantize_dense_params(module)
    assert_same_state(module, tree)
    assert module.vrd.fc7.weight.dtype == torch.int8
    assert module.vrd.so_vis_embeddings.weight.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="DenseInt8"):
        quantize_dense_params(SGGModel(VRDHead(emb_dim=16, fc_dim=32)))


def _wrapped(conv):
    """A module path with a ``block*`` part, so that
    ``quantize_trunk_params`` selects the conv (``block0.conv``)."""
    return nn.ModuleDict({"block0": nn.ModuleDict({"conv": conv})})


# case -> (kernel, stride, input (R, H, W, C), how the weight is held)
BNCONV_CASES = {
    "env1_3x3": (3, 1, (2, 9, 11, 24), "env"),
    "env1_1x1_stride2": (1, 2, (2, 10, 13, 24), "env"),
    "hoisted_dynamic": (3, 1, (2, 9, 11, 24), "dynamic"),
    "hoisted_static_saturated": (3, 1, (2, 9, 11, 24), "static"),
    "small_grid_guard": (1, 1, (6, 4, 4, 24), "dynamic"),
}


@pytest.mark.parametrize("case", list(BNCONV_CASES))
def test_bnconv_int8_branches_bit_equal_to_jax(monkeypatch, case):
    k, stride, shape, held = BNCONV_CASES[case]
    rs = np.random.RandomState(3)
    x = jnp.asarray(rs.randn(*shape).astype(np.float32) * 3).astype(
        jnp.bfloat16)
    jm = jax_bb.BNConv(16, shape[-1], k, stride, dtype=jnp.bfloat16)
    params = np_tree(jm.init(jax.random.PRNGKey(0), x)["params"])
    conv = bb.BNConv(shape[-1], 16, k, stride, dtype=torch.bfloat16)
    conv.load_state_dict(params_from_jax(params))
    if held == "env":
        monkeypatch.setenv("I2VSGG_INT8_TRUNK", "1")
    else:
        a_s = None
        if held == "static":
            # a scale below max|x| / 127: the largest inputs saturate
            a_s = float(jnp.max(jnp.abs(x.astype(jnp.float32)))) / 200.0
        q = jax_params.quantize_trunk_params({"block0": {"conv": params}},
                                             "", a_s)["block0"]["conv"]
        params = np_tree(q)
        quantize_trunk_params(_wrapped(conv), "", a_s)
        assert conv.weight.dtype == torch.int8
        assert torch.equal(conv.weight,
                           params_from_jax({"c": params})["c.weight"])
        if held == "static":
            xq = torch.round(T(x).float() / conv.act_scale)
            assert bool((xq.abs() > 127).any())
    want = np.asarray(jm.apply({"params": params}, x), np.float32)
    with torch.no_grad():
        got = conv(bb.nhwc_to_nchw(T(x)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bb.nchw_to_nhwc(got).float().numpy(), want)


@pytest.mark.parametrize("hoisted", [True, False], ids=["hoisted",
                                                        "on_the_fly"])
def test_dense_int8_matches_jax(hoisted):
    """fed the same f32 input (12 rows: fewer than ``_int_mm``'s 17),
    f32 out, bias added in f32."""
    rs = np.random.RandomState(4)
    x = rs.randn(12, 40).astype(np.float32) * 2
    jm = JaxDenseInt8(24, 40)
    params = np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    dense = DenseInt8(40, 24)
    dense.load_state_dict(params_from_jax(params))
    if hoisted:
        params = np_tree(jax_params.quantize_dense_params({"fc6": params})
                         ["fc6"])
        quantize_dense_params(nn.ModuleDict({"fc6": dense}))
        assert dense.weight.dtype == torch.int8
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = dense(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scope", ["layer3", "layer2,layer3,@3x3"])
def test_env_scope_equals_hoisted_weights(monkeypatch, trees, scope):
    """``I2VSGG_INT8_TRUNK=1:<scope>`` on float weights quantizes exactly
    the convs ``quantize_trunk_params(<scope>)`` stores in int8 (dynamic
    scales both): the trunk's outputs are bit-equal. Input 144x192, so that
    layer3's map is above the small-grid size, as in JAX's own test."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(1, 144, 192, 3).astype(np.float32) * 20)
    det = port_det(trees["det_params"])
    with torch.no_grad():
        plain = det.trunk(x)
        monkeypatch.setenv("I2VSGG_INT8_TRUNK", "1:" + scope)
        env = det.trunk(x)
        monkeypatch.delenv("I2VSGG_INT8_TRUNK")
        quantize_trunk_params(det, scope)
        hoisted = det.trunk(x)
    for a, b_ in zip(env, hoisted):
        assert torch.equal(a, b_)
    assert not torch.equal(env[0], plain[0])
    assert torch.equal(env[1], plain[1]) == ("layer2" not in scope)


def _b6_vs_pallas(x, w, scale, bias):
    """The plain B6 against the interpret-mode Pallas kernel on (B, H, W, 3)
    mean-subtracted images ``x``, HWIO weights ``w`` and the BN affine: the
    int8 weights and activations equal JAX's, the outputs within one bf16 ulp
    plus 2**-16 max|ref| and at least 99.9 % bit-equal (``K_o`` is a 3-term
    f32 sum, then a 49-term one, whose order may differ)."""
    want = np.asarray(conv1_bn_relu_int8_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), interpret=True), np.float32)
    # the JAX wrapper's weight and activation quantization (:115-128)
    means = jnp.asarray(DEFAULT_PIXEL_MEANS, jnp.float32)
    wf = jnp.asarray(w).transpose(3, 0, 1, 2).reshape(64, 147)
    w_s = jnp.maximum(jnp.max(jnp.abs(wf), axis=1), 1e-8) / 127.0
    jax_wq = np.asarray(jnp.round(wf / w_s[:, None]), np.int8)
    jax_x8 = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) + (means - 128.0)),
                                 -128.0, 127.0), np.int8)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    w_q, s, b_, shift, pad = c8.conv1_int8_params(
        wt, torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_array_equal(w_q[:, :147].numpy(), jax_wq)
    assert not bool(w_q[:, 147:].any())
    np.testing.assert_array_equal(
        c8.quantize_images(torch.from_numpy(x), shift).numpy(), jax_x8)
    np.testing.assert_array_equal(pad.numpy(),
                                  np.round(DEFAULT_PIXEL_MEANS) - 128)
    before = c8.launches
    got = c8.conv1_bn_relu_int8(torch.from_numpy(x), wt,
                                torch.from_numpy(scale),
                                torch.from_numpy(bias))
    assert c8.launches == before                    # the CPU runs the plain
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    g = got.float().numpy()
    bound = 2.0 ** -7 * np.abs(want) + 2.0 ** -16 * np.abs(want).max()
    assert (np.abs(g - want) <= bound).all()
    assert np.mean(g == want) >= 0.999


@pytest.mark.parametrize("shape", [(1, 64, 96), (2, 50, 70)])
def test_conv1_int8_plain_matches_pallas_interpret(shape):
    """The plain B6 against the interpret-mode Pallas kernel, at the JAX
    test's shapes and inputs (integer pixels), as ``_b6_vs_pallas`` holds
    it."""
    b, h, w_ = shape
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (b, h, w_, 3)).astype(np.float32)
    x = raw - np.asarray(DEFAULT_PIXEL_MEANS, np.float32)
    w = rng.randn(7, 7, 3, 64).astype(np.float32) * 0.1
    scale = rng.rand(64).astype(np.float32) + 0.5
    bias = rng.randn(64).astype(np.float32)
    _b6_vs_pallas(x, w, scale, bias)


def test_conv1_int8_plain_matches_pallas_on_clamps_and_ties():
    """The same parity on inputs that are not integer pixels
    (``chip_smoke.int8_edge_images`` at (1, 33, 47)): the shifted sums
    reach past the int8 range, so the clamp is taken, and fall exactly on
    k + 0.5, so rounding half to even is taken, both checked here."""
    x = chip_smoke.int8_edge_images((1, 33, 47))
    shifted = x + (np.asarray(DEFAULT_PIXEL_MEANS, np.float32)
                   - np.float32(128.0))
    assert np.mean(shifted == np.floor(shifted) + 0.5) > 0.25   # ties
    assert (shifted > 127.5).any() and (shifted < -128.5).any()  # clamps
    rng = np.random.RandomState(1)
    w = rng.randn(7, 7, 3, 64).astype(np.float32) * 0.1
    scale = rng.rand(64).astype(np.float32) + 0.5
    bias = rng.randn(64).astype(np.float32)
    _b6_vs_pallas(x, w, scale, bias)


def test_int8_products_exact_on_the_cpu():
    """``int8_conv2d`` / ``int8_linear`` on CPU tensors: exact int32 sums at
    the magnitudes an f32 sum would round (127 * 127 * 4608 > 2**24)."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randint(-127, 128, (1, 512, 5, 6)).astype(
        np.int8))
    w = torch.from_numpy(rs.randint(-127, 128, (8, 512, 3, 3)).astype(
        np.int8))
    x[:] = 127
    w[0] = 127
    got = int8_ops.int8_conv2d(x, w, 1, 1)
    assert got.dtype == torch.int32
    assert int(got[0, 0, 2, 2]) == 127 * 127 * 512 * 9
    want = torch.nn.functional.conv2d(x.long().double(), w.double(),
                                      padding=1).long()
    assert torch.equal(got.long(), want)
    a = torch.from_numpy(rs.randint(-127, 128, (5, 4608)).astype(np.int8))
    assert torch.equal(int8_ops.int8_linear(a, w.reshape(8, -1)).long(),
                       a.long() @ w.reshape(8, -1).long().t())


@pytest.fixture(scope="module")
def int8_program(trees):
    """Both packages' int8 programs (bf16 storage, int8 fc towers, the
    scoped int8 trunk with the calibration file's static scales, the switch
    set) and JAX's outputs."""
    det_tree = jax_params.quantize_trunk_params(
        jax_params.bf16_storage_cast(trees["det_params"]), SCOPE, calib())
    sgg_tree = jax_params.quantize_dense_params(
        jax_params.bf16_storage_cast(trees["sgg_params"]))
    det_t = bf16_storage_cast(FasterRCNN_DA(N_CLASSES, CFG, "res10",
                                            ic=True, gc=True))
    quantize_trunk_params(det_t, SCOPE, load_act_scales(str(CALIB)))
    det_t.load_state_dict(params_from_jax(np_tree(det_tree)))
    sgg_t = quantize_dense_params(bf16_storage_cast(SGGModel(VRDHead(
        emb_dim=16, fc_dim=32, pooling="align", dtype=torch.bfloat16,
        int8_fc=True))))
    sgg_t.load_state_dict(params_from_jax(np_tree(sgg_tree)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("I2VSGG_INT8_TRUNK", "1:" + SCOPE)
        prog = jax_serve.make_frame_program(
            trees["det"], det_tree, trees["sgg"], sgg_tree, trees["prd"],
            JAX_CFG, max_det=MD, max_per_class=4)
        out = np_tree(prog(jnp.asarray(trees["images"]),
                           jnp.asarray(trees["im_info"])))
    return dict(det_t=det_t.eval(), sgg_t=sgg_t.eval(), jax_program=out)


def test_int8_frame_program_matches_jax(monkeypatch, trees, int8_program):
    monkeypatch.setenv("I2VSGG_INT8_TRUNK", "1:" + SCOPE)
    calls = []
    real = int8_ops.int8_conv2d

    def counting(*a):
        calls.append(tuple(a[0].shape))
        return real(*a)

    monkeypatch.setattr(bb, "int8_conv2d", counting)
    s = int8_program
    exp = {k: T(v) for k, v in s["jax_program"].items()}
    prog = serve.make_frame_program(s["det_t"], s["sgg_t"], trees["prd"], CFG,
                                    max_det=MD, max_per_class=4, device="cpu")
    got = prog(trees["images"], trees["im_info"])
    # layer2's and layer3's 3x3 on the batch, layer4's on its rois
    assert len(calls) == 3, calls
    perm = chip_smoke.matched_order(got, exp)
    assert torch.equal(perm, torch.arange(MD).expand(B, MD))
    for k in ("det_valid", "classes", "pair_valid"):
        np.testing.assert_array_equal(got[k].numpy(), exp[k].numpy())
    assert got["det_valid"].any() and got["pair_valid"].any()
    for k, tol in (("boxes", BOX_TOL), ("scores", SCORE_TOL),
                   ("rel_prob", REL_PROB_TOL)):
        np.testing.assert_allclose(got[k].float().numpy(),
                                   exp[k].float().numpy(), rtol=0, atol=tol)


def test_stage_refuses_int8_weights_under_the_chain(monkeypatch):
    """JAX folds int8 taps without their scales into the chain
    (``backbones.py:319-326``); the port's stage refuses, naming itself."""
    stage = bb.ResNetStage(512, 256, 2, 1, torch.float32)
    stage.path = "trunk/layer3"
    init_weights(stage, torch.Generator().manual_seed(0))
    quantize_trunk_params(stage, "", None)
    x = torch.randn(1, 512, 4, 5)
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", "1")
    with pytest.raises(ValueError, match="trunk/layer3"):
        stage(x)
    monkeypatch.delenv("I2VSGG_PALLAS_BOTTLENECK")
    assert stage(x).shape == (1, 1024, 4, 5)


@pytest.mark.parametrize("env", [("I2VSGG_INT8_TRUNK", "sim"),
                                 ("I2VSGG_INT8_TRUNK", "sim:layer3"),
                                 ("I2VSGG_INT8_PREQ_SIM", "1"),
                                 ("I2VSGG_INT8_CALIB", "1")],
                         ids=["sim", "sim_scoped", "preq_sim", "calib"])
def test_quality_gate_and_calibration_modes_raise(monkeypatch, env):
    conv = bb.BNConv(8, 8, 3, 1, torch.float32)
    conv.path = "trunk/layer3/block0/conv2"
    init_weights(conv, torch.Generator().manual_seed(0))
    if env[0] == "I2VSGG_INT8_PREQ_SIM":
        quantize_trunk_params(_wrapped(conv), "", None)
    monkeypatch.setenv(*env)
    with pytest.raises(NotImplementedError):
        conv(torch.randn(1, 8, 9, 9))
