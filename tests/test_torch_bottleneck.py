"""The port's identity-bottleneck chain (``ops/bottleneck.py``, B4) against
the JAX package on the CPU:

* ``chain_geometry`` / ``chain_vmem_bytes`` equal JAX's integer for integer,
  and the fit gate fuses the same stages as JAX's (``_use_fused_chain``) at
  600x960 and at the tests' 64x80;
* ``fold_block_params`` is bit-equal to JAX's, on f32 and on bf16-stored
  kernels (JAX's promotion: f32(w) * mul in f32);
* ``bottleneck_chain_plain`` against ``bottleneck_chain_pallas(...,
  interpret=True)`` at the JAX test's two shapes;
* ``ResNetStage`` with the switch on, and the res50 trunk at 64x80 with the
  switch on (``c4`` and the layer2 tap), against JAX's with the switch on.

Tolerances are the JAX chain test's own (tests/test_bottleneck_chain.py):
allclose at rtol = atol = 0.05, and at least 99.9 % of the elements within
rtol = atol = 0.02 — both sides compute in bf16 with f32 sums, taken in
another order, so a bf16 rounding flips now and then and its ulp carries
through the later blocks. Both absolute allowances are at least one bf16
ulp of the reference's largest magnitude (2**-8 max|ref|; on the JAX test's
own O(1) data that is below its atol, so its bounds are unchanged there):
the stage and trunk tests run block0 in bf16 on both sides (XLA's and
oneDNN's sums), their maps reach ~100 (ulp 0.5), and where the chain's
residual add cancels to a small value the difference stays the size of its
terms' ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from i2vsgg_tpu.models import backbones as jax_bb
from i2vsgg_tpu.ops.pallas import bottleneck_kernel as jax_chain
from i2vsgg_tpu_torch.models import backbones as bb
from i2vsgg_tpu_torch.ops import bottleneck as chain
from i2vsgg_tpu_torch.utils.params import bf16_storage_cast
from i2vsgg_tpu_torch.utils.weights import params_from_jax


def chain_close(got, want):
    """The JAX chain test's bounds; returns the share within 0.02."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    ulp = 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0.05, atol=max(0.05, ulp))
    share = np.mean(np.isclose(got, want, rtol=0.02, atol=max(0.02, ulp)))
    assert share > 0.999, share
    return share


def nchw(a):
    return bb.nhwc_to_nchw(torch.as_tensor(np.asarray(a)))


# (h, w, c, m): the gate's table (layer3/layer2/layer4 at 600x960, layer2
# and layer3 at 64x80) and odd widths around the 16-column rounding
@pytest.mark.parametrize("h,w,c,m", [
    (38, 60, 1024, 256), (75, 120, 512, 128), (4, 4, 2048, 512),
    (8, 10, 512, 128), (4, 5, 1024, 256), (15, 20, 256, 128),
    (9, 13, 128, 128), (38, 61, 1024, 256)])
def test_geometry_and_footprint_equal_jax(h, w, c, m):
    assert chain.chain_geometry(h, w) == jax_chain.chain_geometry(h, w)
    assert (chain.chain_vmem_bytes(h, w, c, m)
            == jax_chain.chain_vmem_bytes(h, w, c, m))


def _stage_shapes(height, width):
    """(name, planes, (h, w, c)) of the block0 outputs the gate sees."""
    h = (height + 1) // 2                    # conv1 7x7/2 pad 3
    w = (width + 1) // 2
    h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1    # caffe ceil-mode pool
    out = [("layer1", 64, (h, w, 256))]
    h, w = (h + 1) // 2, (w + 1) // 2
    out.append(("layer2", 128, (h, w, 512)))
    h, w = (h + 1) // 2, (w + 1) // 2
    out.append(("layer3", 256, (h, w, 1024)))
    out.append(("layer4", 512, (4, 4, 2048)))   # the 4x4 roi subgrid
    return out


@pytest.mark.parametrize("size,fused", [
    ((600, 960), {"layer3"}), ((64, 80), {"layer2", "layer3"})])
def test_gate_fuses_where_jax_does(monkeypatch, size, fused):
    shapes = _stage_shapes(*size)
    for switch in (None, "1"):
        if switch is None:
            monkeypatch.delenv("I2VSGG_PALLAS_BOTTLENECK", raising=False)
        else:
            monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", switch)
        got = set()
        for name, planes, (h, w, c) in shapes:
            want = jax_bb._use_fused_chain(
                jax.ShapeDtypeStruct((4, h, w, c), jnp.bfloat16), planes)
            mine = bb.use_fused_chain(
                torch.empty((4, c, h, w), device="meta"), planes)
            assert mine == want, (name, size)
            if mine:
                got.add(name)
        assert got == (fused if switch else set()), got


@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
def test_fold_block_params_bit_equal(stored):
    rs = np.random.RandomState(0)
    c, m = 256, 128
    dt = jnp.dtype(stored)
    w1 = jnp.asarray(rs.randn(1, 1, c, m).astype(np.float32)).astype(dt)
    w3 = jnp.asarray(rs.randn(3, 3, m, m).astype(np.float32)).astype(dt)
    w2 = jnp.asarray(rs.randn(1, 1, m, c).astype(np.float32)).astype(dt)
    bns = [(jnp.asarray(rs.rand(k).astype(np.float32) + 0.5),
            jnp.asarray(rs.randn(k).astype(np.float32))) for k in (m, m, c)]
    want = jax_chain.fold_block_params(w1, bns[0], w3, bns[1], w2, bns[2])
    sd = params_from_jax({"a": {"kernel": np.asarray(w1)},
                          "b": {"kernel": np.asarray(w3)},
                          "c": {"kernel": np.asarray(w2)}})
    assert sd["a.weight"].dtype == (torch.bfloat16 if stored == "bfloat16"
                                    else torch.float32)
    tb = [(torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b)))
          for a, b in bns]
    got = chain.fold_block_params(sd["a.weight"], tb[0], sd["b.weight"],
                                  tb[1], sd["c.weight"], tb[2])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _random_chain(rs, n, c, m):
    def r(*s):
        return rs.randn(*s).astype(np.float32) * 0.05
    return (np.stack([r(c, m) for _ in range(n)]),
            np.stack([r(m) for _ in range(n)]),
            np.stack([r(9, m, m) for _ in range(n)]),
            np.stack([r(m) for _ in range(n)]),
            np.stack([r(m, c) for _ in range(n)]),
            np.stack([r(c) for _ in range(n)]))


@pytest.mark.parametrize("b,h,w,c,m,n", [
    (1, 15, 20, 256, 128, 2), (2, 9, 13, 128, 128, 3)])
def test_plain_chain_matches_pallas_interpret(b, h, w, c, m, n):
    rs = np.random.RandomState(0)
    params = _random_chain(rs, n, c, m)
    x = rs.randn(b, h, w, c).astype(np.float32)
    want = jax_chain.bottleneck_chain_pallas(
        jnp.asarray(x), *(jnp.asarray(p) for p in params), interpret=True)
    got = chain.bottleneck_chain_plain(torch.from_numpy(x),
                                       *(torch.from_numpy(p) for p in params))
    assert got.dtype == torch.bfloat16
    chain_close(got.float().numpy(), want)
    # the wrapper on CPU tensors: the plain version, no launch counted
    bf, f32 = torch.bfloat16, torch.float32
    args = [torch.from_numpy(p).to(bf if p.ndim > 2 else f32) for p in params]
    before = chain.bottleneck_chain.launches
    wrapped = chain.bottleneck_chain(torch.from_numpy(x).to(bf), *args)
    assert chain.bottleneck_chain.launches == before
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("b,h,w,c,m,n", [
    (1, 15, 20, 256, 128, 2), (2, 9, 13, 128, 128, 3)])
def test_chain_check_takes_the_plain_chain_and_refuses_wrong_ones(
        b, h, w, c, m, n):
    """``chip_smoke.held_chain``, the card's check of the kernel, on CPU
    tensors (the wrapper runs the plain version): it holds the right chain
    and refuses the two wrong chains of ``chip_smoke.chain_controls``."""
    import chip_smoke
    rs = np.random.RandomState(0)
    bf, f32 = torch.bfloat16, torch.float32
    wts = tuple(torch.from_numpy(p).to(bf if p.ndim > 2 else f32)
                for p in _random_chain(rs, n, c, m))
    x = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32)).to(bf)
    got = chip_smoke.held_chain(chain.bottleneck_chain, x, wts, "plain",
                                quiet=True)
    assert got["least_block_bit_equal"] == 1.0
    assert got["max_abs_err"] == 0.0
    refused = chip_smoke.chain_controls(chain.bottleneck_chain, x, wts)
    assert [why.split(":")[0] for _, why in refused] == [
        name for name, _ in refused]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rs = np.random.RandomState(1)
    params = [torch.from_numpy(p) for p in _random_chain(rs, 1, 128, 128)]
    bf = torch.bfloat16
    w1, b1, w3, b3, w2, b2 = params
    x = torch.zeros(1, 4, 5, 128, dtype=bf)
    ok = (w1.to(bf), b1, w3.to(bf), b3, w2.to(bf), b2)
    with pytest.raises(TypeError):
        chain.bottleneck_chain(x.float(), *ok)
    with pytest.raises(TypeError):
        chain.bottleneck_chain(x, w1, *ok[1:])
    with pytest.raises(ValueError):
        chain.bottleneck_chain(x[..., :64], *ok)
    with pytest.raises(ValueError):
        chain.bottleneck_chain(x.transpose(1, 2), *ok)


def _jax_stage_params(rs, stage, x):
    params = stage.init(jax.random.PRNGKey(0), x)["params"]
    # non-trivial FrozenBN affines, as the JAX stage test makes them
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p + 0.01 * np.float32(rs.randn())), params)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stage_fused_matches_jax(monkeypatch, dtype):
    """ResNetStage with the switch on (the JAX stage test's configuration)
    against JAX's; the port's fused path is the chain, and it agrees with
    its own unfused path to the JAX test's bounds."""
    rs = np.random.RandomState(1)
    x = rs.randn(1, 10, 12, 256).astype(np.float32)
    jdt = jnp.dtype(dtype)
    stage = jax_bb.ResNetStage(planes=128, blocks=3, stride=1, dtype=jdt)
    params = _jax_stage_params(rs, stage, jnp.asarray(x))
    port = bb.ResNetStage(256, 128, 3, 1, getattr(torch, dtype))
    port.load_state_dict(params_from_jax(params))
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", "1")
    want = np.asarray(stage.apply({"params": params}, jnp.asarray(x)),
                      np.float32)
    calls = []
    real = chain.bottleneck_chain

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(bb, "bottleneck_chain", counting)
    with torch.no_grad():
        got = bb.nchw_to_nhwc(port(nchw(x)))
        assert got.dtype == getattr(torch, dtype)
        assert calls == [(1, 10, 12, 512)]
        chain_close(got.float().numpy(), want)
        monkeypatch.delenv("I2VSGG_PALLAS_BOTTLENECK")
        unfused = bb.nchw_to_nhwc(port(nchw(x))).float().numpy()
    assert len(calls) == 1
    truth = np.asarray(jax_bb.ResNetStage(
        planes=128, blocks=3, stride=1, dtype=jnp.float32).apply(
            {"params": params}, jnp.asarray(x)), np.float32)
    rel = np.abs(got.float().numpy() - unfused) / np.maximum(np.abs(truth),
                                                             1.0)
    assert np.percentile(rel, 99) < 0.1, np.percentile(rel, 99)


def _frozen_bn_stats(rs, tree, path=()):
    """The tree with every FrozenBN's statistics drawn per channel (scale
    and var in [0.5, 1.5), mean and bias ~ 0.1 N(0, 1)), as a trained
    checkpoint has them: the folded affines are far from the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _frozen_bn_stats(rs, v, path + (k,))
        elif any(p.startswith("bn") or p.endswith("_bn") for p in path):
            n = v.shape[0]
            out[k] = ((rs.rand(n) + 0.5) if k in ("scale", "var")
                      else rs.randn(n) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def res50_trunk():
    rs = np.random.RandomState(2)
    images = (rs.randn(2, 64, 80, 3) * 10).astype(np.float32)
    trunk = jax_bb.ResNetTrunk(depth=50, dtype=jnp.bfloat16)
    params = trunk.init(jax.random.PRNGKey(3), jnp.asarray(images[:1]))
    return trunk, _frozen_bn_stats(rs, params["params"]), images


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_res50_trunk_with_the_switch_matches_jax(monkeypatch, res50_trunk,
                                                 storage):
    """The res50 trunk at 64x80, bf16 compute, the switch on (layer2 and
    layer3 fused on both sides), f32- and bf16-stored weights. Each stage is
    fed the JAX stage's input, as tests/test_torch_models.py does: bf16
    roundings taken in another order compound over 13 bottlenecks (with the
    switch off as much as on), so whole-trunk outputs are no test of the
    chain."""
    from i2vsgg_tpu.utils.params import bf16_storage_cast as jax_cast
    trunk, params, images = res50_trunk
    if storage == "bfloat16":
        params = jax.tree_util.tree_map(np.asarray, jax_cast(params))
    port = bb.ResNetTrunk(depth=50, dtype=torch.bfloat16)
    if storage == "bfloat16":
        bf16_storage_cast(port)
    port.load_state_dict(params_from_jax(params))
    assert port.layer3.block1.conv2.weight.dtype == getattr(torch, storage)
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", "1")
    calls = []
    real = chain.bottleneck_chain

    def counting(*a):
        calls.append(tuple(a[0].shape))
        return real(*a)

    monkeypatch.setattr(bb, "bottleneck_chain", counting)
    (c4, tap), state = trunk.apply({"params": params}, jnp.asarray(images),
                                   capture_intermediates=True)
    mid = state["intermediates"]
    x1 = np.asarray(mid["layer1"]["__call__"][0], np.float32)
    with torch.no_grad():
        tap_t = port.layer2(nchw(x1).to(torch.bfloat16))
        c4_t = port.layer3(nchw(np.asarray(tap, np.float32)).to(
            torch.bfloat16))
        whole = port(torch.from_numpy(images))
    assert calls == [(2, 8, 10, 512), (2, 4, 5, 1024)] * 2
    chain_close(bb.nchw_to_nhwc(tap_t).float().numpy(), tap)
    chain_close(bb.nchw_to_nhwc(c4_t).float().numpy(), c4)
    assert tuple(whole[0].shape) == c4.shape
    assert tuple(whole[1].shape) == tap.shape


def _stage_case(seed=1):
    """The stage test's JAX stage (res50 layer3 widths halved: C 512, M
    128, 3 blocks) with its parameters and input."""
    rs = np.random.RandomState(seed)
    x = rs.randn(1, 10, 12, 256).astype(np.float32)
    stage = jax_bb.ResNetStage(planes=128, blocks=3, stride=1,
                               dtype=jnp.bfloat16)
    return stage, _jax_stage_params(rs, stage, jnp.asarray(x)), x


@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
def test_folded_tail_kept_and_bit_equal_to_a_fold_per_call(stored):
    """The stage folds its tail once per set of weights: the second call
    returns the kept fold, bit-equal to a fold made afresh."""
    _, params, _ = _stage_case()
    port = bb.ResNetStage(256, 128, 3, 1, torch.bfloat16)
    if stored == "bfloat16":
        bf16_storage_cast(port)
    port.load_state_dict(params_from_jax(params))
    kept = port.folded_tail()
    assert port.folded_tail() is kept
    fresh = port._fold_tail()
    for a, b in zip(kept, fresh):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert not a.requires_grad


def _changed(port, params, change):
    """Apply ``change`` to the port stage; return the JAX parameters that
    now describe it."""
    from i2vsgg_tpu.utils.params import bf16_storage_cast as jax_cast
    new = jax.tree_util.tree_map(np.array, params)
    if change == "load_state_dict":
        new["block1"]["conv2"]["kernel"] = -new["block1"]["conv2"]["kernel"]
        new["block2"]["bn3"]["mean"] = new["block2"]["bn3"]["mean"] + 0.5
        port.load_state_dict(params_from_jax(new))
    elif change == "in_place":
        with torch.no_grad():
            port.block2.conv1.weight.mul_(0.5)
            port.block1.bn2.var.add_(1.0)
        new["block2"]["conv1"]["kernel"] = new["block2"]["conv1"]["kernel"] * 0.5
        new["block1"]["bn2"]["var"] = new["block1"]["bn2"]["var"] + 1.0
    elif change == "bf16_storage_cast":
        bf16_storage_cast(port)
        new = jax.tree_util.tree_map(np.asarray, jax_cast(new))
    elif change == "to":
        bf16_storage_cast(port)
        port.load_state_dict(params_from_jax(new))
        port.folded_tail()                   # kept for the bf16 storages
        port.float()                         # new storages, the same values
        new = jax.tree_util.tree_map(np.asarray, jax_cast(new))
    return new


@pytest.mark.parametrize("change", ["load_state_dict", "in_place",
                                    "bf16_storage_cast", "to"])
def test_folded_tail_refolds_after_a_weight_change(monkeypatch, change):
    """After a weight change the next forward folds again and matches the
    JAX stage on the new weights: nothing stale is served."""
    stage, params, x = _stage_case()
    port = bb.ResNetStage(256, 128, 3, 1, torch.bfloat16)
    port.load_state_dict(params_from_jax(params))
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", "1")
    with torch.no_grad():
        port(nchw(x))
    stale = port.folded_tail()
    new = _changed(port, params, change)
    with torch.no_grad():
        got = bb.nchw_to_nhwc(port(nchw(x))).float().numpy()
    assert port.folded_tail() is not stale
    for a, b in zip(port.folded_tail(), port._fold_tail()):
        assert torch.equal(a, b)
    want = stage.apply({"params": new}, jnp.asarray(x))
    chain_close(got, want)


def test_folded_tail_refuses_int8_after_a_kept_fold(monkeypatch):
    """``quantize_trunk_params`` after a kept fold: the int8 refusal still
    raises, the kept fold is not served."""
    from i2vsgg_tpu_torch.utils.params import quantize_trunk_params
    _, params, x = _stage_case()
    port = bb.ResNetStage(256, 128, 3, 1, torch.bfloat16)
    port.load_state_dict(params_from_jax(params))
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", "1")
    with torch.no_grad():
        port(nchw(x))
        quantize_trunk_params(port, "")
        with pytest.raises(ValueError, match="int8"):
            port(nchw(x))
