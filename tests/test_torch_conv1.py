"""The port's conv1 (``i2vsgg_tpu_torch/ops/conv1.py``) against the JAX
package's Pallas conv1 kernels on the CPU (interpret mode): the host
contract (plane geometry, host and device packers) byte for byte, the plain
versions of the four B3 entries and the B5 (v2) mode, and the trunk's
dispatch on ``Conv1Planes`` and ``I2VSGG_PALLAS_CONV1``.

Tolerance of the conv1 outputs (bf16): at most one bf16 ulp apart
(``|d| <= 2**-7 * |ref|``) with at least 99.9 % of the elements bit-equal —
both sides sum the same exact bf16 products in f32, in different orders, so
a sum that lands next to a bf16 rounding boundary can round the other way.
Where the BN affine cancels the sum to near zero, the f32 rounding of the
sum (~1e-7 of its magnitude) is many bf16 ulps of the tiny result, so the
bound adds ``2**-16 * max|ref|`` (one element in 140,000 at (2, 50, 70)
needs it: 3.43e-5 against 3.34e-5, exact value 3.4331e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from i2vsgg_tpu.models import backbones as jax_bb
from i2vsgg_tpu.ops.pallas import conv1_kernel as jk
from i2vsgg_tpu.ops.pallas.conv1_v2_kernel import (_pack_weights,
                                                   conv1_bn_relu_pallas_v2)
from i2vsgg_tpu_torch.models.backbones import ResNetTrunk
from i2vsgg_tpu_torch.ops import conv1
from i2vsgg_tpu_torch.utils.weights import params_from_jax

SHAPES = [(1, 64, 96), (2, 50, 70)]


def bf16_bits(a) -> np.ndarray:
    """The bf16 bit patterns of a JAX array or a torch bf16 tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def assert_one_ulp(got: torch.Tensor, ref, min_equal: float = 0.999):
    g = got.float().numpy()
    r = np.asarray(ref, np.float32)
    assert g.shape == r.shape
    gap = np.abs(g - r)
    bound = 2.0 ** -7 * np.abs(r) + 2.0 ** -16 * float(np.abs(r).max())
    assert (gap <= bound).all(), float((gap - bound).max())
    assert (g == r).mean() >= min_equal, float((g == r).mean())


def make_case(shape, seed=0):
    """Images, HWIO weights and a FrozenBN affine as numpy; the images hold
    exact bf16 ties so that the packers' rounding is exercised."""
    b, h, w = shape
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, h, w, 3) * 20).astype(np.float32)
    x.reshape(-1)[:64] = (1.0 + (2 * np.arange(64) + 1) * 2.0 ** -8
                          ).astype(np.float32)          # halfway cases
    w_hwio = (rs.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    mul = (rs.rand(64) + 0.5).astype(np.float32)
    add = rs.randn(64).astype(np.float32)
    return x, w_hwio, mul, add


def port_params(w_hwio, mul, add):
    return (torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(mul), torch.from_numpy(add))


@pytest.mark.parametrize("hw", [(64, 80), (50, 70), (47, 131), (600, 960),
                                (608, 1056)])
def test_plane_geometry_matches_jax(hw):
    assert tuple(conv1.conv1_plane_geometry(*hw)) == tuple(
        jk.conv1_plane_geometry(*hw))


@pytest.mark.parametrize("shape", SHAPES)
def test_packers_byte_identical_to_jax(shape):
    x = make_case(shape)[0]
    host = conv1.pack_conv1_planes_np(x)
    ref = jk.pack_conv1_planes_np(x, native=False)
    assert host.dtype == torch.bfloat16 and tuple(host.shape) == ref.shape
    np.testing.assert_array_equal(bf16_bits(host), bf16_bits(ref))
    dev = conv1.pack_conv1_planes(torch.from_numpy(x))
    np.testing.assert_array_equal(bf16_bits(dev),
                                  bf16_bits(jk.pack_conv1_planes(
                                      jnp.asarray(x))))
    planes = conv1.Conv1Planes.pack(x)
    assert planes.shape == x.shape
    np.testing.assert_array_equal(bf16_bits(planes.planes), bf16_bits(ref))


ENTRIES = ["bn_relu", "bn_relu_planes", "stem", "stem_planes", "v2"]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_entries_match_jax_interpret(shape, entry):
    b, h, w = shape
    x, w_hwio, mul, add = make_case(shape, seed=1)
    wt, mul_t, add_t = port_params(w_hwio, mul, add)
    xt = torch.from_numpy(x)
    jx, jw, js, jb = (jnp.asarray(a) for a in (x, w_hwio, mul, add))
    planes_np = jk.pack_conv1_planes_np(x, native=False)
    planes_t = conv1.pack_conv1_planes_np(x)
    if entry == "bn_relu":
        ref = jk.conv1_bn_relu_pallas(jx, jw, js, jb, interpret=True)
        got = conv1.conv1_bn_relu(xt, wt, mul_t, add_t)
    elif entry == "bn_relu_planes":
        ref = jk.conv1_bn_relu_pallas_planes(jnp.asarray(planes_np), h, w,
                                             jw, js, jb, interpret=True)
        got = conv1.conv1_bn_relu_planes(planes_t, h, w, wt, mul_t, add_t)
    elif entry == "stem":
        ref = jk.conv1_stem_pallas(jx, jw, js, jb, interpret=True)
        got = conv1.conv1_stem(xt, wt, mul_t, add_t)
    elif entry == "stem_planes":
        ref = jk.conv1_stem_pallas_planes(jnp.asarray(planes_np), h, w, jw,
                                          js, jb, interpret=True)
        got = conv1.conv1_stem_planes(planes_t, h, w, wt, mul_t, add_t)
    else:
        ref = conv1_bn_relu_pallas_v2(jx, jw, js, jb, interpret=True)
        got = conv1.conv1_bn_relu_v2(xt, wt, mul_t, add_t)
    assert got.dtype == torch.bfloat16
    assert conv1.launches == 0                    # CPU: the plain versions
    assert_one_ulp(got, ref)


def test_v2_folded_weight_matches_jax_pack():
    """The v2 mode folds ``bf16(w * mul)`` in f32 before the cast, from the
    same conv1/bn1 parameters the bridge carries: the same bytes as the JAX
    kernel's ``_pack_weights``."""
    _, w_hwio, mul, add = make_case((1, 8, 8))
    wt, mul_t, _ = port_params(w_hwio, mul, add)
    folded = conv1.fold_v2_weight(wt, mul_t)                 # (64, 3, 7, 7)
    packed = np.asarray(_pack_weights(jnp.asarray(w_hwio), jnp.asarray(mul)))
    # _pack_weights' (64, 256) rows: K = s*16 + m, s = dr2*4 + dc2,
    # m = (py*2 + px)*3 + c with (dr, dc) = (2*dr2 + py, 2*dc2 + px)
    for dr in range(7):
        for dc in range(7):
            for c in range(3):
                k = ((dr // 2) * 4 + dc // 2) * 16 + ((dr % 2) * 2
                                                      + dc % 2) * 3 + c
                np.testing.assert_array_equal(
                    bf16_bits(folded[:, c, dr, dc].contiguous()),
                    packed[:, k].view(np.uint16))


@pytest.fixture(scope="module")
def trunks():
    """The res10 trunk of both packages with the same weights (f32 compute,
    random FrozenBN statistics so that the affine is not the identity)."""
    rs = np.random.RandomState(5)
    x = (rs.randn(1, 64, 80, 3) * 10).astype(np.float32)
    trunk = jax_bb.ResNetTrunk(depth=10, dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.array, trunk.init({"params": jax.random.PRNGKey(0)},
                             jnp.asarray(x))["params"])
    params["bn1"]["scale"] = (rs.rand(64) + 0.5).astype(np.float32)
    params["bn1"]["bias"] = rs.randn(64).astype(np.float32)
    params["bn1"]["mean"] = (rs.randn(64) * 0.1).astype(np.float32)
    params["bn1"]["var"] = (rs.rand(64) + 0.5).astype(np.float32)
    port = ResNetTrunk(depth=10, dtype=torch.float32)
    port.load_state_dict(params_from_jax(params))
    return trunk, params, port.eval(), x


def _close(got, ref):
    """trunk outputs to rtol 1e-4 with atol 1e-5 of the largest magnitude
    (f32 summation order, as in test_torch_models.py): at this size the
    conv1 outputs of the two packages agree bit for bit (measured: 8e-7 of
    the largest magnitude at most), so nothing of a bf16 ulp reaches them."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("fused_pool", ["1", "0"])
def test_trunk_on_conv1planes_matches_jax(trunks, monkeypatch, fused_pool):
    trunk, params, port, x = trunks
    monkeypatch.setenv("I2VSGG_CONV1_FUSED_POOL", fused_pool)
    ref, ref_tap = trunk.apply({"params": params},
                               jk.Conv1Planes.pack(x))
    got, got_tap = port(conv1.Conv1Planes.pack(x))
    _close(got, ref)
    _close(got_tap, ref_tap)


def test_trunk_env_switch_matches_jax_and_planes(trunks, monkeypatch):
    """``I2VSGG_PALLAS_CONV1=1`` sends images to the image-fed conv1: it
    matches the JAX trunk under the same switch, and the port's planes path
    bit for bit (same bytes in)."""
    trunk, params, port, x = trunks
    monkeypatch.setenv("I2VSGG_PALLAS_CONV1", "1")
    ref, _ = trunk.apply({"params": params}, jnp.asarray(x))
    got, got_tap = port(torch.from_numpy(x))
    _close(got, ref)
    monkeypatch.delenv("I2VSGG_PALLAS_CONV1")
    planes, planes_tap = port(conv1.Conv1Planes.pack(x))
    assert torch.equal(got, planes) and torch.equal(got_tap, planes_tap)
    # without the switch the trunk runs the plain f32 conv: a different
    # (unrounded) conv1, so the outputs differ
    plain, _ = port(torch.from_numpy(x))
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("v2", [False, True])
def test_kernel_weight_layout_computes_conv1(v2):
    """``prepare_conv1``'s K-major weight (K = tap * 4 + c) in the kernel's
    implicit GEMM, emulated here in f64 over the plane window, gives the
    plain version's conv1 (one bf16 ulp, >= 99.9 % bit-equal): the
    kernel's operand layout, checked on the CPU."""
    b, h, w = 1, 21, 27
    x, w_hwio, mul, add = make_case((b, h, w))
    wt, mul_t, add_t = port_params(w_hwio, mul, add)
    prep = conv1.prepare_conv1(wt, mul_t, add_t, v2=v2)
    assert tuple(prep.w_k.shape) == (64, 208)
    assert prep.w_k.dtype == torch.bfloat16 and (prep.mul is None) == v2
    g = conv1.conv1_plane_geometry(h, w)
    planes = conv1.pack_conv1_planes(torch.from_numpy(x))[0].double()
    cols = torch.zeros(g.ho, g.wo, 52, 4, dtype=torch.float64)
    for dr in range(7):
        for dc in range(7):
            cols[:, :, dr * 7 + dc, :3] = planes[
                dr % 2, dc % 2, :, dr // 2:dr // 2 + g.ho,
                dc // 2:dc // 2 + g.wo].permute(1, 2, 0)
    y = cols.reshape(-1, 208) @ prep.w_k.double().t()
    if prep.mul is not None:
        y = y * prep.mul.double()
    got = torch.relu(y + prep.add.double()).to(torch.bfloat16)
    plain = (conv1.conv1_bn_relu_v2_plain if v2
             else conv1.conv1_bn_relu_plain)
    ref = plain(torch.from_numpy(x), wt, mul_t, add_t)
    assert_one_ulp(got.reshape(1, g.ho, g.wo, 64), ref.float().numpy())


def test_trunk_conv1_weights_kept_and_bit_equal_to_per_call(trunks):
    """The trunk prepares conv1's operands once per set of weights: the
    second call returns the kept ones, bit-equal to ``prepare_conv1`` made
    afresh from the same parameters."""
    _, _, port, _ = trunks
    kept = port.conv1_weights()
    assert port.conv1_weights() is kept
    fresh = conv1.prepare_conv1(port.conv1.weight, *port.bn1.affine())
    for a, b in zip(kept, fresh):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("change", ["load_state_dict", "in_place",
                                    "bf16_storage_cast", "to"])
def test_trunk_conv1_after_a_weight_change_matches_jax(trunks, change):
    """After a weight change the trunk's next forward on planes prepares
    conv1 again: its stem matches the JAX stem kernel (interpret mode) on
    the new weights to the conv1 bound, and the whole trunk equals, bit for
    bit, a trunk built afresh with the new weights: nothing stale is
    served."""
    import copy

    from i2vsgg_tpu.utils.params import bf16_storage_cast as jax_cast
    from i2vsgg_tpu_torch.utils.params import bf16_storage_cast
    _, params, port, x = trunks
    port = copy.deepcopy(port)
    planes = conv1.Conv1Planes.pack(x)
    port(planes)
    stale = port.conv1_weights()
    new = jax.tree_util.tree_map(np.array, params)
    fresh = ResNetTrunk(depth=10, dtype=torch.float32)
    if change == "load_state_dict":
        new["conv1"]["kernel"] = new["conv1"]["kernel"][..., ::-1].copy()
        new["bn1"]["bias"] = new["bn1"]["bias"] + 1.0
        port.load_state_dict(params_from_jax(new))
    elif change == "in_place":
        with torch.no_grad():
            port.conv1.weight.mul_(-0.5)
            port.bn1.scale.mul_(2.0)
        new["conv1"]["kernel"] = new["conv1"]["kernel"] * -0.5
        new["bn1"]["scale"] = new["bn1"]["scale"] * 2.0
    else:
        bf16_storage_cast(port)
        bf16_storage_cast(fresh)
        if change == "to":
            port(planes)                     # kept for the bf16 storage
            port.float()
            fresh.float()
        new = jax.tree_util.tree_map(np.asarray, jax_cast(new))
    fresh.load_state_dict(params_from_jax(new))
    got, got_tap = port(planes)
    assert port.conv1_weights() is not stale
    want, want_tap = fresh(planes)
    assert torch.equal(got, want) and torch.equal(got_tap, want_tap)
    mul, add = fresh.bn1.affine()
    h, w = x.shape[1:3]
    ref = jk.conv1_stem_pallas_planes(
        jnp.asarray(jk.pack_conv1_planes_np(x, native=False)), h, w,
        jnp.asarray(np.asarray(new["conv1"]["kernel"], np.float32)),
        jnp.asarray(mul.numpy()), jnp.asarray(add.numpy()), interpret=True)
    stem = bb_nhwc(port._stem(planes))
    assert_one_ulp(stem.to(torch.bfloat16), ref)


def bb_nhwc(x):
    return x.permute(0, 2, 3, 1)
