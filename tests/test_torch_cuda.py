"""Card-only checks of the port's CUDA kernels (marked ``cuda``; they skip on
a machine without a card). On the machine with the card, where JAX is not
installed, run them without the JAX conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import copy

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_roi_pool_kernel_bit_exact(cuda, dtype):
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_pool import roi_pool, roi_pool_plain
    g = torch.Generator(device=cuda).manual_seed(0)
    fmap = torch.randn(1, 38, 60, 1024, generator=g, device=cuda).to(dtype)
    rois = chip_smoke.edge_rois(cuda)
    before = roi_pool.launches
    got = roi_pool(fmap, rois)
    assert roi_pool.launches == before + 1
    assert torch.equal(got, roi_pool_plain(fmap, rois))
    # scalar path (C not a multiple of the 16-byte vector), two images
    fmap2 = torch.randn(2, 20, 30, 36, generator=g, device=cuda).to(dtype)
    rois2 = torch.cat([rois, rois], 0).clone()
    rois2[36:, 0] = 1.0
    assert torch.equal(roi_pool(fmap2, rois2), roi_pool_plain(fmap2, rois2))


def test_roi_pool_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from i2vsgg_tpu_torch.ops.roi_pool import roi_pool
    fmap = torch.randn(1, 8, 8, 32, device=cuda)
    rois = torch.tensor([[0, 0.0, 0.0, 64.0, 64.0]], device=cuda)
    with pytest.raises(ValueError):
        roi_pool(fmap, rois.cpu())
    with pytest.raises(TypeError):
        roi_pool(fmap.double(), rois)
    with pytest.raises(ValueError):
        roi_pool(fmap[..., ::2], rois)


def test_small_program_card_matches_cpu(cuda):
    import chip_smoke
    from i2vsgg_tpu_torch import serve
    from i2vsgg_tpu_torch.config import Config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config().replace(
        TEST=Config().TEST.__class__(RPN_PRE_NMS_TOP_N=100,
                                     RPN_POST_NMS_TOP_N=16),
        COMPUTE_DTYPE="float32")
    spec = chip_smoke.SMALL
    det, sgg, prd = chip_smoke.build_models(spec, cfg,
                                            torch.Generator().manual_seed(1))
    det_g, sgg_g = copy.deepcopy(det), copy.deepcopy(sgg)
    images, im_info = chip_smoke.make_inputs(spec, 2)
    kw = dict(max_det=spec["max_det"], max_per_class=spec["max_per_class"])
    ref = serve.make_frame_program(det, sgg, prd, cfg, device="cpu",
                                   **kw)(images, im_info)
    got = serve.make_frame_program(det_g, sgg_g, prd, cfg, device=cuda,
                                   **kw)(images, im_info)
    for k in ("det_valid", "classes", "pair_valid"):
        assert torch.equal(got[k].cpu(), ref[k]), k
    for k in ("boxes", "scores", "rel_prob"):
        r = ref[k].numpy()
        np.testing.assert_allclose(got[k].cpu().numpy(), r, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(r).max()))


def _conv1_case(cuda, shape, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, h, w = shape
    x = torch.randn(b, h, w, 3, generator=g, device=cuda) * 20
    weight = torch.randn(64, 3, 7, 7, generator=g, device=cuda) * 0.1
    mul = torch.rand(64, generator=g, device=cuda) + 0.5
    add = torch.randn(64, generator=g, device=cuda)
    return x, weight, mul, add


@pytest.mark.parametrize("entry", ["bn_relu", "bn_relu_planes", "stem",
                                   "stem_planes", "v2"])
# odd sizes: Ho, Wo, Hp and Wp not multiples of the kernel's tiles (8 x 16
# pooled, 16 x 32 conv outputs), a clipped last pooled row and column
@pytest.mark.parametrize("shape", [(1, 64, 96), (2, 50, 70), (1, 600, 960),
                                   (1, 37, 61), (3, 67, 131), (1, 5, 7)])
def test_conv1_kernel_vs_plain(cuda, shape, entry):
    import chip_smoke
    from i2vsgg_tpu_torch.ops import conv1
    x, weight, mul, add = _conv1_case(cuda, shape)
    _, h, w = shape
    planes = conv1.pack_conv1_planes(x)
    calls = {
        "bn_relu": (conv1.conv1_bn_relu, conv1.conv1_bn_relu_plain,
                    (x, weight, mul, add), 1),
        "bn_relu_planes": (conv1.conv1_bn_relu_planes,
                           conv1.conv1_bn_relu_planes_plain,
                           (planes, h, w, weight, mul, add), 1),
        "stem": (conv1.conv1_stem, conv1.conv1_stem_plain,
                 (x, weight, mul, add), 1),
        "stem_planes": (conv1.conv1_stem_planes,
                        conv1.conv1_stem_planes_plain,
                        (planes, h, w, weight, mul, add), 1),
        "v2": (conv1.conv1_bn_relu_v2, conv1.conv1_bn_relu_v2_plain,
               (x, weight, mul, add), 1),
    }
    kernel, plain, args, n_launch = calls[entry]
    before = conv1.launches
    got = kernel(*args)
    assert conv1.launches == before + n_launch
    chip_smoke.held_one_ulp(got, plain(*args), entry)


@pytest.mark.parametrize("shape", [(2, 50, 70), (1, 37, 61), (3, 67, 131)])
def test_conv1_planes_and_images_bit_identical(cuda, shape):
    """Both source forms give the same bits, in both epilogue modes (the
    v2 mode through ``conv1_apply`` on planes), pooled and unpooled."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops import conv1
    _, h, w = shape
    x, weight, mul, add = _conv1_case(cuda, shape, seed=1)
    host = conv1.Conv1Planes.pack(x.cpu().numpy()).to(cuda)
    assert torch.equal(host.planes, conv1.pack_conv1_planes(x))
    assert torch.equal(conv1.conv1_stem(x, weight, mul, add),
                       conv1.conv1_stem_planes(host.planes, h, w, weight,
                                               mul, add))
    assert torch.equal(conv1.conv1_bn_relu(x, weight, mul, add),
                       conv1.conv1_bn_relu_planes(host.planes, h, w,
                                                  weight, mul, add))
    v2 = conv1.prepare_conv1(weight, mul, add, v2=True)
    for stem in (False, True):
        images = conv1.conv1_apply(x, v2, None, stem)
        assert torch.equal(images, conv1.conv1_apply(host.planes, v2, (h, w),
                                                     stem))
        plain = conv1.conv1_apply(x.cpu(), conv1.Conv1Weights(
            *(t if t is None else t.cpu() for t in v2)), None, stem)
        chip_smoke.held_one_ulp(images, plain.to(cuda), f"v2 stem={stem}")


def test_conv1_wrappers_refuse(cuda):
    from i2vsgg_tpu_torch.ops import conv1
    x, weight, mul, add = _conv1_case(cuda, (1, 32, 40))
    planes = conv1.pack_conv1_planes(x)
    with pytest.raises(TypeError):
        conv1.conv1_stem(x.half(), weight, mul, add)
    with pytest.raises(ValueError):
        conv1.conv1_stem(x[:, :, ::2], weight, mul, add)
    with pytest.raises(ValueError):
        conv1.conv1_stem_planes(planes, 40, 40, weight, mul, add)
    with pytest.raises(TypeError):
        conv1.conv1_stem_planes(planes.float(), 32, 40, weight, mul, add)
    with pytest.raises(ValueError):
        conv1.conv1_stem(x, weight[:32], mul, add)
    with pytest.raises(ValueError):
        conv1.conv1_stem(x, weight.cpu(), mul, add)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("grid", [None, (0, 2, 4, 6)])
def test_roi_align_kernel_vs_plain(cuda, dtype, grid):
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_align import (roi_align_avg,
                                                roi_align_avg_plain)
    g = torch.Generator(device=cuda).manual_seed(0)
    fmap = (torch.randn(2, 38, 60, 512, generator=g, device=cuda) * 4
            ).to(dtype)
    rois = chip_smoke.align_edge_rois(cuda, 2)
    before = roi_align_avg.launches
    got = roi_align_avg(fmap, rois, grid=grid)
    assert roi_align_avg.launches == before + 1
    ref = roi_align_avg_plain(fmap, rois, grid=grid)
    if dtype == torch.float32:
        chip_smoke.held_f32(got, ref, "f32", float(fmap.abs().max()))
    else:
        chip_smoke.held_one_ulp(got, ref, str(dtype))
    # a taller than wide map (the contraction order flips) and C = 36
    # (the scalar path)
    fmap2 = torch.randn(1, 45, 30, 36, generator=g, device=cuda).to(dtype)
    rois2 = chip_smoke.align_edge_rois(cuda, 1)
    got2 = roi_align_avg(fmap2, rois2, grid=grid)
    ref2 = roi_align_avg_plain(fmap2, rois2, grid=grid)
    if dtype == torch.float32:
        chip_smoke.held_f32(got2, ref2, "f32 tall", float(fmap2.abs().max()))
    else:
        chip_smoke.held_one_ulp(got2, ref2, f"{dtype} tall")


def test_roi_align_kernel_vs_gather_f32(cuda):
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_align import (roi_align_avg,
                                                roi_align_avg_gather)
    g = torch.Generator(device=cuda).manual_seed(1)
    fmap = torch.randn(2, 38, 60, 64, generator=g, device=cuda)
    rois = chip_smoke.align_edge_rois(cuda, 2)
    chip_smoke.held_f32(roi_align_avg(fmap, rois),
                        roi_align_avg_gather(fmap, rois), "vs gather",
                        float(fmap.abs().max()))


def test_roi_align_wrapper_refuses(cuda):
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
    fmap = torch.randn(1, 8, 8, 32, device=cuda)
    rois = chip_smoke.align_edge_rois(cuda, 1)
    with pytest.raises(ValueError):
        roi_align_avg(fmap, rois.cpu())
    with pytest.raises(TypeError):
        roi_align_avg(fmap.double(), rois)
    with pytest.raises(ValueError):
        roi_align_avg(fmap[..., ::2], rois)
    with pytest.raises(ValueError):
        roi_align_avg(fmap, rois, grid=(0, 9))


def _align_site_rois(cuda, n_img, n_rnd, seed):
    """The edge rois, then ``n_rnd`` random boxes an image (some past the
    map), grouped per image."""
    import chip_smoke
    g = torch.Generator(device=cuda).manual_seed(seed)
    edge = chip_smoke.align_edge_rois(cuda, n_img).reshape(n_img, -1, 5)
    rnd = torch.rand(n_img, n_rnd, 4, generator=g, device=cuda) * \
        torch.tensor([1000.0, 640.0, 1000.0, 640.0], device=cuda) - 20
    rnd = torch.cat([torch.minimum(rnd[..., :2], rnd[..., 2:]),
                     torch.maximum(rnd[..., :2], rnd[..., 2:])], -1)
    rnd = torch.cat([edge[:, :1, :1].expand(-1, n_rnd, 1), rnd], -1)
    return torch.cat([edge, rnd], 1).reshape(-1, 5).contiguous()


@pytest.mark.parametrize("fshape,dtype,out_dtype,n,grid", [
    ((4, 38, 60, 1024), torch.bfloat16, None, 128, (0, 2, 4, 6)),   # det
    ((4, 38, 60, 512), torch.bfloat16, None, 128, None),            # ic
    ((1, 38, 60, 1024), torch.float32, None, 36, None),     # SGG, f32 copy
    ((1, 38, 60, 1024), torch.bfloat16, torch.float32, 36, None),   # SGG
])
def test_roi_align_main_path_shapes(cuda, fshape, dtype, out_dtype, n, grid):
    """The main path's three sites (and the SGG site's former f32 copy):
    the staged mode, held to the plain version by the usual rules, and
    bit-equal to the per-cell mode (the first design's arithmetic)."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_align import (roi_align_avg,
                                                roi_align_avg_plain)
    g = torch.Generator(device=cuda).manual_seed(3)
    fmap = (torch.randn(*fshape, generator=g, device=cuda) * 4).to(dtype)
    rois = _align_site_rois(cuda, fshape[0], n - 12, 4)
    od = out_dtype or dtype
    before = dict(roi_align_avg.launches_by_mode)
    got = roi_align_avg(fmap, rois, grid=grid, out_dtype=od)
    assert roi_align_avg.last_plan["mode"] == "staged"
    assert roi_align_avg.launches_by_mode["staged"] == before["staged"] + 1
    assert got.dtype == od and got.shape[0] == rois.shape[0]
    ref = roi_align_avg_plain(fmap.to(od), rois, grid=grid)
    if od == torch.float32:
        chip_smoke.held_f32(got, ref, "site", float(fmap.float().abs().max()))
    else:
        chip_smoke.held_one_ulp(got, ref, "site")
    per_cell = roi_align_avg(fmap, rois, grid=grid, out_dtype=od,
                             channel_slice=-1)
    assert roi_align_avg.last_plan["mode"] == "per_cell"
    assert torch.equal(got, per_cell)


@pytest.mark.parametrize("fshape,p", [
    ((4, 37, 60, 512), 7),      # VGG16's detector site at 600x960
    ((4, 38, 60, 1024), 7),     # ResNet's non-fused align layout
    ((4, 38, 60, 1024), 5),     # POOLING_SIZE 5
])
def test_roi_align_full_grid_detector_sites(cuda, fshape, p):
    """RoIAlignAvg on the full PxP grid at the non-fused detector sites
    (bf16, 128 grouped rois an image): staged, within one bf16 ulp of the
    plain version, bit-equal to the per-cell mode."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_align import (roi_align_avg,
                                                roi_align_avg_plain)
    g = torch.Generator(device=cuda).manual_seed(11)
    fmap = (torch.randn(*fshape, generator=g, device=cuda) * 4).bfloat16()
    rois = _align_site_rois(cuda, fshape[0], 116, 12)
    got = roi_align_avg(fmap, rois, p, p)
    assert roi_align_avg.last_plan["mode"] == "staged"
    assert tuple(got.shape) == (rois.shape[0], p, p, fshape[3])
    chip_smoke.held_one_ulp(got, roi_align_avg_plain(fmap, rois, p, p),
                            "full-grid detector site")
    assert torch.equal(got, roi_align_avg(fmap, rois, p, p, channel_slice=-1))


@pytest.mark.parametrize("fshape", [(4, 38, 60, 1024), (1, 37, 60, 512)])
def test_roi_pool_detector_and_vgg_sites(cuda, fshape):
    """RoIPool at the detector site under POOLING_MODE=pool (B = 4, 128
    grouped rois an image, 1024 channels) and at VGG16's SGG site (one
    37-row, 512-channel map): staged, torch.equal to the plain version
    (taken 64 rois at a time) and to the per-bin mode."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_pool import roi_pool
    g = torch.Generator(device=cuda).manual_seed(13)
    b, h, w, _ = fshape
    fmap = torch.randn(*fshape, generator=g, device=cuda).bfloat16()
    n = 128 if b > 1 else 36
    rnd = torch.rand(b, n, 4, generator=g, device=cuda) * torch.tensor(
        [w * 16.0 + 40, h * 16.0 + 40] * 2, device=cuda) - 20
    idx = torch.arange(b, device=cuda, dtype=torch.float32)
    rois = torch.cat([idx[:, None, None].expand(b, n, 1),
                      torch.minimum(rnd[..., :2], rnd[..., 2:]),
                      torch.maximum(rnd[..., :2], rnd[..., 2:])], -1)
    rois = rois.reshape(-1, 5).contiguous()
    got = roi_pool(fmap, rois)
    assert roi_pool.last_plan["mode"] == "staged"
    assert torch.equal(got, chip_smoke.roi_pool_plain_chunked(fmap, rois))
    assert torch.equal(got, roi_pool(fmap, rois, channel_slice=-1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("grid", [None, (0, 2, 4, 6)])
def test_roi_align_widening_equals_the_kernel_on_the_f32_copy(cuda, dtype,
                                                              grid):
    """out_dtype=float32 on a bf16/f16 map is the kernel run on
    ``map.float()``, bit for bit, in both modes and a taller map."""
    from i2vsgg_tpu_torch.ops.roi_align import roi_align_avg
    g = torch.Generator(device=cuda).manual_seed(5)
    for fshape in ((1, 38, 60, 1024), (2, 45, 30, 48), (1, 20, 30, 36)):
        fmap = (torch.randn(*fshape, generator=g, device=cuda) * 4).to(dtype)
        rois = _align_site_rois(cuda, fshape[0], 24, 6)
        for sl in (0, -1):
            got = roi_align_avg(fmap, rois, grid=grid,
                                out_dtype=torch.float32, channel_slice=sl)
            want = roi_align_avg(fmap.float(), rois, grid=grid,
                                 channel_slice=sl)
            assert got.dtype == torch.float32
            assert torch.equal(got, want), (fshape, sl)


@pytest.mark.parametrize("fshape,dtype,mode", [
    ((1, 90, 130, 16), torch.float32, "staged"),     # only 4 channels fit
    ((1, 130, 130, 16), torch.bfloat16, "per_cell"),  # no slice fits
    ((2, 38, 60, 512), torch.bfloat16, "staged"),    # slices asked for
])
def test_roi_align_narrow_slices_and_the_per_cell_mode(cuda, fshape, dtype,
                                                       mode):
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_align import (roi_align_avg,
                                                roi_align_avg_plain)
    g = torch.Generator(device=cuda).manual_seed(6)
    fmap = (torch.randn(*fshape, generator=g, device=cuda) * 4).to(dtype)
    rois = _align_site_rois(cuda, fshape[0], 40, 7)
    before = dict(roi_align_avg.launches_by_mode)
    got = roi_align_avg(fmap, rois)
    assert roi_align_avg.last_plan["mode"] == mode
    assert roi_align_avg.launches_by_mode[mode] == before[mode] + 1
    if fshape[1] == 90:
        assert roi_align_avg.last_plan["slice"] == 4
    ref = roi_align_avg_plain(fmap, rois)
    if dtype == torch.float32:
        chip_smoke.held_f32(got, ref, "narrow", float(fmap.abs().max()))
    else:
        chip_smoke.held_one_ulp(got, ref, "narrow")
    for sl in (8, 16, 32, -1):
        if fshape[1] != 38 and sl > 0:
            continue
        assert torch.equal(roi_align_avg(fmap, rois, channel_slice=sl), got)
    with pytest.raises(RuntimeError):            # not a multiple of 8 bf16
        roi_align_avg(fmap.bfloat16(), rois, channel_slice=12)


@pytest.mark.parametrize("case", ["b2", "narrow", "per_bin", "slices"])
def test_roi_pool_staged_and_per_bin_modes(cuda, case):
    """torch.equal to the plain version: two images (rois of both, and
    batch indices clamped into range), a map where only a narrow slice
    fits, one where none fits (the per-bin mode), and every slice asked
    for at the serving shape."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops.roi_pool import roi_pool, roi_pool_plain
    g = torch.Generator(device=cuda).manual_seed(8)
    shape, dtype = {"b2": ((2, 38, 60, 1024), torch.bfloat16),
                    "narrow": ((1, 100, 120, 8), torch.float32),
                    "per_bin": ((1, 150, 150, 64), torch.bfloat16),
                    "slices": ((1, 38, 60, 1024), torch.bfloat16)}[case]
    fmap = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    rois = chip_smoke.edge_rois(cuda)
    rnd = torch.rand(64, 4, generator=g, device=cuda) * torch.tensor(
        [shape[2] * 16.0, shape[1] * 16.0] * 2, device=cuda)
    rnd = torch.cat([torch.zeros_like(rnd[:, :1]),
                     torch.minimum(rnd[:, :2], rnd[:, 2:]),
                     torch.maximum(rnd[:, :2], rnd[:, 2:])], 1)
    rois = torch.cat([rois, rnd]).contiguous()
    if case == "b2":
        rois[::3, 0] = 1.0
        rois[5, 0] = 7.0                   # clamped to the last image
        rois[6, 0] = -3.0                  # clamped to the first
    want = roi_pool_plain(fmap, rois)
    mode = "per_bin" if case == "per_bin" else "staged"
    before = dict(roi_pool.launches_by_mode)
    assert torch.equal(roi_pool(fmap, rois), want)
    assert roi_pool.last_plan["mode"] == mode
    assert roi_pool.launches_by_mode[mode] == before[mode] + 1
    if case == "narrow":
        assert roi_pool.last_plan["slice"] == 4
    if case == "slices":
        for sl in (8, 16, 32, -1):
            assert torch.equal(roi_pool(fmap, rois, channel_slice=sl), want)
        with pytest.raises(RuntimeError):        # not a multiple of 8 bf16
            roi_pool(fmap, rois, channel_slice=12)


def _chain_case(cuda, b, h, w, c, m, n, seed=0):
    """A map and folded chain weights of the JAX chain test's scale (x ~
    N(0, 1), weights and biases ~ 0.05 N(0, 1)) in the kernel's types."""
    import chip_smoke
    return chip_smoke.chain_test_case(cuda, b, h, w, c, m, n, seed)


@pytest.mark.parametrize("b,h,w,c,m,n", [
    (2, 9, 13, 128, 128, 3),       # odd sizes: partial tiles, the halo
    (1, 15, 20, 256, 128, 2),
    (4, 38, 60, 1024, 256, 1),     # the main path's shape, one block
    (4, 38, 60, 1024, 256, 22),    # ... and its 22-block layer3 tail
    # P not a multiple of the 128-row tile, H and W not multiples of the
    # 3x3's 8 x 16 pixel block, at both (C, M) widths
    (1, 37, 61, 512, 128, 2),
    (3, 37, 61, 1024, 256, 1)])
def test_bottleneck_chain_kernel_vs_plain(cuda, b, h, w, c, m, n):
    """The kernel against its plain version (f32 without TF32) as
    ``chip_smoke.held_chain`` holds it: every block alone on the chain's own
    map within one bf16 ulp and >= 99 % bit-equal, the n-block call equal to
    its blocks in turn, and no further from f64 than the plain version."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops.bottleneck import (bottleneck_chain,
                                                 bottleneck_chain_plain)
    x, params = _chain_case(cuda, b, h, w, c, m, n)
    x0 = x.clone()
    before = bottleneck_chain.launches
    got = bottleneck_chain(x, *params)
    assert bottleneck_chain.launches == before + 3 * n
    torch.cuda.synchronize()
    assert torch.equal(x, x0)                      # the input is not written
    chip_smoke.held_chain(bottleneck_chain, x, params, f"{n} blocks")
    if n <= 3:                    # short chains: the JAX chain test's bounds
        with chip_smoke.tf32_off():
            ref = bottleneck_chain_plain(x, *params)
        g, r = got.float(), ref.float()
        assert bool(((g - r).abs() <= 0.05 * r.abs() + 0.05).all())
        assert float(((g - r).abs() <= 0.02 * r.abs() + 0.02).float()
                     .mean()) > 0.999


@pytest.mark.parametrize("n", [3, 22])
def test_bottleneck_chain_check_refuses_wrong_chains(cuda, n):
    """``chip_smoke.held_chain`` refuses a chain that sums in bf16 and one
    that reads block 0's weights throughout, at the main path's shape."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops.bottleneck import bottleneck_chain
    x, params = _chain_case(cuda, 4, 38, 60, 1024, 256, n)
    assert len(chip_smoke.chain_controls(bottleneck_chain, x, params)) == 2


def test_bottleneck_chain_wrapper_refuses(cuda):
    from i2vsgg_tpu_torch.ops.bottleneck import bottleneck_chain
    x, params = _chain_case(cuda, 1, 4, 5, 128, 128, 1)
    with pytest.raises(ValueError):
        bottleneck_chain(x, params[0].cpu(), *params[1:])
    with pytest.raises(TypeError):
        bottleneck_chain(x.float(), *params)
    with pytest.raises(ValueError):
        bottleneck_chain(x.transpose(1, 2), *params)
    with pytest.raises(ValueError):
        bottleneck_chain(x[..., :64].contiguous(), *params)


def test_stage_on_the_card_runs_the_chain(cuda, monkeypatch):
    """A res50-width stage with the switch on launches the chain and agrees
    with the same stage on the CPU (the plain chain) to the chain bounds."""
    import chip_smoke
    from i2vsgg_tpu_torch.models import backbones as bb
    from i2vsgg_tpu_torch.models.layers import init_weights
    from i2vsgg_tpu_torch.ops.bottleneck import bottleneck_chain
    from i2vsgg_tpu_torch.utils.params import bf16_storage_cast
    stage = bf16_storage_cast(init_weights(
        bb.ResNetStage(512, 256, 6, 2), torch.Generator().manual_seed(0)))
    x = torch.randn(2, 512, 16, 20, generator=torch.Generator().manual_seed(1))
    monkeypatch.setenv("I2VSGG_PALLAS_BOTTLENECK", "1")
    with torch.no_grad():
        ref = stage(x.bfloat16())
        before = bottleneck_chain.launches
        got = copy.deepcopy(stage).to(cuda)(x.bfloat16().to(cuda))
    assert bottleneck_chain.launches == before + 3 * 5
    # block0 runs in bf16 on cuDNN and on oneDNN: the chain bounds of
    # tests/test_torch_bottleneck.py (one bf16 ulp of max|ref| absolute)
    g, r = bb.nchw_to_nhwc(got).cpu().float(), bb.nchw_to_nhwc(ref).float()
    ulp = 2.0 ** -8 * float(r.abs().max())
    assert bool(((g - r).abs() <= 0.05 * r.abs() + max(0.05, ulp)).all())
    assert float(((g - r).abs() <= 0.02 * r.abs() + max(0.02, ulp)).float()
                 .mean()) > 0.999


def _int8_image_case(device, shape, seed=0):
    """Mean-subtracted integer pixels (the int8 conv1's premise), a conv1
    weight and a BN affine."""
    from i2vsgg_tpu_torch.ops.conv1_int8 import DEFAULT_PIXEL_MEANS
    g = torch.Generator(device=device).manual_seed(seed)
    raw = torch.randint(0, 256, (*shape, 3), generator=g, device=device)
    x = raw.float() - torch.tensor(DEFAULT_PIXEL_MEANS, device=device)
    weight = torch.randn(64, 3, 7, 7, generator=g, device=device) * 0.1
    mul = torch.rand(64, generator=g, device=device) + 0.5
    add = torch.randn(64, generator=g, device=device)
    return x.contiguous(), weight, mul, add


@pytest.mark.parametrize("shape", [
    (1, 64, 96),        # 4 tiles of 16 x 32 outputs: fewer than the SMs
    (2, 50, 70),        # Ho 25, Wo 35: partial tiles in both axes
    (1, 7, 9), (1, 1, 1),
    (2, 5, 1), (1, 9, 2), (3, 4, 3),   # 1-3 pixels wide: all halo but one
    (3, 37, 301),       # Ho 19, Wo 151
    (16, 200, 300),     # 560 tiles: more than two a block, partial edges
    (1, 600, 960),
    (4, 600, 960)])     # the int8 path's frames: 1140 tiles
def test_conv1_int8_kernel_bit_equal_to_plain(cuda, shape):
    """B6 against its plain version on the same parameters: bit-equal, at
    odd sizes (partial tiles at Ho and Wo, rows and columns where the whole
    window is halo, fewer tiles than SMs and more than the persistent
    blocks, so that their loop wraps), B = 1 and the serving frames."""
    from i2vsgg_tpu_torch.ops import conv1_int8 as c8
    x, weight, mul, add = _int8_image_case(cuda, shape)
    params = c8.conv1_int8_params(weight, mul, add)
    before = c8.launches
    got = c8.conv1_bn_relu_int8(x, weight, mul, add)
    torch.cuda.synchronize()
    assert c8.launches == before + 1
    want = c8.conv1_bn_relu_int8_plain(x, *params)
    assert got.shape == (shape[0], (shape[1] - 1) // 2 + 1,
                         (shape[2] - 1) // 2 + 1, 64)
    assert torch.equal(got, want)
    # and the plain version on the card equals the one on the CPU
    assert torch.equal(want.cpu(), c8.conv1_bn_relu_int8_plain(
        x.cpu(), *(t.cpu() for t in params)))


@pytest.mark.parametrize("shape", [(1, 33, 47), (2, 50, 70), (4, 600, 960)])
def test_conv1_int8_kernel_on_clamps_and_ties(cuda, shape):
    """B6 bit-equal to its plain version on images that are not integer
    pixels (``chip_smoke.int8_edge_images``): shifted sums beyond the int8
    range (the clamp) and exactly k + 0.5 (half to even)."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops import conv1_int8 as c8
    _, weight, mul, add = _int8_image_case(cuda, (1, 8, 8))
    x = torch.from_numpy(chip_smoke.int8_edge_images(shape)).to(cuda)
    params = c8.conv1_int8_params(weight, mul, add)
    got = c8.conv1_int8_apply(x, *params)
    want = c8.conv1_bn_relu_int8_plain(x, *params)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), c8.conv1_bn_relu_int8_plain(
        x.cpu(), *(t.cpu() for t in params)))


def test_conv1_int8_wrapper_refuses(cuda):
    from i2vsgg_tpu_torch.ops import conv1_int8 as c8
    x, weight, mul, add = _int8_image_case(cuda, (1, 32, 40))
    with pytest.raises(TypeError):
        c8.conv1_bn_relu_int8(x.half(), weight, mul, add)
    with pytest.raises(ValueError):
        c8.conv1_bn_relu_int8(x[:, :, ::2], weight, mul, add)
    with pytest.raises(ValueError):
        c8.conv1_bn_relu_int8(x, weight[:32], mul, add)
    with pytest.raises(ValueError):
        c8.conv1_bn_relu_int8(x, weight.cpu(), mul, add)


@pytest.mark.parametrize("m", [1, 16, 17, 300])
def test_int8_linear_on_int_mm_exact(cuda, m):
    """``int8_linear`` on ``torch._int_mm`` against the f64 plain version:
    exact, also below 17 rows and at K, N not multiples of 8."""
    from i2vsgg_tpu_torch.ops import int8
    g = torch.Generator().manual_seed(m)
    for k, n in ((4608, 64), (50, 30)):
        a = torch.randint(-127, 128, (m, k), generator=g).to(torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g).to(torch.int8)
        a[0] = 127
        w[0] = 127
        before = int8.int8_linear.calls
        got = int8.int8_linear(a.to(cuda), w.to(cuda))
        assert int8.int8_linear.calls == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), int8.int8_linear(a, w))


@pytest.mark.parametrize("k,stride,shape", [
    (3, 1, (2, 256, 38, 60)), (1, 2, (1, 64, 13, 15)), (3, 1, (1, 24, 3, 4)),
    (3, 1, (16, 512, 4, 4))])
def test_int8_conv2d_on_int_mm_exact(cuda, k, stride, shape):
    """``int8_conv2d`` (im2col + ``_int_mm``) against the f64 plain version:
    exact, at a layer3 3x3, a strided 1x1, a grid under 17 rows and the
    per-roi 4x4 grids of layer4."""
    from i2vsgg_tpu_torch.ops import int8
    g = torch.Generator().manual_seed(k * stride)
    x = torch.randint(-127, 128, shape, generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (32, shape[1], k, k),
                      generator=g).to(torch.int8)
    x[0, :, :2] = 127
    w[0] = 127
    before = int8.int8_conv2d.calls
    xg = x.to(cuda).contiguous(memory_format=torch.channels_last)
    got = int8.int8_conv2d(xg, w.to(cuda), stride, k // 2)
    assert int8.int8_conv2d.calls == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), int8.int8_conv2d(x, w, stride, k // 2))


def test_int8_quantization_on_the_card_equals_the_cpu(cuda):
    """Scales and int8 taps computed on the card equal the CPU's (and so
    JAX's, tests/test_torch_int8.py): the scale is a correctly rounded
    division by 127, not a multiply by its reciprocal."""
    from i2vsgg_tpu_torch.ops import int8
    g = torch.Generator().manual_seed(7)
    w = torch.randn(512, 256, 3, 3, generator=g) * torch.rand(
        512, 1, 1, 1, generator=g) * 3
    x = torch.randn(64, 4096, generator=g) * torch.rand(64, 1, generator=g)
    a_s = torch.tensor(0.0123)
    for fn, args in ((int8.weight_quant, (w,)),
                     (int8.weight_quant, (w.bfloat16(),)),
                     (int8.dynamic_act_quant, (x,)),
                     (int8.row_act_quant, (x,)),
                     (int8.static_act_quant, (x, a_s))):
        got = fn(*(t.to(cuda) for t in args))
        want = fn(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a.cpu(), b), fn.__name__


@pytest.mark.parametrize("op", ["roi_align", "roi_pool"])
def test_roi_ops_under_autograd_launch_the_kernel(cuda, op):
    """Stage A's pooling with grad: the forward is the kernel (one counted
    launch, equal to the no-grad call), the backward the plain VJP, equal
    to the same VJP on the CPU at rtol 1e-5 with an atol of 1e-5 of the
    largest magnitude (f32 sums in another order; TF32 off), on an f32 map
    with ties."""
    import chip_smoke
    from i2vsgg_tpu_torch.ops import roi_align as ra
    from i2vsgg_tpu_torch.ops import roi_pool as rp
    fn = ra.roi_align_avg if op == "roi_align" else rp.roi_pool
    g = torch.Generator(device=cuda).manual_seed(0)
    fmap = torch.relu(torch.randn(1, 38, 63, 64, generator=g, device=cuda))
    fmap = (fmap * 4).round() / 4                     # ties after the ReLU
    rois = chip_smoke.edge_rois(cuda)
    x = fmap.clone().requires_grad_(True)
    before = fn.launches
    out = fn(x, rois)
    assert fn.launches == before + 1
    assert torch.equal(out.detach(), fn(fmap, rois))
    grad = torch.randn(out.shape, generator=g, device=cuda)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out.backward(grad)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    xc = fmap.cpu().requires_grad_(True)
    fn(xc, rois.cpu()).backward(grad.cpu())
    scale = float(xc.grad.abs().max())
    assert scale > 0
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("pooling", ["pool", "align"])
def test_stage_b_step_pools_forward_only(cuda, pooling):
    """A Stage B step on the card (res10, head width 128, two 64x96 frames,
    dropout on): one kernel launch an image at the head's pooling and no
    RoI backward (the map is detached), a finite loss, the trunk and its
    buffers bit-unchanged and every head tensor moved."""
    import chip_smoke
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.config import Config
    from i2vsgg_tpu_torch.ops import roi_align as ra
    from i2vsgg_tpu_torch.ops import roi_pool as rp
    from i2vsgg_tpu_torch.train.det_da import TrainState
    from i2vsgg_tpu_torch.train.sgg import sgg_optimizer, train_step
    args = set_dataset_args(parse_args(
        ["--net", "res10", "--num_relations", "7", "--max_pairs", "12"]))
    cfg = Config().replace(COMPUTE_DTYPE="float32")
    model = chip_smoke.sgg_training_model(args, cfg, pooling, 3,
                                          fc_dim=128).to(cuda)
    state = TrainState(model, sgg_optimizer(model, 1e-3, cfg), seed=3)
    batch = chip_smoke.sgg_batches(chip_smoke.SGG_TINY, 3, 12, 7, cuda)
    prd = torch.randn(7, 300, device=cuda)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fn = ra.roi_align_avg if pooling == "align" else rp.roi_pool
    launches = fn.launches
    with chip_smoke.roi_backward_calls() as bwd:
        m = train_step(state, batch, prd)
    assert fn.launches == launches + chip_smoke.SGG_TINY["frames"]
    assert not any(bwd.calls.values())
    assert np.isfinite(float(m["loss"])) and int(m["n_pairs"]) > 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) == k.startswith("trunk."), k
