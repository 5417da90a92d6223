"""The port's RoIAlign ops (``i2vsgg_tpu_torch/ops/roi_align.py``) against
the JAX package on the CPU, and the plain version of the RoIAlignAvg kernel
against the independent gather oracle on edge-case rois.

Tolerances: f32 to rtol 1e-5 with atol 1e-5 of the feature map's largest
magnitude (the same taps and weights summed in another order); bf16 at most
one bf16 ulp apart with >= 99.9 % of the elements bit-equal (the same bf16
weights, f32 sums in another order, rounded once).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from i2vsgg_tpu.ops import roi_align as jax_ra
from i2vsgg_tpu_torch.ops import roi_align as ra


def rand_rois(rs, n, b=1, h=600, w=960):
    """n random boxes per image, grouped; some reach past the image."""
    xy = rs.rand(b * n, 4) * [w * 1.2, h * 1.2, w * 1.2, h * 1.2] - 40
    boxes = np.concatenate([np.minimum(xy[:, :2], xy[:, 2:]),
                            np.maximum(xy[:, :2], xy[:, 2:])], 1)
    bidx = np.repeat(np.arange(b), n)[:, None]
    return np.concatenate([bidx, boxes], 1).astype(np.float32)


def close(got, ref, scale):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref,
                                                                np.float32),
                               rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("size", [(8, 8), (5, 9)])
def test_roi_align_single_tap_matches_jax(size):
    rs = np.random.RandomState(0)
    f = rs.randn(2, 38, 60, 16).astype(np.float32)
    rois = np.concatenate([rand_rois(rs, 10, 2),
                           chip_smoke.align_edge_rois("cpu", 2).numpy()])
    ref = jax_ra.roi_align(jnp.asarray(f), jnp.asarray(rois), *size, 1 / 16)
    got = ra.roi_align(torch.from_numpy(f), torch.from_numpy(rois), *size,
                       1 / 16)
    close(got, ref, np.abs(f).max())


def test_roi_align_avg_gather_matches_jax():
    rs = np.random.RandomState(1)
    f = rs.randn(2, 38, 60, 16).astype(np.float32)
    rois = rand_rois(rs, 12, 2)
    rois[:, 0] = rs.randint(0, 2, len(rois))       # any batch index
    ref = jax_ra.roi_align_avg_gather(jnp.asarray(f), jnp.asarray(rois))
    got = ra.roi_align_avg_gather(torch.from_numpy(f), torch.from_numpy(rois))
    close(got, ref, np.abs(f).max())


@pytest.mark.parametrize("grid", [None, (0, 2, 4, 6)])
@pytest.mark.parametrize("hw", [(38, 60), (45, 30)])
def test_plain_matches_gather_on_edge_rois(hw, grid):
    """roi_align_avg_plain (the einsum pair, the kernel's plain version)
    against the 4-corner gather oracle, f32, on the edge rois: past the
    edge, negative, 1 pixel, wholly outside, the H-2/W-2 clamp; wider and
    taller maps (the contraction order flips)."""
    h, w = hw
    g = torch.Generator().manual_seed(2)
    f = torch.randn(2, h, w, 32, generator=g)
    rois = chip_smoke.align_edge_rois("cpu", 2)
    got = ra.roi_align_avg_plain(f, rois, grid=grid)
    ref = ra.roi_align_avg_gather(f, rois)
    if grid is not None:
        ref = ref[:, list(grid)][:, :, list(grid)]
    close(got, ref, float(f.abs().max()))
    assert got[2].abs().max() == 0 and got[3].abs().max() == 0  # outside
    if hw == (38, 60):
        assert got[6].abs().max() > 0         # samples in the last row/col


def test_plain_bf16_matches_jax_bf16():
    """In bf16 both packages round the interpolation weights to bf16 at the
    same points and contract in f32."""
    rs = np.random.RandomState(3)
    f = (rs.randn(2, 38, 60, 64) * 4).astype(np.float32)
    rois = np.concatenate([rand_rois(rs, 10, 1),
                           chip_smoke.align_edge_rois("cpu", 1).numpy()])
    rois = np.concatenate([rois, rois])
    rois[len(rois) // 2:, 0] = 1
    fb = torch.from_numpy(f).bfloat16()
    ref = np.asarray(jax_ra.roi_align_avg(jnp.asarray(f, jnp.bfloat16),
                                          jnp.asarray(rois)), np.float32)
    got = ra.roi_align_avg(fb, torch.from_numpy(rois)).float().numpy()
    gap = np.abs(got - ref)
    assert (gap <= 2.0 ** -7 * np.abs(ref)).all(), float(gap.max())
    assert (got == ref).mean() >= 0.999


def test_wrapper_cpu_path_and_refusals():
    f = torch.randn(2, 10, 12, 8)
    rois = chip_smoke.align_edge_rois("cpu", 2)
    before = ra.roi_align_avg.launches
    out = ra.roi_align_avg(f, rois, grid=(1, 3))
    assert ra.roi_align_avg.launches == before          # plain version
    assert torch.equal(out, ra.roi_align_avg_plain(f, rois, grid=(1, 3)))
    with pytest.raises(TypeError):
        ra.roi_align_avg(f.double(), rois)
    with pytest.raises(TypeError):
        ra.roi_align_avg(f, rois.double())
    with pytest.raises(ValueError):
        ra.roi_align_avg(f[..., ::2], rois)              # not contiguous
    with pytest.raises(ValueError):
        ra.roi_align_avg(f, rois[:-1])                   # R % B != 0
    with pytest.raises(ValueError):
        ra.roi_align_avg(f, rois, grid=(0, 7))           # outside the grid
    with pytest.raises(ValueError):
        ra.roi_align_avg(f[:, :1], rois)                 # a 1-row map


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("grid", [None, (0, 2, 4, 6)])
def test_widening_mode_equals_plain_on_the_f32_copy(dtype, grid):
    """out_dtype=float32 on a bf16/f16 map is the function of pooling
    ``map.float()`` (f32 weights, f32 output), bit for bit, on the edge
    rois of two images."""
    g = torch.Generator().manual_seed(4)
    f = (torch.randn(2, 38, 60, 32, generator=g) * 4).to(dtype)
    rois = chip_smoke.align_edge_rois("cpu", 2)
    got = ra.roi_align_avg(f, rois, grid=grid, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, ra.roi_align_avg_plain(f.float(), rois,
                                                   grid=grid))
    # the same map's own dtype is the default
    assert torch.equal(ra.roi_align_avg(f, rois, grid=grid, out_dtype=dtype),
                       ra.roi_align_avg(f, rois, grid=grid))


def test_wrapper_refuses_a_narrowing_out_dtype():
    f = torch.randn(1, 10, 12, 8)
    rois = chip_smoke.align_edge_rois("cpu", 1)
    for fmap, out_dtype in ((f, torch.bfloat16), (f, torch.float16),
                            (f.bfloat16(), torch.float16),
                            (f.bfloat16(), torch.float64)):
        with pytest.raises(TypeError):
            ra.roi_align_avg(fmap, rois, out_dtype=out_dtype)
