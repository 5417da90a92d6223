"""RoIAlign with the reference's single-sample semantics — counterpart of
``i2vsgg_tpu/ops/roi_align.py`` and its Pallas kernel
``i2vsgg_tpu/ops/pallas/roi_align_kernel.py`` (B1).

The reference's CUDA RoIAlign (``roi_align_kernel.cu:15-73``) takes ONE
bilinear tap per output cell (``roi_align``), and ``RoIAlignAvg`` evaluates a
(P+1)x(P+1) grid and 2x2-stride-1 average-pools it to PxP. That is a
separable linear map of the feature map, so it factors into per-roi row/col
weight matrices with the average folded in:

    out[r] = (A @ Ry[r]) @ fmap[b_r] @ (A @ Rx[r])^T        (per channel)

``roi_align_avg_plain`` runs it as the two contractions of the JAX package's
production path (weights in the feature dtype, contractions in f32, result
cast to the feature dtype); ``roi_align_avg_gather`` is the 4-corner gather
oracle. ``roi_align_avg`` is the op the models call: a CUDA feature map goes
to the hand-written kernel ``csrc/roi_align.cu`` (or the call raises), a CPU
one to ``roi_align_avg_plain``. ``roi_align_avg.launches`` counts the kernel
launches, ``roi_align_avg.launches_by_mode`` the same launches by the
kernel's mode (``staged``: the map slice in shared memory; ``per_cell``:
one block per output cell, for maps no slice of which fits), and
``roi_align_avg.last_plan`` holds the last launch's mode, channel slice and
shared memory.

``out_dtype=torch.float32`` on a bf16/f16 map is the widening mode: the
function of pooling ``features.float()`` (f32 weights, f32 output) without
the copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from i2vsgg_tpu_torch.utils import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              aligned_height: int, aligned_width: int,
              spatial_scale: float) -> torch.Tensor:
    """Single-sample RoIAlign (``roi_align.py:38``).

    features (B, H, W, C) NHWC; rois (R, 5) ``[batch_idx, x1, y1, x2, y2]``
    in input-image coords. Returns (R, aligned_height, aligned_width, C).
    """
    b, h, w, c = features.shape
    dt = features.dtype
    batch_idx = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    bin_w = torch.clamp_min(x2 - x1 + 1.0, 0.0) / (aligned_width - 1.0)
    bin_h = torch.clamp_min(y2 - y1 + 1.0, 0.0) / (aligned_height - 1.0)
    ph = torch.arange(aligned_height, dtype=dt, device=features.device)
    pw = torch.arange(aligned_width, dtype=dt, device=features.device)
    ys = ph[None, :] * bin_h[:, None] + y1[:, None]              # (R, AH)
    xs = pw[None, :] * bin_w[:, None] + x1[:, None]              # (R, AW)
    inside_y = (ys >= 0) & (ys < h)
    inside_x = (xs >= 0) & (xs < w)
    hstart = torch.clamp_max(torch.floor(ys), h - 2.0)
    wstart = torch.clamp_max(torch.floor(xs), w - 2.0)
    h_ratio = ys - hstart
    w_ratio = xs - wstart
    hs = torch.clamp(hstart.to(torch.int64), 0, h - 2)
    ws = torch.clamp(wstart.to(torch.int64), 0, w - 2)

    bi = batch_idx[:, None, None]
    yi = hs[:, :, None]
    xi = ws[:, None, :]
    ul = features[bi, yi, xi]                              # (R, AH, AW, C)
    ur = features[bi, yi, xi + 1]
    dl = features[bi, yi + 1, xi]
    dr = features[bi, yi + 1, xi + 1]
    hr = h_ratio[:, :, None, None]
    wr = w_ratio[:, None, :, None]
    out = (ul * (1 - hr) * (1 - wr) + ur * (1 - hr) * wr
           + dl * hr * (1 - wr) + dr * hr * wr)
    inside = (inside_y[:, :, None] & inside_x[:, None, :])[..., None]
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device)).to(dt)


def roi_align_avg_gather(features: torch.Tensor, rois: torch.Tensor,
                         pooled_height: int = 7, pooled_width: int = 7,
                         spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """RoIAlignAvg via 4-corner gathers — the semantics oracle, independent
    of the separable form. Returns (R, P, P, C)."""
    x = roi_align(features, rois, pooled_height + 1, pooled_width + 1,
                  spatial_scale)
    return 0.25 * (x[:, :-1, :-1] + x[:, 1:, :-1] + x[:, :-1, 1:]
                   + x[:, 1:, 1:])


def _interp_matrix(coords, extent: int, dtype):
    """Per-roi 1-D bilinear interpolation matrix.

    coords: (R, G) sample positions. Returns (R, G, extent) weights W with
    out[g] = sum_h W[g, h] * f[h] reproducing the reference's single-tap
    bilinear (hstart = min(floor(y), H-2), extrapolating ratios, zero
    outside [0, extent)). [roi_align_kernel.cu:42-73]
    """
    inside = (coords >= 0) & (coords < extent)
    start = torch.clamp_max(torch.floor(coords), extent - 2.0)
    ratio = coords - start
    s = torch.clamp(start.to(torch.int32), 0, extent - 2)
    grid = torch.arange(extent, dtype=torch.int32, device=coords.device)
    one0 = (grid == s[..., None]).to(dtype)
    one1 = (grid == (s + 1)[..., None]).to(dtype)
    w = one0 * (1.0 - ratio[..., None]).to(dtype) + one1 * ratio[..., None].to(dtype)
    return w * inside[..., None].to(dtype)


def _avg_matrix(p: int, dtype, device):
    """(P, P+1) matrix of the 2x2 stride-1 average along one axis."""
    eye = torch.eye(p + 1, dtype=dtype, device=device)
    return 0.5 * (eye[:-1] + eye[1:])


def folded_weights(rois: torch.Tensor, h: int, w: int, ph: int, pw: int,
                   spatial_scale: float, grid: tuple | None, dtype):
    """The per-roi row and column weights of RoIAlignAvg, (R, GH, H) and
    (R, GW, W) in ``dtype``: single-tap bilinear on the (P+1) grid with the
    2x2 average folded in, restricted to ``grid`` (GH, GW = PH, PW without
    one)."""
    dev = rois.device
    f32 = torch.float32
    rois = rois.to(f32)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    bin_w = torch.clamp_min(x2 - x1 + 1.0, 0.0) / pw
    bin_h = torch.clamp_min(y2 - y1 + 1.0, 0.0) / ph
    gy = torch.arange(ph + 1, dtype=f32, device=dev)
    gx = torch.arange(pw + 1, dtype=f32, device=dev)
    ys = gy[None, :] * bin_h[:, None] + y1[:, None]          # (R, PH+1)
    xs = gx[None, :] * bin_w[:, None] + x1[:, None]
    # weights in the feature dtype, as the JAX path builds them
    ry = torch.einsum("ip,rph->rih", _avg_matrix(ph, dtype, dev),
                      _interp_matrix(ys, h, dtype))
    rx = torch.einsum("jq,rqw->rjw", _avg_matrix(pw, dtype, dev),
                      _interp_matrix(xs, w, dtype))
    if grid is not None:
        sel = torch.as_tensor(grid, dtype=torch.long, device=dev)
        ry, rx = ry[:, sel], rx[:, sel]
    return ry, rx


def roi_align_avg_plain(features: torch.Tensor, rois: torch.Tensor,
                        pooled_height: int = 7, pooled_width: int = 7,
                        spatial_scale: float = 1.0 / 16.0,
                        grid: tuple | None = None) -> torch.Tensor:
    """RoIAlignAvg as two contractions (exact single-tap semantics), the
    plain version of the kernel.

    features: (B, H, W, C) NHWC; rois: (R, 5) grouped by image,
    R = B * N with batch_idx = r // N. ``grid`` optionally restricts the
    output to a subset of the PxP positions (same subset on both axes), e.g.
    (0, 2, 4, 6) for the cells a following stride-2 conv samples.

    Returns (R, P, P, C), or (R, len(grid), len(grid), C), in the feature
    dtype.
    """
    b, h, w, c = features.shape
    r = rois.shape[0]
    if r % b:
        raise ValueError("rois must be grouped per image (R = B * N)")
    n = r // b
    f32 = torch.float32
    ry, rx = folded_weights(rois, h, w, pooled_height, pooled_width,
                            spatial_scale, grid, features.dtype)
    gh, gw = ry.shape[1], rx.shape[1]
    # contracted in f32
    ry = ry.to(f32).reshape(b, n, gh, h)
    rx = rx.to(f32).reshape(b, n, gw, w)
    fmap = features.to(f32)
    # contract the longer spatial dim first: the (B, N, G, other, C)
    # intermediate is then the smaller one
    if w >= h:
        t = torch.einsum("bnjw,bhwc->bnjhc", rx, fmap)
        out = torch.einsum("bnjhc,bnih->bnijc", t, ry)
    else:
        t = torch.einsum("bnih,bhwc->bniwc", ry, fmap)
        out = torch.einsum("bniwc,bnjw->bnijc", t, rx)
    return out.reshape(r, gh, gw, c).to(features.dtype)


def _check(features, rois, ph, pw, grid, out_dtype):
    if features.dim() != 4:
        raise ValueError(f"features must be (B, H, W, C), got "
                         f"{tuple(features.shape)}")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"rois must be (R, 5), got {tuple(rois.shape)}")
    if features.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported feature dtype {features.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if rois.device != features.device:
        raise ValueError("features and rois must be on the same device")
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError("features (NHWC) and rois must be contiguous")
    b, h, w, _ = features.shape
    if rois.shape[0] % b:
        raise ValueError("rois must be grouped per image (R = B * N)")
    if h < 2 or w < 2:
        raise ValueError(f"feature map {h}x{w}: the bilinear tap needs 2x2")
    if ph != pw or not 1 <= ph <= 15:
        raise ValueError(f"pooled size {ph}x{pw}: square, at most 15")
    if grid is not None and not all(0 <= int(g) < ph for g in grid):
        raise ValueError(f"grid {grid} outside [0, {ph})")
    if out_dtype not in (features.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} on a {features.dtype} map: "
                        "only the map's dtype or the widening to float32")


@functools.cache
def _forward():
    """The kernel's C launcher, built and typed once per process."""
    fn = cuda_build.load("roi_align.cu").i2vsgg_roi_align_avg_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    return fn


_MODES = ("staged", "per_cell")


def _launch(features, rois, p, spatial_scale, grid, out_dtype,
            channel_slice):
    fn = _forward()
    b, h, w, c = features.shape
    r = rois.shape[0]
    sel = tuple(range(p)) if grid is None else tuple(int(g) for g in grid)
    code = sum(g << (4 * i) for i, g in enumerate(sel))   # 4 bits a cell
    out = torch.empty((r, len(sel), len(sel), c), dtype=out_dtype,
                      device=features.device)
    if r == 0:
        return out
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = fn(features.data_ptr(), rois.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[features.dtype],
                 int(out_dtype != features.dtype), b, h, w, c, r, p,
                 len(sel), code, float(spatial_scale), int(channel_slice),
                 plan, stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError {err}")
    if plan[0] < 0:                      # an empty output: nothing launched
        return out
    mode = _MODES[plan[0]]
    roi_align_avg.launches += 1
    roi_align_avg.launches_by_mode[mode] += 1
    roi_align_avg.last_plan = {"mode": mode, "slice": plan[1],
                               "smem_bytes": plan[2]}
    return out


def roi_align_avg(features: torch.Tensor, rois: torch.Tensor,
                  pooled_height: int = 7, pooled_width: int = 7,
                  spatial_scale: float = 1.0 / 16.0,
                  grid: tuple | None = None, out_dtype=None,
                  channel_slice: int = 0) -> torch.Tensor:
    """RoIAlignAvg (contract of ``roi_align_avg_plain``). features: (B, H, W,
    C) NHWC in f32/bf16/f16; rois: (R, 5) f32 grouped per image.

    ``out_dtype``: the map's dtype (the default), or ``torch.float32`` on a
    bf16/f16 map, which is exactly ``roi_align_avg_plain(features.float(),
    ...)``; anything else is refused. ``channel_slice`` (CUDA only): 0 lets
    the kernel choose its mode and slice, > 0 asks for that channel slice
    (a multiple of 16 bytes of the map's dtype where C is), < 0 for the
    per-cell mode.

    A CUDA feature map goes to the kernel, which counts one launch in
    ``roi_align_avg.launches``; a CPU one to ``roi_align_avg_plain``.
    """
    out_dtype = features.dtype if out_dtype is None else out_dtype
    _check(features, rois, pooled_height, pooled_width, grid, out_dtype)
    if features.device.type == "cuda":
        return _launch(features, rois, pooled_height, spatial_scale, grid,
                       out_dtype, channel_slice)
    if features.device.type != "cpu":
        raise ValueError(f"unsupported device {features.device}")
    return roi_align_avg_plain(features.to(out_dtype), rois, pooled_height,
                               pooled_width, spatial_scale, grid)


roi_align_avg.launches = 0
roi_align_avg.launches_by_mode = dict.fromkeys(_MODES, 0)
roi_align_avg.last_plan = None
