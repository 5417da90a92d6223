"""RoIPool (max pooling over quantized bins) — counterpart of
``i2vsgg_tpu/ops/roi_pool.py`` and its Pallas kernel
``i2vsgg_tpu/ops/pallas/roi_pool_kernel.py``.

Semantics (torchvision ROIPool math, as the SGG relation head uses it,
``resnet_SGG_emb.py:82``)::

    roi_start = round(coord * spatial_scale)        # half to even
    roi_size  = max(roi_end - roi_start + 1, 1)
    bin(p)    = [floor(p * roi_size / P) + roi_start,
                 ceil((p+1) * roi_size / P) + roi_start)   clamped to [0, dim]
    out       = max over bin, 0 if bin empty

``roi_pool`` is the op the model calls. For a CUDA feature map it launches
the hand-written kernel ``csrc/roi_pool.cu`` (or raises); it takes the plain
version ``roi_pool_plain`` only for CPU tensors. ``roi_pool.launches`` counts
the kernel launches, ``roi_pool.launches_by_mode`` the same launches by the
kernel's mode (``staged``: the map slice in shared memory; ``per_bin``: one
block per output bin, for maps no slice of which fits), and
``roi_pool.last_plan`` holds the last launch's mode, channel slice and
shared memory.

Under autograd (grad enabled and ``features`` requiring it) the op is a
``torch.autograd.Function``: the same forward (the kernel on the card, one
counted launch), and for backward ``roi_pool_backward``, the plain version's
vector-Jacobian product in plain PyTorch. JAX differentiates its jnp sweep,
whose ``max`` splits the gradient evenly among tied maxima (after a ReLU,
many bins are all zeros); ``amax``'s backward splits it the same way, while
``torch.max(dim)`` would send it all to one index. The rois get no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from i2vsgg_tpu_torch.utils import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def bin_bounds(rois, spatial_scale, h, w, ph, pw):
    """Quantized bin bounds in int32, exactly as the JAX sweep computes them.

    Returns hstart/hend (R, PH), wstart/wend (R, PW).
    """
    r = torch.round(rois[:, 1:5].float() * spatial_scale).to(torch.int32)
    start_w, start_h, end_w, end_h = r.unbind(1)
    roi_w = torch.clamp_min(end_w - start_w + 1, 1)[:, None]
    roi_h = torch.clamp_min(end_h - start_h + 1, 1)[:, None]
    p_h = torch.arange(ph, dtype=torch.int32, device=rois.device)[None]
    p_w = torch.arange(pw, dtype=torch.int32, device=rois.device)[None]
    hstart = torch.clamp(p_h * roi_h // ph + start_h[:, None], 0, h)
    hend = torch.clamp(-((-(p_h + 1) * roi_h) // ph) + start_h[:, None], 0, h)
    wstart = torch.clamp(p_w * roi_w // pw + start_w[:, None], 0, w)
    wend = torch.clamp(-((-(p_w + 1) * roi_w) // pw) + start_w[:, None], 0, w)
    return hstart, hend, wstart, wend


def roi_pool_plain(features: torch.Tensor, rois: torch.Tensor,
                   pooled_height: int = 7, pooled_width: int = 7,
                   spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Plain PyTorch RoIPool: a masked row-max sweep then a masked col-max
    sweep over whole feature-map rows (``i2vsgg_tpu/ops/roi_pool.py:76-102``),
    vectorised over rois and bins.

    features: (B, H, W, C); rois: (R, 5) [batch_idx, x1, y1, x2, y2].
    Returns (R, PH, PW, C) in the feature dtype.
    """
    b, h, w, c = features.shape
    ph, pw = pooled_height, pooled_width
    hs, he, ws, we = bin_bounds(rois, spatial_scale, h, w, ph, pw)
    dev = features.device
    hh = torch.arange(h, dtype=torch.int32, device=dev)
    ww = torch.arange(w, dtype=torch.int32, device=dev)
    row_mask = (hh >= hs[..., None]) & (hh < he[..., None])      # (R, PH, H)
    col_mask = (ww >= ws[..., None]) & (ww < we[..., None])      # (R, PW, W)
    if b == 1:
        fmap = features[:1]                                       # broadcast
    else:
        bidx = rois[:, 0].to(torch.int64).clamp(0, b - 1)
        fmap = features[bidx]                                     # (R, H, W, C)
    neg = torch.finfo(features.dtype).min
    # row sweep -> (R, PH, W, C); col sweep -> (R, PH, PW, C). A max is one of
    # its inputs, so sweeping in the storage dtype is exact.
    rows = torch.where(row_mask[:, :, :, None, None], fmap[:, None],
                       neg).amax(dim=2)
    out = torch.where(col_mask[:, None, :, :, None], rows[:, :, None],
                      neg).amax(dim=3)
    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]
    return torch.where(empty[..., None], torch.zeros((), dtype=out.dtype,
                                                     device=dev), out)


def roi_pool_backward(grad_out: torch.Tensor, features: torch.Tensor,
                      rois: torch.Tensor, pooled_height: int = 7,
                      pooled_width: int = 7,
                      spatial_scale: float = 1.0 / 16.0,
                      chunk: int = 16) -> torch.Tensor:
    """The gradient of ``roi_pool_plain`` with respect to ``features``:
    autograd through the plain sweep, on the map widened to f32 (JAX sweeps
    a bf16 map in f32, its ``NEG`` fill being an f32 constant), ``chunk``
    rois at a time (a chunk's sweep holds (chunk, PH, H, W, C) values), the
    f32 sum cast once to the map's dtype."""
    f = features.detach().float().requires_grad_(True)
    grad = torch.zeros_like(f)
    with torch.enable_grad():
        for s in range(0, rois.shape[0], chunk):
            out = roi_pool_plain(f, rois[s:s + chunk], pooled_height,
                                 pooled_width, spatial_scale)
            grad += torch.autograd.grad(out, f, grad_out[s:s + chunk].float())[0]
    return grad.to(features.dtype)


def _check(features: torch.Tensor, rois: torch.Tensor):
    if features.dim() != 4:
        raise ValueError(f"features must be (B, H, W, C), got {tuple(features.shape)}")
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


@functools.cache
def _forward():
    """The kernel's C launcher, built and typed once per process."""
    fn = cuda_build.load("roi_pool.cu").i2vsgg_roi_pool_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    return fn


_MODES = ("staged", "per_bin")


def _launch(features, rois, ph, pw, spatial_scale, channel_slice):
    fn = _forward()
    b, h, w, c = features.shape
    r = rois.shape[0]
    out = torch.empty((r, ph, pw, c), dtype=features.dtype,
                      device=features.device)
    if r == 0:
        return out
    plan = (ctypes.c_int * 3)()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = fn(features.data_ptr(), rois.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[features.dtype], b, h, w, c, r, ph, pw,
                 float(spatial_scale), int(channel_slice), plan, stream)
    if err != 0:
        raise RuntimeError(f"roi_pool kernel launch failed: cudaError {err}")
    if plan[0] < 0:                      # an empty output: nothing launched
        return out
    mode = _MODES[plan[0]]
    roi_pool.launches += 1
    roi_pool.launches_by_mode[mode] += 1
    roi_pool.last_plan = {"mode": mode, "slice": plan[1],
                          "smem_bytes": plan[2]}
    return out


def roi_pool(features: torch.Tensor, rois: torch.Tensor,
             pooled_height: int = 7, pooled_width: int = 7,
             spatial_scale: float = 1.0 / 16.0,
             channel_slice: int = 0) -> torch.Tensor:
    """Max RoIPool. features: (B, H, W, C) NHWC in f32/bf16/f16;
    rois: (R, 5) f32 ``[batch_idx, x1, y1, x2, y2]`` in input-image coords.
    Returns (R, PH, PW, C) in the feature dtype.

    ``channel_slice`` (CUDA only): 0 lets the kernel choose its mode and
    slice, > 0 asks for that channel slice (a multiple of 16 bytes of the
    map's dtype where C is), < 0 for the per-bin mode.

    A CUDA feature map goes to the kernel, which counts one launch in
    ``roi_pool.launches``; a CPU one to ``roi_pool_plain``. With grad
    enabled and ``features.requires_grad``, the same forward runs in
    ``_RoIPoolFn`` and its backward is ``roi_pool_backward``.
    """
    _check(features, rois)
    if torch.is_grad_enabled() and features.requires_grad:
        return _RoIPoolFn.apply(features, rois, pooled_height, pooled_width,
                                spatial_scale, channel_slice)
    return _forward_any(features, rois, pooled_height, pooled_width,
                        spatial_scale, channel_slice)


def _forward_any(features, rois, pooled_height, pooled_width, spatial_scale,
                 channel_slice):
    if features.device.type == "cuda":
        return _launch(features, rois, pooled_height, pooled_width,
                       spatial_scale, channel_slice)
    if features.device.type != "cpu":
        raise ValueError(f"unsupported device {features.device}")
    return roi_pool_plain(features, rois, pooled_height, pooled_width,
                          spatial_scale)


class _RoIPoolFn(torch.autograd.Function):
    """``roi_pool`` under autograd: the kernel (or, on the CPU, the plain
    version) forward, the plain VJP backward."""

    @staticmethod
    def forward(ctx, features, rois, ph, pw, spatial_scale, channel_slice):
        ctx.save_for_backward(features, rois)
        ctx.args = (ph, pw, spatial_scale)
        return _forward_any(features, rois, ph, pw, spatial_scale,
                            channel_slice)

    @staticmethod
    def backward(ctx, grad_out):
        features, rois = ctx.saved_tensors
        return (roi_pool_backward(grad_out, features, rois, *ctx.args),
                None, None, None, None, None)


roi_pool.launches = 0
roi_pool.launches_by_mode = dict.fromkeys(_MODES, 0)
roi_pool.last_plan = None
