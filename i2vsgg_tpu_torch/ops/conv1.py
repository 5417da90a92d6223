"""ResNet conv1 (7x7, stride 2, pad 3) + FrozenBN affine + ReLU, and the
caffe stem maxpool after it — counterpart of the JAX package's Pallas
kernels ``i2vsgg_tpu/ops/pallas/conv1_kernel.py`` (the four B3 entries) and
``conv1_v2_kernel.py`` (B5, the BN scale folded into the weights).

The host contract is copied as it is: ``conv1_plane_geometry`` (with the
TPU-derived ``rt``, ``hq`` and ``wq``), the parity-plane layout
``(B, 2, 2, 3, Hq, Wq)`` in bf16 with the pad-3 halo baked in, and
``Conv1Planes``. Host planes packed by the port are byte-identical to those
of the JAX packer (and of ``runtime/io_runtime.cc``). The tap for kernel
offset ``(dr, dc)`` of output ``(y, x)`` is
``plane[dr % 2][dc % 2][c][y + dr // 2][x + dc // 2]``.

Every entry takes the port's own parameters: ``weight`` is ``conv1.weight``
(64, 3, 7, 7) and ``mul``/``add`` are the FrozenBN affine in f32. Inputs and
weights are rounded to bf16, products accumulate in f32, the epilogue is
``max(y * mul + add, 0)`` (the v2 mode: ``max(y + add, 0)`` with bf16
weights ``bf16(w * mul)``) in f32, and the output is bf16 NHWC.

On a CUDA tensor every entry launches the hand-written kernel of
``csrc/conv1.cu`` once, the stem's pool fused (or raises); on a CPU tensor
it runs the plain version (``F.conv2d`` in f32 on the bf16-rounded
operands). The module counter ``launches`` counts kernel launches: one per
call. The kernel's operands (``Conv1Weights``: the K-major bf16 weight and
the f32 affine) come from ``prepare_conv1``; the entries below prepare them
per call, ``ResNetTrunk`` once per set of weights (``conv1_apply``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from i2vsgg_tpu_torch.utils import cuda_build

launches = 0

_MODE_AFFINE, _MODE_BIAS = 0, 1
_IN_PLANES, _IN_IMAGES = 0, 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_rt(ho: int, wp: int) -> int:
    """Largest multiple of 8 keeping the TPU kernel's im2col scratch under
    ~4.5 MB. Kept because it fixes ``hop`` and so the plane height ``hq``,
    which is part of the host contract."""
    budget = int(4.5e6)
    best = 8
    for rt in range(8, max(ho, 8) + 8, 8):
        if 160 * rt * wp * 2 <= budget:
            best = rt
    return best


class Conv1Geometry(tuple):
    """Static plane/output geometry of an (h, w) image: ho/wo (conv1
    output), wp (padded output width), rt (row band), hop (band-padded
    output rows), hq/wq (per-plane dims)."""
    __slots__ = ()
    ho = property(lambda s: s[0])
    wo = property(lambda s: s[1])
    wp = property(lambda s: s[2])
    rt = property(lambda s: s[3])
    hop = property(lambda s: s[4])
    hq = property(lambda s: s[5])
    wq = property(lambda s: s[6])


def conv1_plane_geometry(h: int, w: int) -> Conv1Geometry:
    ho = (h - 1) // 2 + 1
    wo = (w - 1) // 2 + 1
    wp = max(128, _round_up(wo, 128))
    rt = _pick_rt(ho, wp)
    hop = _round_up(ho, rt)
    hq = _round_up(hop + 8, 8)
    wq = max(128, _round_up(wo + 4, 128))
    return Conv1Geometry((ho, wo, wp, rt, hop, hq, wq))


def _pack(x: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = x.shape
    g = conv1_plane_geometry(h, w)
    xp = torch.zeros((b, 2 * g.hq, 2 * g.wq, 3), dtype=torch.bfloat16,
                     device=x.device)
    xp[:, 3:3 + h, 3:3 + w] = x.to(torch.bfloat16)    # round half to even
    planes = xp.reshape(b, g.hq, 2, g.wq, 2, 3)
    return planes.permute(0, 2, 4, 5, 1, 3).contiguous()


def pack_conv1_planes(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, 2, 2, 3, Hq, Wq) bf16 parity planes on
    the images' device (pad 3 top/left baked in)."""
    return _pack(torch.as_tensor(x))


def pack_conv1_planes_np(x: np.ndarray) -> torch.Tensor:
    """The host packer: (B, H, W, 3) numpy images -> bf16 parity planes as
    a CPU tensor, byte-identical to the JAX package's
    ``pack_conv1_planes_np`` (f32 -> bf16 rounds half to even in both)."""
    return _pack(torch.from_numpy(np.ascontiguousarray(x, np.float32)))


class Conv1Planes:
    """Pre-packed conv1 parity planes standing in for an NHWC image batch.

    Carries the planes plus the source image (h, w); ``shape`` is
    (B, H, W, 3), so callers that read only the batch and image dims need
    no change. ``ResNetTrunk`` dispatches on this type.
    """

    def __init__(self, planes: torch.Tensor, h: int, w: int):
        self.planes = planes
        self.h = int(h)
        self.w = int(w)

    @classmethod
    def pack(cls, x) -> "Conv1Planes":
        b, h, w, _ = x.shape
        if isinstance(x, np.ndarray):
            return cls(pack_conv1_planes_np(x), h, w)
        return cls(pack_conv1_planes(x), h, w)

    @property
    def shape(self):
        return (self.planes.shape[0], self.h, self.w, 3)

    def to(self, device) -> "Conv1Planes":
        """The planes on ``device``, still bf16 (no f32 detour)."""
        return Conv1Planes(self.planes.to(device=device,
                                          dtype=torch.bfloat16), self.h,
                           self.w)


def unpack_conv1_planes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse layout of the packer: (B, 2, 2, 3, Hq, Wq) -> the padded
    NHWC image (B, 2Hq, 2Wq, 3) (the image at [3:3+H, 3:3+W], zeros
    elsewhere)."""
    b, _, _, _, hq, wq = planes.shape
    return planes.permute(0, 4, 1, 5, 2, 3).reshape(b, 2 * hq, 2 * wq, 3)


# ----------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)


def _conv_padded(xp: torch.Tensor, wb: torch.Tensor, ho: int, wo: int):
    """7x7/2 conv of an already padded NHWC bf16 image in f32 -> NCHW f32
    (B, 64, ho, wo)."""
    x = xp[:, :2 * ho + 5, :2 * wo + 5].permute(0, 3, 1, 2).float()
    return F.conv2d(x, wb.float(), stride=2)


def _conv_plain(x, weight, mul, add, planes_hw=None):
    """conv1 + affine (``add`` alone when ``mul`` is None) + ReLU in f32,
    rounded to bf16, NCHW."""
    if planes_hw is None:
        b, h, w, _ = x.shape
        xp = F.pad(x.to(torch.bfloat16), (0, 0, 3, 3, 3, 3))
    else:
        h, w = planes_hw
        xp = unpack_conv1_planes(x)
    g = conv1_plane_geometry(h, w)
    y = _conv_padded(xp, weight.to(torch.bfloat16), g.ho, g.wo)
    if mul is not None:
        y = y * mul.float()[:, None, None]
    y = y + add.float()[:, None, None]
    return F.relu(y).to(torch.bfloat16)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def conv1_bn_relu_plain(x, weight, mul, add):
    """Plain conv1 + BN + ReLU on (B, H, W, 3) images -> (B, Ho, Wo, 64)
    bf16 (``mul`` None: the epilogue adds ``add`` only)."""
    return _nhwc(_conv_plain(x, weight, mul, add))


def conv1_bn_relu_planes_plain(planes, h, w, weight, mul, add):
    return _nhwc(_conv_plain(planes, weight, mul, add, (h, w)))


def conv1_stem_plain(x, weight, mul, add):
    """conv1 + BN + ReLU + caffe ceil-mode 3x3/2 maxpool -> (B, Hp, Wp, 64)
    bf16."""
    from i2vsgg_tpu_torch.models.backbones import caffe_maxpool
    return _nhwc(caffe_maxpool(_conv_plain(x, weight, mul, add)))


def conv1_stem_planes_plain(planes, h, w, weight, mul, add):
    from i2vsgg_tpu_torch.models.backbones import caffe_maxpool
    return _nhwc(caffe_maxpool(_conv_plain(planes, weight, mul, add,
                                           (h, w))))


def fold_v2_weight(weight, mul):
    """The v2 mode's weights: ``bf16(w * mul)``, folded in f32 before the
    cast (``conv1_v2_kernel.py::_pack_weights``)."""
    return (weight.float() * mul.float()[:, None, None, None]).to(
        torch.bfloat16)


def conv1_bn_relu_v2_plain(x, weight, mul, add):
    return conv1_bn_relu_plain(x, fold_v2_weight(weight, mul), None, add)


# ----------------------------------------------------------------------------
# kernel launches


def _check(x, weight, mul, add, planes_hw):
    if planes_hw is None:
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"images must be (B, H, W, 3), got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"images must be float32, got {x.dtype}")
    else:
        g = conv1_plane_geometry(*planes_hw)
        if x.dim() != 6 or tuple(x.shape[1:]) != (2, 2, 3, g.hq, g.wq):
            raise ValueError(f"planes {tuple(x.shape)} do not match the "
                             f"geometry of a {planes_hw} image: (B, 2, 2, 3, "
                             f"{g.hq}, {g.wq})")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"planes must be bfloat16, got {x.dtype}")
    if tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"weight must be (64, 3, 7, 7), got "
                         f"{tuple(weight.shape)}")
    for name, v in (("mul", mul), ("add", add)):
        if v is not None and tuple(v.shape) != (64,):
            raise ValueError(f"{name} must be (64,), got {tuple(v.shape)}")
    for t in (weight, mul, add):
        if t is not None and t.device != x.device:
            raise ValueError("inputs and parameters must be on one device")
    if not x.is_contiguous():
        raise ValueError("the conv1 input must be contiguous")


def _lib():
    lib = cuda_build.load("conv1.cu")
    lib.i2vsgg_conv1_forward.restype = ctypes.c_int
    lib.i2vsgg_conv1_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.i2vsgg_conv1_smem_bytes.restype = ctypes.c_int
    lib.i2vsgg_conv1_smem_bytes.argtypes = [ctypes.c_int]
    return lib


class Conv1Weights(NamedTuple):
    """conv1's weights prepared for the kernel, once per set of weights
    (``prepare_conv1``): ``w_k`` (64, 208) bf16 K-major (K = tap * 4 + c,
    tap = dr * 7 + dc, 49 taps padded to 52, c < 3, zeros elsewhere) and
    the f32 epilogue ``mul`` (None in the v2 mode) and ``add``; ``weight``
    (64, 3, 7, 7) bf16 is what the plain version convolves with (the folded
    ``bf16(w * mul)`` in the v2 mode)."""
    w_k: torch.Tensor
    weight: torch.Tensor
    mul: torch.Tensor | None
    add: torch.Tensor


def prepare_conv1(weight, mul, add, v2: bool = False) -> Conv1Weights:
    """The kernel's operands from ``conv1.weight`` (64, 3, 7, 7) and the
    FrozenBN affine (``mul`` None: the epilogue adds ``add`` only);
    ``v2``: the B5 mode, the scale folded into the bf16
    weights (``fold_v2_weight``) and the epilogue adding ``add`` only."""
    if tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"weight must be (64, 3, 7, 7), got "
                         f"{tuple(weight.shape)}")
    for name, v in (("mul", mul), ("add", add)):
        if v is not None and tuple(v.shape) != (64,):
            raise ValueError(f"{name} must be (64,), got {tuple(v.shape)}")
    if v2:
        weight, mul = fold_v2_weight(weight, mul), None
    wb = weight.detach().to(torch.bfloat16)
    w_k = F.pad(wb.permute(0, 2, 3, 1).reshape(64, 49, 3), (0, 1, 0, 3))
    return Conv1Weights(
        w_k.reshape(64, 208).contiguous(), wb,
        None if mul is None else mul.detach().float().contiguous(),
        add.detach().float().contiguous())


def _raise_on(err: int):
    if err != 0:
        raise RuntimeError(f"conv1 kernel launch failed: cudaError {err}")


def _launch(x, prep: Conv1Weights, planes_hw, stem: bool):
    """One launch: conv + affine + ReLU, with the stem's pool when
    ``stem`` -> (B, Ho, Wo, 64) or (B, Hp, Wp, 64) bf16 NHWC."""
    global launches
    lib = _lib()
    if planes_hw is None:
        b, h, w, _ = x.shape
        src, hq, wq = _IN_IMAGES, 0, 0
    else:
        b = x.shape[0]
        h, w = planes_hw
        src, hq, wq = _IN_PLANES, x.shape[4], x.shape[5]
    g = conv1_plane_geometry(h, w)
    oh, ow = g.ho, g.wo
    if stem:
        if g.ho < 2 or g.wo < 2:
            raise ValueError(f"a {h}x{w} image is too small for the stem's "
                             "3x3/2 pool")
        oh, ow = (g.ho - 2) // 2 + 1, (g.wo - 2) // 2 + 1
    mode = _MODE_AFFINE if prep.mul is not None else _MODE_BIAS
    mul = prep.mul if prep.mul is not None else prep.add
    out = torch.empty((b, oh, ow, 64), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.i2vsgg_conv1_forward(
            x.data_ptr(), prep.w_k.data_ptr(), mul.data_ptr(),
            prep.add.data_ptr(), out.data_ptr(), src, mode, int(stem), b, h,
            w, hq, wq, stream)
    _raise_on(err)
    launches += 1
    return out


def conv1_apply(x, prep: Conv1Weights, planes_hw=None, stem: bool = False):
    """conv1 + BN + ReLU (+ the stem's pool when ``stem``) with prepared
    weights, on (B, H, W, 3) f32 images (``planes_hw`` None) or on parity
    planes of a ``planes_hw`` image: one kernel launch on a CUDA tensor,
    the plain version on a CPU one."""
    _check(x, prep.weight, prep.mul, prep.add, planes_hw)
    if x.device.type == "cuda":
        if prep.w_k.device != x.device:
            raise ValueError("inputs and parameters must be on one device")
        return _launch(x, prep, planes_hw, stem)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    if planes_hw is None:
        fn = conv1_stem_plain if stem else conv1_bn_relu_plain
        return fn(x, prep.weight, prep.mul, prep.add)
    fn = conv1_stem_planes_plain if stem else conv1_bn_relu_planes_plain
    return fn(x, *planes_hw, prep.weight, prep.mul, prep.add)


def conv1_bn_relu(x, weight, mul, add):
    """conv1 + BN + ReLU on (B, H, W, 3) f32 images -> (B, Ho, Wo, 64)
    bf16 (``conv1_bn_relu_pallas``)."""
    return conv1_apply(x, prepare_conv1(weight, mul, add))


def conv1_bn_relu_planes(planes, h: int, w: int, weight, mul, add):
    """The same on parity planes of an (h, w) image
    (``conv1_bn_relu_pallas_planes``)."""
    return conv1_apply(planes, prepare_conv1(weight, mul, add), (h, w))


def conv1_stem(x, weight, mul, add):
    """conv1 + BN + ReLU + the caffe ceil-mode 3x3/2 maxpool on images ->
    (B, Hp, Wp, 64) bf16 (``conv1_stem_pallas``)."""
    return conv1_apply(x, prepare_conv1(weight, mul, add), stem=True)


def conv1_stem_planes(planes, h: int, w: int, weight, mul, add):
    """The stem on parity planes (``conv1_stem_pallas_planes``)."""
    return conv1_apply(planes, prepare_conv1(weight, mul, add), (h, w),
                       stem=True)


def conv1_bn_relu_v2(x, weight, mul, add):
    """The v2 mode (``conv1_bn_relu_pallas_v2``): weights ``bf16(w * mul)``
    folded in f32, epilogue ``max(y + add, 0)``, on images."""
    return conv1_apply(x, prepare_conv1(weight, mul, add, v2=True))
