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

On a CUDA tensor every entry launches the hand-written kernels of
``csrc/conv1.cu`` (or raises); on a CPU tensor it runs the plain version
(``F.conv2d`` in f32 on the bf16-rounded operands). The module counter
``launches`` counts kernel launches: one per conv, plus one for the stem's
pool pass.
"""

from __future__ import annotations

import ctypes

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
    for name in ("i2vsgg_conv1_forward", "i2vsgg_stem_pool_forward"):
        getattr(lib, name).restype = ctypes.c_int
    lib.i2vsgg_conv1_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.i2vsgg_stem_pool_forward.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"conv1 {what} kernel launch failed: "
                           f"cudaError {err}")


def _launch_conv(x, wb, mul, add, planes_hw):
    """One launch of the conv kernel -> (B, Ho, Wo, 64) bf16 NHWC."""
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
    # (7, 7, 3, 64): the K index (dr * 7 + dc) * 3 + c, 64 outputs minor
    w_k = wb.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()
    mode = _MODE_AFFINE if mul is not None else _MODE_BIAS
    mul_f = (mul if mul is not None else add).float().contiguous()
    add_f = add.float().contiguous()
    out = torch.empty((b, g.ho, g.wo, 64), dtype=torch.bfloat16,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.i2vsgg_conv1_forward(
            x.data_ptr(), w_k.data_ptr(), mul_f.data_ptr(), add_f.data_ptr(),
            out.data_ptr(), src, mode, b, h, w, hq, wq, stream)
    _raise_on(err, "conv")
    launches += 1
    return out


def _launch_pool(y):
    global launches
    lib = _lib()
    b, ho, wo, c = y.shape
    out = torch.empty((b, (ho - 2) // 2 + 1, (wo - 2) // 2 + 1, c),
                      dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.i2vsgg_stem_pool_forward(y.data_ptr(), out.data_ptr(), b,
                                           ho, wo, c, stream)
    _raise_on(err, "stem pool")
    launches += 1
    return out


def _dispatch(x, weight, mul, add, planes_hw, stem, plain):
    _check(x, weight, mul, add, planes_hw)
    if x.device.type == "cuda":
        y = _launch_conv(x, weight, mul, add, planes_hw)
        return _launch_pool(y) if stem else y
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return plain()


def conv1_bn_relu(x, weight, mul, add):
    """conv1 + BN + ReLU on (B, H, W, 3) f32 images -> (B, Ho, Wo, 64)
    bf16 (``conv1_bn_relu_pallas``)."""
    return _dispatch(x, weight, mul, add, None, False,
                     lambda: conv1_bn_relu_plain(x, weight, mul, add))


def conv1_bn_relu_planes(planes, h: int, w: int, weight, mul, add):
    """The same on parity planes of an (h, w) image
    (``conv1_bn_relu_pallas_planes``)."""
    return _dispatch(planes, weight, mul, add, (h, w), False,
                     lambda: conv1_bn_relu_planes_plain(planes, h, w, weight,
                                                        mul, add))


def conv1_stem(x, weight, mul, add):
    """conv1 + BN + ReLU + the caffe ceil-mode 3x3/2 maxpool on images ->
    (B, Hp, Wp, 64) bf16 (``conv1_stem_pallas``)."""
    return _dispatch(x, weight, mul, add, None, True,
                     lambda: conv1_stem_plain(x, weight, mul, add))


def conv1_stem_planes(planes, h: int, w: int, weight, mul, add):
    """The stem on parity planes (``conv1_stem_pallas_planes``)."""
    return _dispatch(planes, weight, mul, add, (h, w), True,
                     lambda: conv1_stem_planes_plain(planes, h, w, weight,
                                                     mul, add))


def conv1_bn_relu_v2(x, weight, mul, add):
    """The v2 mode (``conv1_bn_relu_pallas_v2``): weights ``bf16(w * mul)``
    folded in f32, epilogue ``max(y + add, 0)``, on images."""
    wf = fold_v2_weight(weight, mul)
    return _dispatch(x, wf, None, add, None, False,
                     lambda: conv1_bn_relu_plain(x, wf, None, add))
