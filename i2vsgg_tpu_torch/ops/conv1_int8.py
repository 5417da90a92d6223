"""ResNet conv1 (7x7, stride 2, pad 3) + FrozenBN affine + ReLU as an int8
implicit GEMM — counterpart of the JAX package's Pallas kernel
``i2vsgg_tpu/ops/pallas/conv1_int8_kernel.py::conv1_bn_relu_int8_pallas``
(B6).

The input is mean-subtracted f32 NHWC images (B, H, W, 3); the output is
(B, Ho, Wo, 64) bf16, conv + BN + ReLU, unpooled, as JAX returns it. The
scheme, copied from the JAX wrapper:

* activations: ``clip(round(x + (mean - 128)), -128, 127)``, which is
  ``raw - 128`` exactly for integer pixels; the pad constant is
  ``round(mean) - 128``;
* weights: int8 per output channel over the 147 taps, K order
  ``(dr * 7 + dc) * 3 + ch``, padded to 160 with zeros;
* ``K_o = sum_{tap, ch} w_q w_s (mean_ch - 128)``, scale ``s = w_s * mul``
  and bias ``b = add - K_o * mul``;
* an int32 accumulate, then ``max(y * s + b, 0)`` in f32 (a multiply, then
  an add, each rounded) and a bf16 output.

``conv1_int8_params`` computes ``w_q``, ``s`` and ``b`` once, in the JAX
op order, for both the kernel and the plain version;
``conv1_bn_relu_int8`` is that followed by ``conv1_int8_apply``, which on a
CUDA tensor launches the hand-written kernel of ``csrc/conv1_int8.cu`` (or
raises) and on a CPU tensor runs the plain version: the exact integer
product of ``ops/int8.py`` plus the same epilogue in torch ops.
``launches`` counts the kernel's launches.

In JAX this kernel is test-only (the trunk never dispatches it), and so it
is here: the trunk's conv1 stays cuDNN's or ``ops/conv1.py``'s.
"""

from __future__ import annotations

import ctypes

import torch

from i2vsgg_tpu_torch.ops.int8 import int8_conv2d, scale_of
from i2vsgg_tpu_torch.utils import cuda_build

# caffe-convention BGR pixel means (``config.PIXEL_MEANS``)
DEFAULT_PIXEL_MEANS = (102.9801, 115.9465, 122.7717)
K_TAPS, K_PAD = 147, 160

launches = 0


def conv1_int8_params(weight, mul, add, pixel_means=DEFAULT_PIXEL_MEANS):
    """The kernel's parameters from the port's ``conv1.weight`` (64, 3, 7, 7)
    (any float dtype) and the FrozenBN ``mul``/``add`` (64,):
    ``(w_q (64, 160) int8, s (64,) f32, b (64,) f32)`` on the weight's
    device and ``(shift (3,) f32, pad (3,) f32)`` on the CPU, where ``shift
    = mean - 128`` is added to each pixel before rounding and ``pad =
    round(mean) - 128`` fills the halo. The op order is the JAX wrapper's
    (``conv1_int8_kernel.py:115-143``)."""
    dev = weight.device
    means = torch.tensor(pixel_means, dtype=torch.float32)
    shift, pad = means - 128.0, torch.round(means) - 128.0
    # (O, KH, KW, I): the K index (dr * 7 + dc) * 3 + ch
    wf = weight.float().permute(0, 2, 3, 1).reshape(64, K_TAPS)
    w_s = scale_of(wf.abs().amax(1))
    w_q = torch.round(wf / w_s[:, None])
    kvec = (w_q * w_s[:, None]).reshape(64, 49, 3) @ shift.to(dev)
    k_o = kvec.sum(1)
    mul_f = mul.float()
    s = w_s * mul_f
    b = add.float() - k_o * mul_f
    w2 = torch.zeros((64, K_PAD), dtype=torch.int8, device=dev)
    w2[:, :K_TAPS] = w_q.to(torch.int8)
    return w2, s, b, shift, pad


def quantize_images(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``clip(round(x + shift), -128, 127)`` as int8, (B, H, W, 3)."""
    q = torch.round(x + shift.to(x.device)).clamp(-128.0, 127.0)
    return q.to(torch.int8)


def conv1_bn_relu_int8_plain(x, w_q, s, b, shift, pad) -> torch.Tensor:
    """The plain version on the parameters of ``conv1_int8_params``: the
    int8 activations with the pad constant as halo, the exact int32
    product (``ops/int8.py::int8_conv2d``), then ``max(y * s + b, 0)`` in
    f32 -> (B, Ho, Wo, 64) bf16."""
    bsz, h, w, _ = x.shape
    xq = quantize_images(x, shift)
    xp = pad.to(device=x.device, dtype=torch.int8).expand(
        bsz, h + 6, w + 6, 3).clone()
    xp[:, 3:3 + h, 3:3 + w] = xq
    w4 = w_q[:, :K_TAPS].reshape(64, 7, 7, 3).permute(0, 3, 1, 2)
    y = int8_conv2d(xp.permute(0, 3, 1, 2), w4, stride=2)
    out = torch.clamp_min(y.float() * s[:, None, None] + b[:, None, None], 0)
    return out.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _lib():
    lib = cuda_build.load("conv1_int8.cu")
    fn = lib.i2vsgg_conv1_int8_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 2)
    return lib


def _check(x, weight, mul, add):
    if tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"weight must be (64, 3, 7, 7), got "
                         f"{tuple(weight.shape)}")
    for name, v in (("mul", mul), ("add", add)):
        if tuple(v.shape) != (64,):
            raise ValueError(f"{name} must be (64,), got {tuple(v.shape)}")
    for t in (weight, mul, add):
        if t.device != x.device:
            raise ValueError("inputs and parameters must be on one device")


def _check_apply(x, w_q, s, b):
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"images must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the images must be contiguous")
    if (w_q.dtype, tuple(w_q.shape)) != (torch.int8, (64, K_PAD)) or \
            not all(t.device == x.device and t.is_contiguous()
                    for t in (w_q, s, b)):
        raise ValueError("w_q (64, 160) int8, s and b must be contiguous "
                         "and on the images' device")


def _launch(x, w_q, s, b, shift, pad):
    global launches
    bsz, h, w, _ = x.shape
    out = torch.empty((bsz, (h - 1) // 2 + 1, (w - 1) // 2 + 1, 64),
                      dtype=torch.bfloat16, device=x.device)
    sh, pd = shift.tolist(), pad.tolist()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().i2vsgg_conv1_int8_forward(
            x.data_ptr(), w_q.data_ptr(), s.data_ptr(), b.data_ptr(), bsz, h,
            w, *sh, *pd, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"conv1_int8 kernel launch failed: cudaError {err}")
    launches += 1
    return out


def conv1_int8_apply(x, w_q, s, b, shift, pad) -> torch.Tensor:
    """The kernel (CUDA images) or the plain version (CPU images) on the
    parameters of ``conv1_int8_params``."""
    _check_apply(x, w_q, s, b)
    if x.device.type == "cuda":
        return _launch(x, w_q, s, b, shift, pad)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return conv1_bn_relu_int8_plain(x, w_q, s, b, shift, pad)


def conv1_bn_relu_int8(x, weight, mul, add,
                       pixel_means=DEFAULT_PIXEL_MEANS) -> torch.Tensor:
    """conv1 + BN + ReLU in int8 on (B, H, W, 3) mean-subtracted f32 images
    -> (B, Ho, Wo, 64) bf16 (``conv1_bn_relu_int8_pallas``)."""
    _check(x, weight, mul, add)
    return conv1_int8_apply(x, *conv1_int8_params(weight, mul, add,
                                                  pixel_means))
