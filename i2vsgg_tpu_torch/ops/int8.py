"""Integer arithmetic of the int8 serving levers — counterpart of the int8
branches of ``i2vsgg_tpu/models/backbones.py::BNConv`` and of
``i2vsgg_tpu/models/sgg.py::DenseInt8`` (copied, never imported).

* weights: symmetric per output channel, ``w_s = max(absmax, 1e-8) / 127``
  and ``w_q = round(w / w_s)`` (half to even, as ``jnp.round``);
* activations: one scale for the whole tensor, either dynamic
  (``max(absmax, 1e-8) / 127``, no clip) or static (a calibrated scale,
  the quotient clipped to +-127); ``DenseInt8`` takes one dynamic scale per
  row;
* products: ``int8_conv2d`` and ``int8_linear`` return the exact int32
  sums.

In JAX the products are XLA ops (``lax.conv_general_dilated`` /
``lax.dot`` on int8 with ``preferred_element_type=int32``), not Pallas
kernels, so on the card they run as an int8 im2col and cuBLASLt's IMMA
GEMM (``torch._int_mm``). ``_int_mm`` wants more than 16 rows and K, N that
are multiples of 8: the wrappers pad with zeros, which adds nothing to any
sum. On a CPU tensor the products are taken in float64 (``F.conv2d`` /
``matmul`` on f64 copies of the taps) and converted: exact, since every
|sum| <= 127**2 * K < 2**31 < 2**53 at the trunk's widths. (An f32 sum is
not exact above 2**24.)

``int8_conv2d.calls`` and ``int8_linear.calls`` count the GEMMs taken on
the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INT8_MAX = 127.0


def scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-8) / 127`` in f32, correctly rounded on every device,
    as JAX divides. (With a Python number as divisor, PyTorch's CUDA kernel
    multiplies by the rounded reciprocal instead, which is one ulp off for
    some values: then neither the card and the CPU nor the port and JAX
    agree on the scale.)"""
    return absmax.clamp_min(1e-8) / torch.full((), INT8_MAX,
                                               device=absmax.device)


def weight_quant(w: torch.Tensor):
    """Per-output-channel (dim 0) symmetric quantization of ``w`` (any float
    dtype; conv OIHW or dense (O, I)) -> (w_q int8 of w's shape, w_s (O,)
    f32)."""
    wf = w.float()
    w_s = scale_of(wf.abs().reshape(wf.shape[0], -1).amax(1))
    w_q = torch.round(wf / w_s.reshape(-1, *([1] * (wf.dim() - 1))))
    return w_q.to(torch.int8), w_s


def dynamic_act_quant(x: torch.Tensor):
    """One dynamic scale for the tensor: (x_q int8, a_s 0-d f32), no
    clip (|x / a_s| <= 127 by construction)."""
    xf = x.float()
    a_s = scale_of(xf.abs().amax())
    return torch.round(xf / a_s).to(torch.int8), a_s


def static_act_quant(x: torch.Tensor, a_s: torch.Tensor) -> torch.Tensor:
    """A calibrated scale: ``clip(round(x / a_s), -127, 127)`` as int8;
    values beyond the calibrated range saturate."""
    q = torch.round(x.float() / a_s).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8)


def row_act_quant(x: torch.Tensor):
    """``DenseInt8``'s activations: one dynamic scale per row of the 2-D
    ``x`` -> (x_q int8, a_s (rows,) f32)."""
    xf = x.float()
    a_s = scale_of(xf.abs().amax(-1))
    return torch.round(xf / a_s[:, None]).to(torch.int8), a_s


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 ^T -> (M, N) int32 with cuBLASLt's IMMA
    GEMM: rows padded to at least 17, K and N to multiples of 8, with
    zeros."""
    m, k = a.shape
    n = w.shape[0]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    mp = max(m, 17)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a.contiguous(), w.contiguous().t())
    return y[:m, :n]


def _check_int8(*ts):
    for t in ts:
        if t.dtype != torch.int8:
            raise TypeError(f"int8 operands expected, got {t.dtype}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("operands must be on one device")


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """Exact int32 convolution of int8 ``x_q`` (N, C, H, W) by int8 ``w_q``
    (F, C, KH, KW), zero padding ``padding``, -> (N, F, Ho, Wo) int32.

    On the card: an int8 im2col of the NHWC view (the KH * KW shifted,
    strided windows concatenated on channels, K order (dr, dc, c)) and one
    ``torch._int_mm``; the result is an NCHW view of NHWC memory."""
    _check_int8(x_q, w_q)
    n, c, h, w = x_q.shape
    f, _, kh, kw = w_q.shape
    if x_q.device.type == "cpu":
        y = F.conv2d(x_q.double(), w_q.double(), stride=stride,
                     padding=padding)
        return y.to(torch.int32)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    xn = x_q.permute(0, 2, 3, 1)
    if padding:
        xn = F.pad(xn, (0, 0, padding, padding, padding, padding))
    cols = [xn[:, dr:dr + stride * (ho - 1) + 1:stride,
               dc:dc + stride * (wo - 1) + 1:stride]
            for dr in range(kh) for dc in range(kw)]
    a = (cols[0] if len(cols) == 1 else torch.cat(cols, dim=3))
    a = a.reshape(n * ho * wo, kh * kw * c)
    wk = w_q.permute(0, 2, 3, 1).reshape(f, kh * kw * c)
    y = _int_mm(a, wk)
    int8_conv2d.calls += 1
    return y.reshape(n, ho, wo, f).permute(0, 3, 1, 2)


def int8_linear(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 ``x_q`` (M, K) and int8 ``w_q`` (N, K)
    (a dense layer's weight): ``x_q @ w_q.T`` -> (M, N) int32."""
    _check_int8(x_q, w_q)
    if x_q.device.type == "cpu":
        return (x_q.double() @ w_q.double().t()).to(torch.int32)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    y = _int_mm(x_q, w_q)
    int8_linear.calls += 1
    return y


int8_conv2d.calls = 0
int8_linear.calls = 0
