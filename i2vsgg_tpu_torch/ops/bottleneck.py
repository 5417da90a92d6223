"""A chain of ResNet identity bottlenecks with FrozenBN folded into the
weights — counterpart of ``i2vsgg_tpu/ops/pallas/bottleneck_kernel.py``
(B4), copied, never imported (that module imports JAX).

Each of the ``n`` blocks computes, with the folded bf16 kernels W1 (C, M),
W3 (9, M, M) (tap index dy*3+dx) and W2 (M, C) and f32 biases:

    a = bf16(relu(x @ W1 + b1))
    b = bf16(relu(conv3x3_zero_pad(a) @ W3 + b3))
    x = bf16(relu(x + (b @ W2 + b2)))

with products and sums in f32 (the TPU kernel's rounding points).
``bottleneck_chain_plain`` is that arithmetic in plain PyTorch;
``bottleneck_chain`` is the op the trunk calls: a CUDA map goes to the
hand-written kernel ``csrc/bottleneck.cu`` (wgmma on TMA-staged tiles; or
the call raises), a CPU one to the plain version.
``bottleneck_chain.launches`` counts the kernel launches (three per block:
the 1x1 down, the 3x3, the 1x1 up).

``chain_geometry`` and ``chain_vmem_bytes`` are the TPU kernel's own sizes,
integer for integer: the trunk's fit gate reads them, so the port fuses a
stage exactly where the JAX package does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from i2vsgg_tpu_torch.utils import cuda_build


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def chain_geometry(h: int, w: int):
    """(HP, WW, WQ): padded rows, conv window width, buffer width of the TPU
    kernel's on-chip map."""
    ww = _round_up(w + 1, 16)
    wq = ww + 16
    hp = h + 2
    return hp, ww, wq


def chain_vmem_bytes(h: int, w: int, c: int, m: int) -> int:
    """The TPU kernel's on-chip footprint estimate (fmap + mid +
    double-buffered weights + band temporaries), as its fit gate reads it."""
    hp, ww, wq = chain_geometry(h, w)
    fmap = hp * wq * c * 2
    mid = hp * wq * m * 2
    weights = 2 * 2 * (c * m + 9 * m * m + m * c)
    temps = 4 * (8 * wq * m + 8 * ww * m + 4 * ww * c)
    return fmap + mid + weights + temps


def fold_block_params(w1, bn1, w3, bn2, w2, bn3):
    """Fold FrozenBN affines into one block's conv kernels.

    w1: (M, C, 1, 1) conv1 (1x1 down), w3: (M, M, 3, 3) conv2,
    w2: (C, M, 1, 1) conv3 (1x1 up), in the port's OIHW layout and their
    stored dtype; bn1/bn2/bn3: f32 ``(mul, add)`` pairs
    (``FrozenBatchNorm.affine``). Returns (w1' (C, M), b1, w3' (9, M, M), b3,
    w2' (M, C), b2) in f32: each stored kernel promoted to f32 and multiplied
    by the f32 ``mul`` (JAX's promotion of a bf16 or f32 kernel times an f32
    vector); the chain rounds the products to bf16.
    """
    f32 = torch.float32
    (m1, a1), (m2, a2), (m3, a3) = bn1, bn2, bn3
    w1f = w1[:, :, 0, 0].t().to(f32) * m1.to(f32)[None, :]
    w3f = (w3.permute(2, 3, 1, 0).to(f32) * m2.to(f32)).reshape(
        9, w3.shape[1], w3.shape[0])
    w2f = w2[:, :, 0, 0].t().to(f32) * m3.to(f32)[None, :]
    return w1f, a1, w3f, a2, w2f, a3


def bottleneck_chain_plain(x, w1, b1, w3, b3, w2, b2, acc=torch.float32):
    """The chain in plain PyTorch, at the kernel's rounding points.

    x: (B, H, W, C) NHWC (any float dtype; rounded to bf16 first);
    w1 (n, C, M), b1 (n, M), w3 (n, 9, M, M), b3 (n, M), w2 (n, M, C),
    b2 (n, C): weights rounded to bf16, biases taken in ``acc``. Every
    product and sum is in ``acc``: f32 as in the kernel (bf16 values held in
    f32, so each product is exact), or f64 for a reference that only the
    roundings to bf16 separate from exact arithmetic. Returns
    (B, H, W, C) bf16.
    """
    bf16 = torch.bfloat16
    bsz, h, w, c = x.shape
    n, _, m = w1.shape
    x = x.to(bf16).reshape(-1, c)
    for i in range(n):
        xf = x.to(acc)
        a = F.relu(xf @ w1[i].to(bf16).to(acc) + b1[i].to(acc)).to(bf16)
        # the 3x3 as one GEMM over the 9 shifted windows of the zero-padded
        # map (tap-major K, as w3 is laid out): a plain matmul, where a
        # convolution library may pick a transform-domain algorithm whose
        # f32 error is larger
        ap = F.pad(a.to(acc).reshape(bsz, h, w, m), (0, 0, 1, 1, 1, 1))
        cols = torch.cat([ap[:, dy:dy + h, dx:dx + w]
                          for dy in range(3) for dx in range(3)], dim=-1)
        mid = cols.reshape(-1, 9 * m) @ w3[i].to(bf16).to(acc).reshape(
            9 * m, m)
        bmid = F.relu(mid + b3[i].to(acc)).to(bf16)
        y = bmid.to(acc) @ w2[i].to(bf16).to(acc) + b2[i].to(acc)
        x = F.relu(xf + y).to(bf16)
    return x.reshape(bsz, h, w, c)


def _check(x, w1, b1, w3, b3, w2, b2):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if w1.dim() != 3 or w1.shape[1] != c:
        raise ValueError(f"w1 must be (n, {c}, M), got {tuple(w1.shape)}")
    n, _, m = w1.shape
    if c % 128 or m % 128:
        raise ValueError(f"C {c} and M {m} must be multiples of 128")
    want = {"b1": (n, m), "w3": (n, 9, m, m), "b3": (n, m),
            "w2": (n, m, c), "b2": (n, c)}
    for name, t in (("b1", b1), ("w3", w3), ("b3", b3), ("w2", w2),
                    ("b2", b2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    for name, t, dt in (("x", x, torch.bfloat16), ("w1", w1, torch.bfloat16),
                        ("w3", w3, torch.bfloat16),
                        ("w2", w2, torch.bfloat16), ("b1", b1, torch.float32),
                        ("b3", b3, torch.float32), ("b2", b2, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x and the chain's weights must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = cuda_build.load("bottleneck.cu")
    fn = lib.i2vsgg_bottleneck_chain_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.i2vsgg_bottleneck_smem_bytes.restype = ctypes.c_int
    lib.i2vsgg_bottleneck_smem_bytes.argtypes = []
    return lib


def _launch(x, w1, b1, w3, b3, w2, b2):
    fn = _lib().i2vsgg_bottleneck_chain_forward
    bsz, h, w, c = x.shape
    n, _, m = w1.shape
    out = x.clone()                       # the chain runs in place on it
    if n == 0 or x.numel() == 0:
        return out
    # the 1x1-down output with a zero one-pixel halo (the 3x3's padding):
    # each block writes the interior only, so the halo stays zero
    apad = torch.zeros((bsz, h + 2, w + 2, m), dtype=torch.bfloat16,
                       device=x.device)
    bmid = torch.empty((bsz * h * w, m), dtype=torch.bfloat16,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(out.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 w3.data_ptr(), b3.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 apad.data_ptr(), bmid.data_ptr(), bsz, h, w, c, m, n,
                 stream)
    if err != 0:
        raise RuntimeError(f"bottleneck chain kernel launch failed: "
                           f"cudaError {err}")
    bottleneck_chain.launches += 3 * n
    return out


def bottleneck_chain(x, w1, b1, w3, b3, w2, b2):
    """Run ``n`` identity bottlenecks over ``x`` (contract of
    ``bottleneck_chain_plain``, with the types fixed): x (B, H, W, C) bf16
    NHWC, the folded kernels bf16, the biases f32, all contiguous, C and M
    multiples of 128.

    A CUDA map goes to the kernel (three launches a block, counted in
    ``bottleneck_chain.launches``); a CPU one to the plain version.
    """
    _check(x, w1, b1, w3, b3, w2, b2)
    if x.device.type == "cuda":
        return _launch(x, w1, b1, w3, b3, w2, b2)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return bottleneck_chain_plain(x, w1, b1, w3, b3, w2, b2)


bottleneck_chain.launches = 0
