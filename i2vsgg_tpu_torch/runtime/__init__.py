"""The port's native batch loader: ``csrc/io_runtime.cc`` linked with the
JPEG decoder ``csrc/jpeg.cc``, built with the host compiler at first use
(``utils/cuda_build.py::build_host``, into the gitignored ``_build/``) and
called through ``ctypes.CDLL``, which releases the GIL for each call.

The counterpart of the JAX package's ``runtime`` with its signatures and
return types: ``load_batch`` decodes, mean-subtracts, resizes and pads a
batch of PNG and JPEG files on a thread pool, bit-equal to the JAX
runtime's batches (``preprocess_plain`` is the plain numpy version of its
arithmetic); ``pack_planes`` packs f32 images into conv1 parity planes;
``decode_image`` decodes one file. Deviations, each held by
tests/test_torch_runtime.py:

* PNG is decoded by the runtime's own inflate and row filters (the card's
  machine has no libpng or zlib headers), at every bit depth and Adam7 as
  libpng's transforms leave it; JPEG by ``csrc/jpeg.cc`` (sequential and
  progressive, Huffman- and arithmetic-coded; CMYK and YCCK, which the JAX
  runtime's libjpeg cannot give as RGB, converted as cv2 converts them;
  lossless as cv2 reads it, which the JAX runtime's libjpeg-turbo 2.1 does
  not read). What that decoder refuses (hierarchical, lossless arithmetic,
  12-bit, and the lossless files cv2 refuses) raises
  ``UnsupportedImageError``. Where a progressive file's scan script
  stops short, ``csrc/jpeg.cc`` smooths the blocks as cv2's libjpeg-turbo
  3.1 does, which departs from the JAX runtime's 2.1 by a few grey levels
  (ROADMAP C). A JPEG's EXIF orientation is not applied, as libjpeg does
  not apply it in the JAX runtime (``data/image_io.py::imread_bgr``
  applies it, as cv2 does).
* A failed image raises with its path and the decoder's reason:
  ``FileNotFoundError``, ``UnsupportedImageError`` or ``ValueError`` (JAX
  raises a bare ``RuntimeError`` with a count).
* A failed build raises with the compiler's output; nothing falls back.
  ``I2VSGG_NATIVE_IO=0`` (``wanted``) or ``native=False`` at the call site
  is the only way to the Python path.

The library also holds the JPEG decoder, which ``data/jpeg.py`` calls: the
port builds one host library.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from i2vsgg_tpu_torch.data.jpeg import UnsupportedImageError
from i2vsgg_tpu_torch.utils import cuda_build

SOURCES = ("io_runtime.cc", "jpeg.cc")
ERR_LEN = 256
_ERRORS = {1: FileNotFoundError, 2: UnsupportedImageError, 3: ValueError,
           4: ValueError, 5: OSError}

_lock = threading.Lock()
_lib = None

_f32_p = ctypes.POINTER(ctypes.c_float)
_i32_p = ctypes.POINTER(ctypes.c_int32)


def wanted(native: Optional[bool] = None) -> bool:
    """Whether a caller takes the runtime: ``native`` where given, else
    ``I2VSGG_NATIVE_IO`` (on unless "0")."""
    if native is None:
        return os.environ.get("I2VSGG_NATIVE_IO", "1") != "0"
    return bool(native)


def library() -> ctypes.CDLL:
    """The port's host library, built on first use and typed once; a
    failed build raises ``RuntimeError`` with the compiler's output."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load(SOURCES)
            c_int, size_t = ctypes.c_int, ctypes.c_size_t
            c_int_p = ctypes.POINTER(c_int)
            u8_p = ctypes.POINTER(ctypes.c_uint8)
            lib.i2v_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),             # paths
                u8_p, c_int, _f32_p,                         # flips, n, means
                c_int, c_int, c_int,                         # target, pad
                _f32_p, _f32_p, _i32_p,                      # images, scales, hw
                c_int, _i32_p, ctypes.c_char_p, c_int]       # threads, errors
            lib.i2v_pack_planes.argtypes = [
                _f32_p, c_int, c_int, c_int, c_int, c_int,
                ctypes.POINTER(ctypes.c_uint16), c_int]
            lib.i2v_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(u8_p), _i32_p,
                ctypes.c_char_p, c_int]
            lib.i2v_free.argtypes = [u8_p]
            lib.i2v_free.restype = None
            lib.i2v_jpeg_info.argtypes = [
                ctypes.c_char_p, size_t, c_int_p, c_int_p, c_int_p,
                ctypes.c_char_p, c_int]
            lib.i2v_jpeg_decode.argtypes = [
                ctypes.c_char_p, size_t, ctypes.c_void_p, size_t,
                ctypes.c_char_p, c_int]
            for fn in (lib.i2v_load_batch, lib.i2v_pack_planes,
                       lib.i2v_decode, lib.i2v_jpeg_info,
                       lib.i2v_jpeg_decode):
                fn.restype = c_int
            _lib = lib
        return _lib


def _error(code: int, path: str, msg: str) -> Exception:
    return _ERRORS.get(code, ValueError)(f"{path}: {msg}")


def load_batch(paths: Sequence[str], flips: Sequence[bool],
               pixel_means: Sequence[float], target_size: int,
               pad_h: int, pad_w: int, n_threads: int = 8
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode, mean-subtract, resize (shortest side to ``target_size``) and
    zero-pad a batch of image files on ``n_threads`` threads, each image
    flipped first where ``flips`` says so.

    Returns (images (N, pad_h, pad_w, 3) float32, scales (N,) float32,
    hw (N, 2) int32: each image's resized size, clamped to the pad). The
    first image that fails raises, naming its path and the reason."""
    n = len(paths)
    if len(flips) != n or n == 0:
        raise ValueError(f"load_batch: {n} paths and {len(flips)} flips")
    if min(target_size, pad_h, pad_w, n_threads) < 1:
        raise ValueError("load_batch: target_size, pad_h, pad_w and "
                         "n_threads must be positive")
    lib = library()
    images = np.zeros((n, pad_h, pad_w, 3), np.float32)
    scales = np.zeros((n,), np.float32)
    hw = np.zeros((n, 2), np.int32)
    codes = np.zeros((n,), np.int32)
    errs = ctypes.create_string_buffer(n * ERR_LEN)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_flips = np.asarray(flips, np.uint8)
    c_means = np.ascontiguousarray(pixel_means, np.float32)
    if c_means.shape != (3,):
        raise ValueError(f"pixel_means of shape {c_means.shape}, not (3,)")
    failed = lib.i2v_load_batch(
        c_paths, c_flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        c_means.ctypes.data_as(_f32_p), target_size, pad_h, pad_w,
        images.ctypes.data_as(_f32_p), scales.ctypes.data_as(_f32_p),
        hw.ctypes.data_as(_i32_p), n_threads, codes.ctypes.data_as(_i32_p),
        errs, ERR_LEN)
    if failed:
        i = int(np.flatnonzero(codes)[0])
        msg = errs.raw[i * ERR_LEN:(i + 1) * ERR_LEN].split(b"\0")[0]
        more = f" ({failed} of {n} images failed)" if failed > 1 else ""
        raise _error(int(codes[i]), str(paths[i]),
                     msg.decode("utf-8", "replace") + more)
    return images, scales, hw


def preprocess_plain(im_bgr: np.ndarray, flip: bool,
                     pixel_means: Sequence[float], target_size: int,
                     pad_h: int, pad_w: int
                     ) -> Tuple[np.ndarray, np.float32, np.ndarray]:
    """The plain numpy version of ``load_batch``'s work on one decoded
    image, which the library is held to bit for bit: the JAX runtime's
    ``preprocess_one`` in f32, operation for operation.

    Its source map is not cv2's (``data/pipeline.py::resize_linear``, the
    Python path): the step is ``w / round(w * scale)`` where cv2 takes
    ``1 / scale``, and the positions are computed in f32 where cv2 uses
    double, so the two paths differ by a fraction of a pixel where
    ``w * scale`` is not whole (the JAX package's two paths as well).
    Returns (the padded (pad_h, pad_w, 3) f32 image, the scale, (rh, rw))."""
    f32 = np.float32
    h, w = im_bgr.shape[:2]
    scale = f32(target_size) / f32(min(h, w))
    # std::lround of a positive f32: half away from zero
    rh = min(int(np.floor(np.float64(f32(h) * scale) + 0.5)), pad_h)
    rw = min(int(np.floor(np.float64(f32(w) * scale) + 0.5)), pad_w)

    def axis(n_src: int, n_dst: int):
        step = f32(n_src) / f32(n_dst)
        src = (np.arange(n_dst, dtype=f32) + f32(0.5)) * step - f32(0.5)
        src = np.maximum(f32(0.0), np.minimum(src, f32(n_src - 1)))
        i0 = src.astype(np.int64)                   # truncation, src >= 0
        return (np.minimum(i0, n_src - 1), np.minimum(i0 + 1, n_src - 1),
                src - i0.astype(f32))

    y0, y1, fy = axis(h, rh)
    x0, x1, fx = axis(w, rw)
    if flip:                                        # the source columns
        x0, x1 = w - 1 - x0, w - 1 - x1
    im = im_bgr.astype(f32)
    fx, fy = fx[None, :, None], fy[:, None, None]
    top = im[y0][:, x0] + (im[y0][:, x1] - im[y0][:, x0]) * fx
    bot = im[y1][:, x0] + (im[y1][:, x1] - im[y1][:, x0]) * fx
    out = np.zeros((pad_h, pad_w, 3), f32)
    out[:rh, :rw] = top + (bot - top) * fy - np.asarray(pixel_means, f32)
    return out, scale, np.array([rh, rw], np.int32)


def pack_planes(x: np.ndarray, hq: int, wq: int,
                n_threads: int = 8) -> torch.Tensor:
    """The conv1 parity-plane packer: (B, H, W, 3) f32 images -> (B, 2, 2,
    3, hq, wq) ``torch.bfloat16`` planes on the CPU, rounded nearest-even
    and zero outside the image, byte-equal to ``ops/conv1.py``'s torch
    packer and to the JAX runtime's."""
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 4 or x.shape[3] != 3:
        raise ValueError(f"pack_planes takes (B, H, W, 3), not {x.shape}")
    b, h, w, _ = x.shape
    lib = library()
    out = torch.empty((b, 2, 2, 3, hq, wq), dtype=torch.bfloat16)
    lib.i2v_pack_planes(                          # writes every element
        x.ctypes.data_as(_f32_p), b, h, w, hq, wq,
        ctypes.cast(out.data_ptr(), ctypes.POINTER(ctypes.c_uint16)),
        max(1, n_threads))
    return out


def decode_image(path: str) -> np.ndarray:
    """Decode one PNG or JPEG file to (H, W, 3) BGR uint8, as
    ``load_batch`` decodes it (no EXIF orientation)."""
    lib = library()
    hw = np.zeros((2,), np.int32)
    err = ctypes.create_string_buffer(ERR_LEN)
    buf = ctypes.POINTER(ctypes.c_uint8)()
    rc = lib.i2v_decode(str(path).encode(), ctypes.byref(buf),
                        hw.ctypes.data_as(_i32_p), err, ERR_LEN)
    if rc:
        raise _error(rc, str(path), err.value.decode("utf-8", "replace"))
    try:
        h, w = int(hw[0]), int(hw[1])
        return np.ctypeslib.as_array(buf, (h, w, 3)).copy()
    finally:
        lib.i2v_free(buf)
