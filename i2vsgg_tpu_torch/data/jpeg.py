"""JPEG decode for the port's loader: the decoder of ``csrc/jpeg.cc``,
built with ``g++`` at first use into the port's host library with the batch
loader (``runtime.library``) and called through ``ctypes.CDLL``, which
releases the GIL for the whole call, so the loader's prefetch thread
decodes while the main thread launches kernels.

``decode_jpeg`` returns what ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns
for the files it reads, byte for byte: BGR uint8 (H, W, 3), grey replicated,
and the APP1 EXIF orientation (2-8) applied with numpy flips and transposes,
as cv2 applies it. It reads JPEG with 8-bit samples, Huffman- or
arithmetic-coded (DAC conditioning included), sequential or progressive,
one, three or four components (CMYK, and YCCK converted to CMYK, then to
BGR as OpenCV converts them), any integral chroma sampling, restart
intervals, and colour components in one scan or in several; a progressive
file whose scan script stops short is finished by libjpeg-turbo 3.1's block
smoothing, as cv2 finishes it. It reads lossless JPEG (SOF3) as cv2 reads
it: 8 bits, three components stored as RGB, predictors 1-7, a point
transform, restart intervals of whole rows. Hierarchical files (SOF5-7,
SOF13-15), lossless arithmetic coding (SOF11), 12-bit samples and the
lossless files cv2 refuses (one component, 12 or 16 bits, YCbCr) raise
``UnsupportedImageError`` naming the mode; truncated or corrupt data, and a
scan script libjpeg would only warn of, raise ``ValueError`` (where
libjpeg-turbo would warn and fill with grey). There is no fallback: a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

_UNSUPPORTED = 1                # the decoder's code for a mode it refuses


class UnsupportedImageError(ValueError):
    """An image the port has no decoder for (``data/image_io.py`` raises it
    too)."""


def library() -> ctypes.CDLL:
    """The host library that holds the decoder (``runtime.library``: built
    on first use, its functions typed once)."""
    from i2vsgg_tpu_torch import runtime       # runtime imports this module
    return runtime.library()


def _raise(rc: int, err, path: str):
    msg = err.value.decode("utf-8", "replace")
    if rc == _UNSUPPORTED:
        raise UnsupportedImageError(f"{path}: {msg}")
    raise ValueError(f"{path}: {msg}")


def segments(data: bytes):
    """(marker, payload) of each marker segment of JPEG ``data`` before its
    first scan; it stops at anything that is not a marker."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:                          # fill byte
            pos += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):    # no length field
            pos += 2
            continue
        if marker in (0xD9, 0xDA):
            return
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield marker, data[pos + 4:pos + 2 + length]
        pos += 2 + length


def exif_orientation(data: bytes) -> int:
    """The orientation tag (0x0112) of the first APP1 ``Exif`` segment
    before the first scan, 1 where there is none or it cannot be read (cv2
    then leaves the image as it is)."""
    for marker, body in segments(data):
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return _tiff_orientation(body[6:])
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    try:
        order = {b"II": "<", b"MM": ">"}[tiff[:2]]
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
            tag, kind = struct.unpack(order + "HH", entry[:4])
            if tag == 0x0112 and kind == 3:               # SHORT
                return struct.unpack(order + "H", entry[8:10])[0]
    except (KeyError, struct.error):
        pass
    return 1


def orient(im: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ``ExifTransform``: the decoded rows and columns turned to the
    orientation the tag names (1 and unknown values: unchanged)."""
    if orientation in (5, 6, 7, 8):
        im = im.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        im = im[:, ::-1]
    if orientation in (3, 4, 7, 8):
        im = im[::-1]
    return np.ascontiguousarray(im)


def decode_jpeg(data: bytes, path: str = "<jpeg>") -> np.ndarray:
    """JPEG bytes -> BGR uint8 (H, W, 3), as ``cv2.imread(...,
    IMREAD_COLOR)`` gives it (EXIF orientation applied)."""
    lib = library()
    err = ctypes.create_string_buffer(256)
    h, w, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.i2v_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(nc), err, len(err))
    if rc:
        _raise(rc, err, path)
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.i2v_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                             err, len(err))
    if rc:
        _raise(rc, err, path)
    return orient(out, exif_orientation(data))
