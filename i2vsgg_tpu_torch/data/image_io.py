"""Image decode for the port's loader: PNG with the standard library and
numpy, JPEG with the port's own decoder (``data/jpeg.py``).

The card's machine has no cv2, PIL or libjpeg/libpng headers, so the port
decodes both formats itself. PNG: ``zlib`` inflates the IDAT stream and numpy
undoes the row filters. JPEG: ``csrc/jpeg.cc``, built with ``g++`` at first
use and called through ctypes. ``imread_bgr`` returns what
``cv2.imread(path, cv2.IMREAD_COLOR)`` returns for the files it reads, byte
for byte: BGR uint8 (H, W, 3), grey replicated, palettes expanded, alpha
dropped, a JPEG's EXIF orientation applied.

Read: PNG of every colour type at every bit depth the specification defines
(grey 1, 2, 4, 8, 16; palette 1, 2, 4, 8; RGB, grey + alpha and RGBA 8,
16), non-interlaced or Adam7-interlaced, with any of the five row filters,
as the JAX runtime's libpng transforms leave it (16 bits cut to the high
byte, grey below 8 bits scaled to 0-255, alpha and tRNS dropped); and
JPEG with 8-bit samples, Huffman- or arithmetic-coded, sequential or
progressive, grey, three or four components (CMYK, YCCK), any integral
chroma sampling, with or without restart intervals, the components in one
scan or in several, and 8-bit three-component lossless JPEG as cv2 reads
it. Hierarchical JPEG, lossless arithmetic-coded JPEG, 12-bit samples, the
lossless files cv2 refuses, and every other format raise
``UnsupportedImageError`` naming what is missing; it never falls through to
a wrong image. ``image_size`` reads the size from
the header of a PNG or a JPEG (as the loader's roidb needs: a JPEG's stored
size, before any EXIF rotation, as PIL reports it to the JAX package's
roidb), and ``write_png`` writes an 8-bit RGB PNG with one row filter
throughout.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from i2vsgg_tpu_torch.data import jpeg
from i2vsgg_tpu_torch.data.jpeg import UnsupportedImageError, decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # PNG colour type -> samples
# the bit depths the PNG specification defines for each colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's seven passes: first column, first row, column step, row step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# JPEG start-of-frame markers (C4 DHT, C8 JPG and CC DAC are not frames)
_JPEG_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _png_chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked, through IEND."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _kind(data: bytes) -> str:
    if data.startswith(PNG_SIGNATURE):
        return "png"
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    return "unknown"


def image_size(path: str) -> tuple:
    """(width, height) from the header of a PNG or a JPEG file."""
    data = _read(path)
    kind = _kind(data)
    if kind == "png":
        w, h = struct.unpack(">II", data[16:24])
        return int(w), int(h)
    if kind == "jpeg":
        for marker, body in jpeg.segments(data):
            if marker in _JPEG_SOF:
                h, w = struct.unpack(">HH", body[1:5])
                return int(w), int(h)
        raise ValueError(f"{path}: JPEG without a start-of-frame marker")
    raise UnsupportedImageError(f"{path}: not a PNG or JPEG file")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (``bpp`` bytes a pixel, 1 for pixels below
    8 bits): ``raw`` (h, 1 + w * bpp) uint8, each row led by its filter
    type -> (h, w, bpp) uint8.

    None, Sub and Up rows are one numpy expression each. Average and Paeth
    predict from the reconstructed pixel to the left, so they are solved on
    anti-diagonals of the (row, pixel) grid: every pixel of a diagonal
    depends only on the one before it (left, up, up-left), so each step is
    one vectorized expression over the diagonal, whatever filter each row
    carries."""
    ftype = raw[:, 0].astype(np.int32)
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} (0-4 defined)")
    x = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if not np.isin(ftype, (3, 4)).any():
        out = np.empty((h, w, bpp), np.int32)
        prev = np.zeros((w, bpp), np.int32)
        for r in range(h):
            row = x[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0)
            elif ftype[r] == 2:
                row = row + prev
            prev = row & 255
            out[r] = prev
        return out.astype(np.uint8)
    # (h + 1, w + 1) with a zero row above and a zero column to the left
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a = out[r + 1, c]            # left
        b = out[r, c + 1]            # up
        ul = out[r, c]               # up-left
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, ul)], 0)
        out[r + 1, c + 1] = (x[r, c] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _passes(w: int, h: int, interlace: int):
    """(x0, y0, dx, dy, width, height) of each sub-image of the filtered
    data that holds rows: the whole image, or Adam7's passes that are not
    empty."""
    if not interlace:
        return [(0, 0, 1, 1, w, h)]
    out = []
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def _samples(px: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, bytes) -> their first ``width`` samples as uint8:
    16 bits cut to the high byte (libpng's ``png_set_strip_16``), below 8
    bits unpacked (the values themselves)."""
    if depth == 16:
        return px[:, 0::2][:, :width]
    if depth == 8:
        return px[:, :width]
    per = 8 // depth
    shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
    out = (px[:, :, None] >> shifts) & ((1 << depth) - 1)
    return out.reshape(px.shape[0], -1)[:, :width]


def decode_png(data: bytes, path: str = "<png>") -> np.ndarray:
    """PNG bytes -> BGR uint8 (H, W, 3), as ``cv2.imread(...,
    IMREAD_COLOR)`` gives it and as the JAX runtime's libpng transforms
    leave it: 16 bits cut to the high byte, grey below 8 bits scaled to
    0-255, palettes expanded, alpha and tRNS dropped."""
    header = palette = None
    idat = []
    for ctype, body in _png_chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not defined")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG bit depth {depth} is not defined for "
                         f"colour type {ctype}")
    if interlace > 1:
        raise ValueError(f"{path}: PNG interlace method {interlace} is not "
                         "defined")
    if comp or filt:
        raise ValueError(f"{path}: PNG compression {comp} / filter method "
                         f"{filt} is not defined")
    channels = _CHANNELS[ctype]
    bits = channels * depth                     # of a pixel
    fbpp = max(1, bits // 8)                    # the filters' pixel, bytes
    passes = _passes(w, h, interlace)
    sizes = [ph * (1 + (pw * bits + 7) // 8) for *_, pw, ph in passes]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != sum(sizes):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, "
                         f"{sum(sizes)} expected")
    px = np.empty((h, w, channels), np.uint8)
    at = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
        row = size // ph - 1
        rows = unfilter(raw[at:at + size].reshape(ph, 1 + row), ph,
                        row // fbpp, fbpp).reshape(ph, row)
        px[y0::dy, x0::dx] = _samples(rows, pw * channels,
                                      depth).reshape(ph, pw, channels)
        at += size
    if ctype in (0, 4):                         # grey (+ alpha, dropped)
        grey = px[..., :1]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(grey, 3, axis=2)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index beyond PLTE")
        return np.ascontiguousarray(palette[px[..., 0]][..., ::-1])
    return np.ascontiguousarray(px[..., 2::-1])  # RGB(A) -> BGR


def imread_bgr(path: str) -> np.ndarray:
    """The image at ``path`` as BGR uint8 (H, W, 3). A missing file raises
    ``FileNotFoundError``; a file in a format or mode the port does not
    decode raises ``UnsupportedImageError``, a corrupt one ``ValueError``."""
    data = _read(path)
    kind = _kind(data)
    if kind == "png":
        return decode_png(data, path)
    if kind == "jpeg":
        return decode_jpeg(data, path)
    raise UnsupportedImageError(f"{path}: not a PNG or JPEG file; the port "
                                "decodes PNG and JPEG only")


def _filter_rows(x: np.ndarray, ftype: int) -> np.ndarray:
    """Apply PNG filter ``ftype`` to every row of (h, w, bpp) samples
    (the predictors read the original samples, so this is vectorized)."""
    x = x.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[ftype]
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path: str, bgr: np.ndarray, filter_type: int = 0) -> None:
    """Write BGR uint8 (H, W, 3) as an 8-bit RGB PNG, every row filtered
    with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"write_png takes BGR uint8 (H, W, 3), not "
                         f"{bgr.dtype} {bgr.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type}: 0-4")
    h, w = bgr.shape[:2]
    rows = _filter_rows(bgr[..., ::-1], filter_type).reshape(h, w * 3)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))
