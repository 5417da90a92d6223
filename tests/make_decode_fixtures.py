"""Write the committed decode fixtures of ``tests/data/decode/``, and the
writers the decode tests share.

    python tests/make_decode_fixtures.py

A script, not a test module: it needs cv2 and PIL, which the machine with
the card lacks, so the files that ``chip_smoke.py`` phase 19 decodes there
come from the repo. Every picture is drawn from a seeded numpy generator.
Each file but the four frame pairs is written beside its golden:
``cv2.imread(path, cv2.IMREAD_COLOR)`` of the file, written with the port's
``write_png`` as an 8-bit PNG. ``MANIFEST.json`` lists each file with its
set:

* ``jpeg``: progressive files written by cv2 and PIL (4:4:4, 4:2:2, 4:2:0,
  grey, a restart interval, optimized tables) and sequential files whose
  colour components come in separate scans (``jpeg_separate_scans``: one
  scan a component, or luma then both chroma components in one scan, with
  tables between the scans);
* ``prefix``: every scan-boundary prefix of one progressive file, closed
  with EOI, where libjpeg-turbo's block smoothing estimates what the
  missing scans would have coded;
* ``png``: one PNG for each colour type and bit depth the port read only
  from this slice on (grey 1, 2, 4, 16; palette 1, 2, 4; RGB, grey + alpha
  and RGBA at 16), with and without tRNS, and Adam7-interlaced PNG at
  several depths, every row filter in the passes;
* ``frames``: four 360x640 video frames, each in baseline and progressive
  form, of the same picture at the same quality (``twin`` names the
  baseline file; no golden, which would not fit: a progressive frame is
  held to its twin's decode).

Rerunning it rewrites the directory; with the same cv2 and PIL it writes
the same bytes.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "decode")
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111}
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# every (colour type, bit depth) pair the PNG specification defines
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
              6: (8, 16)}


def scene(h: int, w: int, seed: int, noise: float = 4.0) -> np.ndarray:
    """A BGR uint8 (h, w, 3) picture: crossing gradients, filled discs and
    boxes, and Gaussian noise of ``noise`` grey levels."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    im = np.stack([40 + 160 * x / max(w - 1, 1),
                   60 + 120 * y / max(h - 1, 1),
                   200 - 100 * (x + y) / max(h + w - 2, 1)], -1)
    for _ in range(6):
        color = rs.randint(0, 256, 3)
        cy, cx = rs.randint(0, h), rs.randint(0, w)
        r = rs.randint(1, max(2, min(h, w) // 4))
        if rs.rand() < 0.5:
            im[(y - cy) ** 2 + (x - cx) ** 2 < r ** 2] = color
        else:
            im[max(cy - r, 0):cy + r, max(cx - 2 * r, 0):cx + 2 * r] = color
    im += rs.randn(h, w, 3) * noise
    return np.clip(np.rint(im), 0, 255).astype(np.uint8)


# -- JPEG ----------------------------------------------------------------------

def cv2_jpeg(im: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", im, list(params))
    assert ok
    return buf.tobytes()


def pil_jpeg(im: np.ndarray, **kw) -> bytes:
    src = im[..., ::-1] if im.ndim == 3 else im
    b = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(src)).save(b, "JPEG", **kw)
    return b.getvalue()


def progressive(im: np.ndarray, quality: int = 75, sampling: str = "420",
                *params) -> bytes:
    """cv2's progressive JPEG (libjpeg's standard scan script)."""
    return cv2_jpeg(im, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                    cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                    *params)


def scan_offsets(data: bytes) -> list:
    """The offset of each SOS marker of a JPEG written by an encoder (the
    entropy-coded data holds no unstuffed FF DA)."""
    out, pos = [], 2
    while (pos := data.find(b"\xff\xda", pos)) >= 0:
        out.append(pos)
        pos += 2
    return out


def scan_prefixes(data: bytes) -> list:
    """Each prefix of ``data`` that ends after a whole scan, closed with
    EOI: the first scan alone, the first two, ..., all but the last."""
    return [data[:at] + b"\xff\xd9" for at in scan_offsets(data)[1:]]


def _segments(data: bytes):
    """(marker, payload) of each marker segment before the first scan."""
    pos = 2
    while data[pos + 1] != 0xDA:
        marker = data[pos + 1]
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield marker, data[pos + 4:pos + 2 + n]
        pos += 2 + n


def _natural_order() -> np.ndarray:
    """zigzag index -> natural (row-major) index of an 8x8 block."""
    order = sorted(((r + c, (r if (r + c) % 2 else c), r * 8 + c)
                    for r in range(8) for c in range(8)))
    return np.array([k for *_, k in order])


NATURAL = _natural_order()


def libjpeg_tables(quality: int):
    """cv2's quantization tables at ``quality`` (natural order; luma,
    chroma) and its Huffman tables, the standard ones of Annex K
    ({(class, id): (bits, values)}), read from a file cv2 writes."""
    data = cv2_jpeg(np.zeros((8, 8, 3), np.uint8),
                    cv2.IMWRITE_JPEG_QUALITY, quality)
    qt, huff = {}, {}
    for marker, body in _segments(data):
        p = 0
        while marker == 0xDB and p < len(body):
            table = np.zeros(64, np.int64)
            table[NATURAL] = np.frombuffer(body[p + 1:p + 65], np.uint8)
            qt[body[p] & 15] = table.reshape(8, 8)
            p += 65
        while marker == 0xC4 and p < len(body):
            bits = list(body[p + 1:p + 17])
            vals = list(body[p + 17:p + 17 + sum(bits)])
            huff[(body[p] >> 4, body[p] & 15)] = (bits, vals)
            p += 17 + sum(bits)
    return (qt[0], qt[1]), huff


def _codes(bits, vals) -> dict:
    """symbol -> (code, length) of a canonical Huffman table."""
    out, code, p = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[p]] = (code, length)
            code += 1
            p += 1
        code <<= 1
    return out


class _Bits:
    """An entropy-coded segment: bits MSB first, FF bytes stuffed."""

    def __init__(self):
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, value: int, length: int):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 255
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)   # 1-bit padding


def _dct_matrix() -> np.ndarray:
    u, x = np.mgrid[0:8, 0:8]
    m = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


def _blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(rows, cols) samples, multiples of 8 -> quantized DCT blocks
    (rows / 8, cols / 8, 8, 8), natural order."""
    m = _dct_matrix()
    r, c = plane.shape
    b = plane.reshape(r // 8, 8, c // 8, 8).transpose(0, 2, 1, 3) - 128.0
    coef = np.einsum("ux,abxy,vy->abuv", m, b, m)
    return np.rint(coef / q).astype(np.int64)


def _encode_block(bits: _Bits, block: np.ndarray, diff: int, dc: dict,
                  ac: dict):
    def magnitude(v):
        n = int(abs(v)).bit_length()
        return n, (v if v >= 0 else v + (1 << n) - 1)

    n, v = magnitude(diff)
    bits.put(*dc[n])
    bits.put(v, n)
    zz = block.reshape(64)[NATURAL]
    run = 0
    for k in range(1, 64):
        if zz[k] == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*ac[0xF0])                 # ZRL
            run -= 16
        n, v = magnitude(int(zz[k]))
        bits.put(*ac[(run << 4) | n])
        bits.put(v, n)
        run = 0
    if run:
        bits.put(*ac[0x00])                     # EOB


def jpeg_separate_scans(im: np.ndarray, quality: int = 75,
                        sampling=((2, 2), (1, 1), (1, 1)),
                        scans=((0,), (1,), (2,)), restart: int = 0,
                        tables_between_scans: bool = False) -> bytes:
    """A sequential baseline JPEG (SOF0) of the BGR picture ``im`` whose
    components come in the scans ``scans`` (component indices; a scan of
    more than one is interleaved), as neither cv2 nor PIL writes one: JFIF
    YCbCr, cv2's quantization tables at ``quality``, Annex K's Huffman
    tables, a restart interval of ``restart`` MCUs. With
    ``tables_between_scans`` the chroma tables (DQT and DHT) come just
    before the first scan that uses them."""
    h, w = im.shape[:2]
    (qy, qc), huff = libjpeg_tables(quality)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    b, g, r = (im[..., i].astype(np.float64) for i in range(3))
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    comps = []
    for i, (plane, (hs, vs)) in enumerate(zip(planes, sampling)):
        full = np.pad(np.clip(np.rint(plane), 0, 255),
                      ((0, mcuy * vmax * 8 - h), (0, mcux * hmax * 8 - w)),
                      mode="edge")
        fy, fx = vmax // vs, hmax // hs
        down = full.reshape(full.shape[0] // fy, fy, full.shape[1] // fx,
                            fx).mean((1, 3))
        comps.append(dict(
            h=hs, v=vs, tq=min(i, 1), blocks=_blocks(np.rint(down),
                                                     qy if i == 0 else qc),
            bw=-(-(w * hs) // (8 * hmax)), bh=-(-(h * vs) // (8 * vmax))))

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    def dqt(tq, q):
        return seg(0xDB, bytes([tq]) + bytes(
            int(x) for x in q.reshape(64)[NATURAL]))

    def dht(tc, th):
        bits, vals = huff[(tc, th)]
        return seg(0xC4, bytes([tc << 4 | th] + bits + vals))

    out = bytearray(b"\xff\xd8")
    out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += dqt(0, qy) + dht(0, 0) + dht(1, 0)
    chroma_tables = dqt(1, qc) + dht(0, 1) + dht(1, 1)
    if not tables_between_scans:
        out += chroma_tables
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([i + 1, c["h"] << 4 | c["v"], c["tq"]])
        for i, c in enumerate(comps)))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    for scan in scans:
        if tables_between_scans and chroma_tables and any(scan):
            out += chroma_tables
            chroma_tables = b""
        out += seg(0xDA, bytes([len(scan)]) + b"".join(
            bytes([i + 1, comps[i]["tq"] * 0x11]) for i in scan)
                   + b"\x00\x3f\x00")
        if len(scan) == 1:
            c = comps[scan[0]]
            order = [[(scan[0], y, x)] for y in range(c["bh"])
                     for x in range(c["bw"])]
        else:
            order = [[(i, my * comps[i]["v"] + y, mx * comps[i]["h"] + x)
                      for i in scan for y in range(comps[i]["v"])
                      for x in range(comps[i]["h"])]
                     for my in range(mcuy) for mx in range(mcux)]
        bits, pred, rst = _Bits(), {i: 0 for i in scan}, 0
        for n, mcu in enumerate(order):
            if restart and n and n % restart == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + rst])
                bits, pred, rst = _Bits(), {i: 0 for i in scan}, (rst + 1) % 8
            for i, y, x in mcu:
                block = comps[i]["blocks"][y, x]
                tq = comps[i]["tq"]
                _encode_block(bits, block, int(block[0, 0]) - pred[i],
                              _codes(*huff[(0, tq)]), _codes(*huff[(1, tq)]))
                pred[i] = int(block[0, 0])
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


# -- PNG -----------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(rows, n) samples -> (rows, bytes) packed big-endian, MSB first."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(
            samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    rows, n = samples.shape
    padded = np.zeros((rows, -(-n // per) * per), np.int64)
    padded[:, :n] = samples
    shifts = 8 - depth - depth * np.arange(per)
    return (padded.reshape(rows, -1, per) << shifts).sum(-1).astype(np.uint8)


def png_image(samples: np.ndarray, ctype: int, depth: int,
              interlace: int = 0, filters=(0,), palette=None, trns=None,
              level: int = 6) -> bytes:
    """A PNG of ``samples`` (h, w, channels) at ``depth`` bits of colour
    type ``ctype``: Adam7 where ``interlace``, the rows of each pass
    filtered in turn with ``filters`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), a PLTE of ``palette`` ((n, 3) RGB) and a tRNS of ``trns``
    (bytes) where given."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw, k = [], 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth).astype(np.int64)
        prev = np.zeros(rows.shape[1], np.int64)
        for row in rows:
            f = filters[k % len(filters)]
            k += 1
            a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            pred = {0: 0, 1: a, 2: prev, 3: (a + prev) >> 1,
                    4: _paeth(a, prev, c)}[f]
            raw.append(bytes([f]) + ((row - pred) & 255).astype(
                np.uint8).tobytes())
            prev = row

    def chunk(ctype_: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype_ + body
                + struct.pack(">I", zlib.crc32(ctype_ + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + (chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
               if palette is not None else b"")
            + (chunk(b"tRNS", trns) if trns is not None else b"")
            + chunk(b"IDAT", zlib.compress(b"".join(raw), level))
            + chunk(b"IEND", b""))


def png_case(h: int, w: int, ctype: int, depth: int, seed: int,
             interlace: int = 0, filters=(0, 1, 2, 3, 4),
             trns: bool = False) -> bytes:
    """A seeded PNG of one colour type and depth: samples drawn over the
    whole range of the depth on a gradient, a palette of 2^depth entries
    (some short of it, all indices inside it), a tRNS chunk of the colour
    type's form where ``trns``."""
    rs = np.random.RandomState(seed)
    top = (1 << depth) - 1
    ch = CHANNELS[ctype]
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 7 + y * 13)[..., None] * (top // 31 + 1) + np.arange(ch) * 5
    samples = (base + rs.randint(0, top + 1, (h, w, ch))) % (top + 1)
    palette = trns_chunk = None
    if ctype == 3:
        n = min(top + 1, 256) - (seed % 2)
        samples %= n
        palette = rs.randint(0, 256, (n, 3))
    if trns:
        if ctype == 3:
            trns_chunk = bytes(rs.randint(0, 256, max(1, n // 2)).astype(
                np.uint8))
        elif ctype == 0:
            trns_chunk = struct.pack(">H", int(samples[0, 0, 0]))
        elif ctype == 2:
            trns_chunk = struct.pack(">HHH", *map(int, samples[0, 0]))
    return png_image(samples, ctype, depth, interlace, filters, palette,
                     trns_chunk)


# -- the fixtures --------------------------------------------------------------

def jpeg_files() -> dict:
    im = scene(37, 53, 1)
    return {
        "progressive_s420_q75_37x53": progressive(im),
        "progressive_s444_q90_29x45": progressive(scene(29, 45, 2), 90,
                                                  "444"),
        "progressive_s422_rst2_41x59": progressive(
            scene(41, 59, 3), 80, "422", cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "progressive_grey_q85_33x47": cv2_jpeg(
            scene(33, 47, 4)[..., 1], cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_QUALITY, 85),
        "progressive_optimized_s420_31x43": progressive(
            scene(31, 43, 5), 70, "420", cv2.IMWRITE_JPEG_OPTIMIZE, 1),
        "progressive_pil_s422_q60_35x49": pil_jpeg(
            scene(35, 49, 6), quality=60, subsampling=1, progressive=True),
        "separate_scans_s420_q80_37x53": jpeg_separate_scans(
            scene(37, 53, 7), 80),
        "separate_scans_s444_rst3_29x45": jpeg_separate_scans(
            scene(29, 45, 8), 85, ((1, 1),) * 3, ((0,), (1, 2)), restart=3,
            tables_between_scans=True),
    }


def prefix_files() -> dict:
    data = progressive(scene(45, 61, 9), 75, "420")
    return {f"prefix{j + 1}_s420_45x61": pre
            for j, pre in enumerate(scan_prefixes(data))}


def png_files() -> dict:
    files, seed = {}, 20
    for ctype, depths in PNG_DEPTHS.items():
        for depth in depths:
            if depth == 8:
                continue                        # read before this slice
            seed += 1
            files[f"png_c{ctype}_d{depth}_23x31"] = png_case(
                23, 31, ctype, depth, seed, trns=ctype in (0, 3))
    for ctype, depth, hw in ((2, 8, (19, 27)), (3, 2, (9, 9)),
                             (0, 1, (5, 3)), (6, 16, (13, 17))):
        seed += 1
        files[f"adam7_c{ctype}_d{depth}_{hw[0]}x{hw[1]}"] = png_case(
            *hw, ctype, depth, seed, interlace=1)
    return files


def frame_files() -> dict:
    """Four 360x640 frames, each in baseline and progressive form: the same
    picture at the same quality and sampling."""
    files = {}
    for i in range(4):
        im = scene(360, 640, 60 + i, noise=2.0)
        q = (cv2.IMWRITE_JPEG_QUALITY, 75,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"])
        files[f"frame{i}_360x640"] = cv2_jpeg(im, *q)
        files[f"frame{i}_360x640_progressive"] = cv2_jpeg(
            im, *q, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    return files


def main() -> int:
    sys.path.insert(0, ROOT)
    from i2vsgg_tpu_torch.data.image_io import write_png
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    manifest = {}
    for kind, files in (("jpeg", jpeg_files()), ("prefix", prefix_files()),
                        ("png", png_files()), ("frames", frame_files())):
        for name, data in files.items():
            ext = ".png" if data.startswith(PNG_SIGNATURE) else ".jpg"
            path = os.path.join(OUT, name + ext)
            with open(path, "wb") as fh:
                fh.write(data)
            decoded = cv2.imread(path, cv2.IMREAD_COLOR)
            entry = {"set": kind, "file": name + ext,
                     "shape": list(decoded.shape)}
            if kind == "frames":
                if name.endswith("_progressive"):
                    entry["twin"] = name[:-len("_progressive")] + ".jpg"
            else:
                entry["golden"] = name + ".golden.png"
                write_png(os.path.join(OUT, entry["golden"]), decoded, 2)
            manifest[name] = entry
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(OUT, f))
                for f in os.listdir(OUT))
    print(f"{len(manifest)} fixtures, {total} bytes in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
