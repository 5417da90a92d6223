"""Write the committed decode fixtures of ``tests/data/decode/``, and the
writers the decode tests share.

    python tests/make_decode_fixtures.py

A script, not a test module: it needs cv2 and PIL, which the machine with
the card lacks, so the files that ``chip_smoke.py`` phases 19 and 22 decode
there come from the repo; and ``gcc`` with the system's libjpeg
(libjpeg-turbo) headers, for the writer of the arithmetic-coded and
four-component files (``libjpeg_encode``, ``libjpeg_transcode``). Every
picture is drawn from a seeded numpy generator. Each file but the frames
and the refused files is written beside its golden:
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
  held to its twin's decode);
* ``arith``: arithmetic-coded files that libjpeg writes, sequential (SOF9)
  and progressive (SOF10): 4:4:4, 4:2:2, 4:2:0, grey and RGB, restart
  intervals, DAC conditioning other than the defaults;
* ``four``: CMYK and YCCK files (Adobe transforms 0 and 2), Huffman- and
  arithmetic-coded, progressive, subsampled, with a restart interval;
* ``lossless``: 8-bit three-component lossless files (SOF3,
  ``jpeg_lossless``, a Python encoder on ``_Bits``): each predictor, point
  transforms, restart intervals, components in separate scans;
* ``refused``: the files cv2 refuses under ``IMREAD_COLOR`` (no golden;
  ``mode`` names what the port's refusal says): grey, 12- and 16-bit and
  YCbCr lossless files, SOF11, SOF7 and SOF5;
* ``arith_frames``: the four baseline frames transcoded to arithmetic
  coding (``twin`` names the baseline file, whose pixels they hold).

Rerunning it rewrites the directory; with the same cv2, PIL and libjpeg it
writes the same bytes.
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


# -- libjpeg's encoder: arithmetic coding, CMYK and YCCK -------------------------

# a small writer compiled against the system's libjpeg (libjpeg-turbo) at
# run time: it encodes raw samples with the options it is given, or
# transcodes a JPEG's coefficients as ``jpegtran -arithmetic`` does
JWRITE_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

static int encode(int argc, char **argv) {
  /* encode in.raw out.jpg w h channels in_space jpeg_space quality arith
     progressive restart dc_l dc_u ac_k h0 v0 [h1 v1 ...] */
  int w = atoi(argv[4]), h = atoi(argv[5]), ch = atoi(argv[6]);
  int n = 16;
  size_t size = (size_t)w * h * ch;
  unsigned char *px = malloc(size);
  FILE *in = fopen(argv[2], "rb");
  if (!in || fread(px, 1, size, in) != size) return 2;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[3], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = ch;
  c.in_color_space = (J_COLOR_SPACE)atoi(argv[7]);
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)atoi(argv[8]));
  jpeg_set_quality(&c, atoi(argv[9]), TRUE);
  c.arith_code = atoi(argv[10]);
  c.restart_interval = atoi(argv[12]);
  for (int i = 0; i < n; i++) {
    c.arith_dc_L[i] = atoi(argv[13]);
    c.arith_dc_U[i] = atoi(argv[14]);
    c.arith_ac_K[i] = atoi(argv[15]);
  }
  for (int i = 0; i < c.num_components && 17 + 2 * i < argc; i++) {
    c.comp_info[i].h_samp_factor = atoi(argv[16 + 2 * i]);
    c.comp_info[i].v_samp_factor = atoi(argv[17 + 2 * i]);
  }
  if (atoi(argv[11])) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * ch;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(px);
  return 0;
}

static int transcode(char **argv) {
  /* transcode in.jpg out.jpg arith progressive */
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr derr, cerr;
  d.err = jpeg_std_error(&derr);
  jpeg_create_decompress(&d);
  FILE *in = fopen(argv[2], "rb");
  if (!in) return 2;
  jpeg_stdio_src(&d, in);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *coef = jpeg_read_coefficients(&d);
  c.err = jpeg_std_error(&cerr);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[3], "wb");
  jpeg_stdio_dest(&c, out);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = atoi(argv[4]);
  c.optimize_coding = FALSE;
  if (atoi(argv[5])) jpeg_simple_progression(&c);
  jpeg_write_coefficients(&c, coef);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  fclose(in);
  fclose(out);
  return 0;
}

int main(int argc, char **argv) {
  if (argc > 5 && argv[1][0] == 't') return transcode(argv);
  if (argc > 17) return encode(argc, argv);
  return 1;
}
"""
# libjpeg's J_COLOR_SPACE values
JCS = {"grey": 1, "rgb": 2, "ycc": 3, "cmyk": 4, "ycck": 5}
_JWRITE = {}


def jwrite() -> str:
    """The writer, built once a process with ``gcc`` and ``-ljpeg`` in a
    temporary directory."""
    if "exe" not in _JWRITE:
        import subprocess
        import tempfile
        d = tempfile.mkdtemp(prefix="jwrite_")
        src, exe = os.path.join(d, "jwrite.c"), os.path.join(d, "jwrite")
        with open(src, "w") as fh:
            fh.write(JWRITE_C)
        subprocess.run(["gcc", "-O1", "-o", exe, src, "-ljpeg"], check=True)
        _JWRITE["exe"] = exe
    return _JWRITE["exe"]


def libjpeg_encode(samples: np.ndarray, space: str = "ycc",
                   quality: int = 75, arith: bool = True,
                   progressive: bool = False, restart: int = 0,
                   dac=(0, 1, 5), sampling=None) -> bytes:
    """libjpeg's JPEG of ``samples`` (h, w) grey, (h, w, 3) RGB or
    (h, w, 4) CMYK: arithmetic-coded where ``arith`` (SOF9, SOF10 with
    ``progressive``: ``jpeg_simple_progression``'s script), the JPEG colour
    space ``space`` (grey, ycc, rgb; cmyk or ycck for four channels, with
    Adobe's APP14 transform 0 or 2), a restart interval of ``restart`` MCUs,
    DAC conditioning (L, U, Kx) for every table, and (h, v) sampling
    factors for each component."""
    import subprocess
    import tempfile
    h, w = samples.shape[:2]
    ch = 1 if samples.ndim == 2 else samples.shape[2]
    in_space = {1: "grey", 3: "rgb", 4: "cmyk"}[ch]
    with tempfile.TemporaryDirectory() as d:
        raw, out = os.path.join(d, "in.raw"), os.path.join(d, "out.jpg")
        with open(raw, "wb") as fh:
            fh.write(np.ascontiguousarray(samples, np.uint8).tobytes())
        args = [jwrite(), "encode", raw, out, w, h, ch, JCS[in_space],
                JCS[space], quality, int(arith), int(progressive), restart,
                *dac]
        for hv in sampling or ((1, 1),) * ch:
            args += list(hv)
        subprocess.run([str(a) for a in args], check=True)
        with open(out, "rb") as fh:
            return fh.read()


def libjpeg_transcode(data: bytes, arith: bool = True,
                      progressive: bool = False) -> bytes:
    """``data``'s DCT coefficients written again by libjpeg
    (``jpeg_read_coefficients``, ``jpeg_write_coefficients``), arithmetic-
    coded where ``arith``: the same quantized picture in another coding."""
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "in.jpg"), os.path.join(d, "out.jpg")
        with open(src, "wb") as fh:
            fh.write(data)
        subprocess.run([jwrite(), "transcode", src, out, str(int(arith)),
                        str(int(progressive))], check=True)
        with open(out, "rb") as fh:
            return fh.read()


# -- lossless JPEG ---------------------------------------------------------------

# the one Huffman table of the lossless files: symbols 0-16 (a difference's
# category, 16 for 32768), one code of 2 bits, five of 3, one each of 4-14
LOSSLESS_BITS = [0, 1, 5] + [1] * 11 + [0, 0]
LOSSLESS_VALS = list(range(17))


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def jpeg_lossless(samples: np.ndarray, predictor: int = 1, pt: int = 0,
                  restart_rows: int = 0, scans=None, precision: int = 8,
                  marker: int = 0xC3, ids=(1, 2, 3), adobe=None,
                  jfif: bool = False) -> bytes:
    """A lossless JPEG (SOF3, or ``marker``) of ``samples`` (h, w, n)
    stored as they are, at ``precision`` bits, as neither cv2 nor PIL
    writes one: predictor ``predictor`` (1-7), point transform ``pt``, a
    restart interval of ``restart_rows`` whole rows, the components in the
    scans ``scans`` (component indices; a scan of more than one is
    interleaved), one DHT. The component ids ``ids``, a JFIF APP0 where
    ``jfif`` and an Adobe APP14 with the transform ``adobe``."""
    h, w, n = samples.shape
    scans = scans or (tuple(range(n)),)
    x = samples.astype(np.int64) >> pt
    codes = _codes(LOSSLESS_BITS, LOSSLESS_VALS)

    def seg(m: int, body: bytes) -> bytes:
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    out += seg(marker, struct.pack(">BHHB", precision, h, w, n) + b"".join(
        bytes([ids[i], 0x11, 0]) for i in range(n)))
    out += seg(0xC4, bytes([0x00] + LOSSLESS_BITS + LOSSLESS_VALS))
    if restart_rows:
        out += seg(0xDD, struct.pack(">H", restart_rows * w))
    initial = 1 << (precision - pt - 1)
    for scan in scans:
        out += seg(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[i], 0x00]) for i in scan)
                   + bytes([predictor, 0, pt]))
        bits, rst = _Bits(), 0
        for y in range(h):
            if restart_rows and y and y % restart_rows == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + rst])
                bits, rst = _Bits(), (rst + 1) % 8
            first = restart_rows and y % restart_rows == 0 or y == 0
            for xx in range(w):
                for i in scan:
                    v = int(x[y, xx, i])
                    if first:
                        pred = initial if xx == 0 else int(x[y, xx - 1, i])
                    elif xx == 0:
                        pred = int(x[y - 1, 0, i])
                    else:
                        pred = _predict(predictor, int(x[y, xx - 1, i]),
                                        int(x[y - 1, xx, i]),
                                        int(x[y - 1, xx - 1, i]))
                    diff = (v - pred) & 0xFFFF
                    diff = diff - 65536 if diff >= 32768 else diff
                    cat = 16 if diff == -32768 else abs(diff).bit_length()
                    bits.put(*codes[cat])
                    if 0 < cat < 16:
                        bits.put(diff if diff >= 0 else diff + (1 << cat) - 1,
                                 cat)
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


def arith_files() -> dict:
    """Arithmetic-coded files that libjpeg writes (SOF9, SOF10 with its
    simple progression): 4:4:4, 4:2:2, 4:2:0 and grey, restart intervals,
    and DAC conditioning other than the defaults (L 0, U 1, Kx 5)."""
    s420 = ((2, 2), (1, 1), (1, 1))
    s422 = ((2, 1), (1, 1), (1, 1))
    s444 = ((1, 1),) * 3

    def rgb(h, w, seed):
        return scene(h, w, seed)[..., ::-1]

    return {
        "arith_seq_s420_q75_37x53": libjpeg_encode(rgb(37, 53, 70),
                                                   sampling=s420),
        "arith_seq_s444_q90_29x45": libjpeg_encode(rgb(29, 45, 71), "ycc",
                                                   90, sampling=s444),
        "arith_seq_s422_rst2_41x59": libjpeg_encode(
            rgb(41, 59, 72), "ycc", 80, restart=2, sampling=s422),
        "arith_seq_grey_q85_33x47": libjpeg_encode(scene(33, 47, 73)[..., 1],
                                                   "grey", 85),
        "arith_seq_dac_s420_45x61": libjpeg_encode(
            rgb(45, 61, 74), "ycc", 70, dac=(2, 6, 12), sampling=s420),
        "arith_prog_s420_q75_37x53": libjpeg_encode(
            rgb(37, 53, 75), progressive=True, sampling=s420),
        "arith_prog_s444_rst1_29x45": libjpeg_encode(
            rgb(29, 45, 76), "ycc", 85, progressive=True, restart=1,
            sampling=s444),
        "arith_prog_grey_q60_31x43": libjpeg_encode(
            scene(31, 43, 77)[..., 1], "grey", 60, progressive=True),
        "arith_prog_dac_s420_rst3_45x61": libjpeg_encode(
            rgb(45, 61, 78), "ycc", 75, progressive=True, restart=3,
            dac=(1, 9, 40), sampling=s420),
        "arith_seq_rgb_q80_23x31": libjpeg_encode(rgb(23, 31, 79), "rgb",
                                                  80, sampling=s444),
    }


def four_component_files() -> dict:
    """CMYK (Adobe transform 0) and YCCK (transform 2) files that libjpeg
    writes from seeded CMYK samples, Huffman- and arithmetic-coded, with
    the K plane at full resolution and the colour planes subsampled in
    some."""
    rs = np.random.RandomState(80)

    def cmyk(h, w, seed):
        k = rs.randint(0, 256, (h, w, 1)).astype(np.uint8)
        return np.concatenate([scene(h, w, seed), k], -1)

    s420 = ((2, 2), (1, 1), (1, 1), (2, 2))
    return {
        "cmyk_huff_q90_29x45": libjpeg_encode(cmyk(29, 45, 81), "cmyk", 90,
                                              arith=False),
        "ycck_huff_s420_q75_37x53": libjpeg_encode(
            cmyk(37, 53, 82), "ycck", 75, arith=False, sampling=s420),
        "cmyk_arith_prog_q80_31x43": libjpeg_encode(
            cmyk(31, 43, 83), "cmyk", 80, progressive=True),
        "ycck_arith_s420_rst2_41x59": libjpeg_encode(
            cmyk(41, 59, 84), "ycck", 85, restart=2, sampling=s420),
    }


def lossless_files() -> dict:
    """8-bit three-component lossless files (``jpeg_lossless``): each
    predictor, point transforms, restart intervals, components in separate
    scans, the ids 'R', 'G', 'B' and an Adobe transform of 0."""
    files = {f"lossless_p{p}_23x31": jpeg_lossless(scene(23, 31, 90 + p), p)
             for p in range(1, 8)}
    files.update({
        "lossless_p4_pt2_19x27": jpeg_lossless(scene(19, 27, 98), 4, pt=2),
        "lossless_p7_pt5_rst3_17x21": jpeg_lossless(scene(17, 21, 99), 7,
                                                    pt=5, restart_rows=3),
        "lossless_p1_rst1_13x9": jpeg_lossless(scene(13, 9, 100), 1,
                                               restart_rows=1),
        "lossless_p6_scans_21x25": jpeg_lossless(
            scene(21, 25, 101), 6, scans=((2,), (0,), (1,))),
        "lossless_p5_scans_rst2_15x19": jpeg_lossless(
            scene(15, 19, 102), 5, restart_rows=2, scans=((1,), (0, 2))),
        "lossless_p2_rgb_adobe0_11x17": jpeg_lossless(
            scene(11, 17, 103), 2, ids=(82, 71, 66), adobe=0),
    })
    return files


def refused_files() -> dict:
    """The modes cv2 refuses under ``IMREAD_COLOR`` (``mode``: what the
    port's refusal names): lossless with one component, at 12 and 16 bits,
    in YCbCr (a JFIF marker), lossless arithmetic (SOF11), and hierarchical
    files (SOF5, SOF7, the last a lossless file's bytes under SOF7)."""
    im = scene(11, 13, 110)
    deep = im.astype(np.uint16)
    return {
        "lossless_grey_11x13": (jpeg_lossless(im[..., :1]), "grey"),
        "lossless_12bit_11x13": (jpeg_lossless(deep * 16, precision=12),
                                 "12-bit lossless"),
        "lossless_16bit_11x13": (jpeg_lossless(deep * 257, precision=16),
                                 "16-bit lossless"),
        "lossless_jfif_11x13": (jpeg_lossless(im, jfif=True), "YCbCr"),
        "sof11_11x13": (jpeg_lossless(im, marker=0xCB),
                        "lossless arithmetic"),
        "sof7_11x13": (jpeg_lossless(im, marker=0xC7), "hierarchical"),
        "sof5_11x13": (jpeg_lossless(im, marker=0xC5), "hierarchical"),
    }


def arith_frame_files() -> dict:
    """The four 360x640 frames' baseline files transcoded to arithmetic
    coding (SOF9): the same coefficients, so the same pixels."""
    files = {}
    for i in range(4):
        with open(os.path.join(OUT, f"frame{i}_360x640.jpg"), "rb") as fh:
            files[f"frame{i}_360x640_arith"] = libjpeg_transcode(fh.read())
    return files


def main() -> int:
    sys.path.insert(0, ROOT)
    from i2vsgg_tpu_torch.data.image_io import write_png
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    manifest = {}
    for kind, make in (("jpeg", jpeg_files), ("prefix", prefix_files),
                       ("png", png_files), ("frames", frame_files),
                       ("arith", arith_files), ("four", four_component_files),
                       ("lossless", lossless_files),
                       ("refused", refused_files),
                       ("arith_frames", arith_frame_files)):
        for name, data in make().items():
            mode = None
            if kind == "refused":
                data, mode = data
            ext = ".png" if data.startswith(PNG_SIGNATURE) else ".jpg"
            path = os.path.join(OUT, name + ext)
            with open(path, "wb") as fh:
                fh.write(data)
            decoded = cv2.imread(path, cv2.IMREAD_COLOR)
            if mode is not None:
                assert decoded is None, name          # cv2 refuses it
                manifest[name] = {"set": kind, "file": name + ext,
                                  "mode": mode}
                continue
            entry = {"set": kind, "file": name + ext,
                     "shape": list(decoded.shape)}
            if kind in ("frames", "arith_frames"):
                for suffix in ("_progressive", "_arith"):
                    if name.endswith(suffix):
                        entry["twin"] = name[:-len(suffix)] + ".jpg"
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
