"""The port's decoders on every JPEG and PNG mode the JAX package's loader
decodes, on the CPU, against ``cv2.imread(path, cv2.IMREAD_COLOR)`` and the
JAX runtime's ``decode_image`` (libjpeg-turbo and libpng), byte for byte.

Each file goes through the port's three ways in: ``image_io.imread_bgr``
(the Python path: ``data/jpeg.py`` over ``csrc/jpeg.cc``, numpy and zlib
for PNG), ``runtime.decode_image`` and ``runtime.load_batch`` (the native
runtime, ``csrc/io_runtime.cc``), the last held to ``preprocess_plain`` on
cv2's decode.

* JPEG: progressive files that cv2 writes at 4:4:4, 4:2:2, 4:2:0 and grey,
  with a restart interval, with optimized tables; progressive files that
  PIL writes at several qualities and samplings; a 360x640 frame; and
  sequential files whose colour components come in separate scans, which
  neither cv2 nor PIL writes (``make_decode_fixtures.jpeg_separate_scans``,
  a numpy baseline encoder with Annex K's tables), on which cv2 and the
  JAX runtime agree.
* Every scan-boundary prefix of two progressive files, closed with EOI:
  libjpeg-turbo's block smoothing fills in what the missing scans would
  have coded. The port is held to cv2's libjpeg-turbo 3.1; the JAX
  runtime's libjpeg-turbo 2.1 departs from it there, by ``JAX_GAP`` grey
  levels at most (ROADMAP C), and on no complete file.
* PNG: every (colour type, bit depth) pair the specification defines, with
  and without tRNS, non-interlaced and Adam7 (sizes down to 1x1, where
  passes are empty), every row filter inside the passes.
* The modes still refused raise ``UnsupportedImageError`` naming the mode;
  bad scan scripts, truncated and mutated progressive files raise
  ``ValueError``, the last two in a subprocess, so that a crash fails the
  test and not the worker.
* The committed fixtures of ``tests/data/decode`` (``make_decode_fixtures``)
  equal their goldens; each progressive 360x640 frame decodes to what its
  baseline twin decodes to.
"""

import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from i2vsgg_tpu import runtime as jax_runtime

from i2vsgg_tpu_torch import runtime
from i2vsgg_tpu_torch.data import image_io
from tests import make_decode_fixtures as mk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "decode")
MANIFEST = json.load(open(os.path.join(FIXTURES, "MANIFEST.json")))
MEANS = (102.9801, 115.9465, 122.7717)
UNSUPPORTED = image_io.UnsupportedImageError


def held(path: str, jax_equal: bool = True) -> np.ndarray:
    """``path`` through the port's three ways in, each held to cv2's decode
    (and to the JAX runtime's where ``jax_equal``); returns cv2's decode.
    ``load_batch`` only from 2x2 pixels up: below that the loader refuses
    the image, as the JAX runtime does."""
    exp = cv2.imread(path, cv2.IMREAD_COLOR)
    assert exp is not None, path
    if jax_equal:
        np.testing.assert_array_equal(jax_runtime.decode_image(path), exp)
    got = image_io.imread_bgr(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(runtime.decode_image(path), exp)
    h, w = exp.shape[:2]
    if min(h, w) < 2:
        return exp
    target, pad = 24, 3 * max(h, w) + 8
    images, scales, hw = runtime.load_batch([path, path], [False, True],
                                            MEANS, target, pad, pad)
    for i, flip in enumerate((False, True)):
        want = runtime.preprocess_plain(exp, flip, MEANS, target, pad, pad)
        np.testing.assert_array_equal(images[i], want[0])
        assert scales[i] == want[1]
        np.testing.assert_array_equal(hw[i], want[2])
    return exp


def write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


# -- JPEG ----------------------------------------------------------------------

def _cv2_progressive(hw, sampling, *params, seed=0, grey=False):
    def make():
        im = mk.scene(*hw, seed)
        if grey:
            return mk.cv2_jpeg(im[..., 1], cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                               *params)
        return mk.progressive(im, 75, sampling, *params)
    return make


def _pil_progressive(hw, quality, subsampling, seed=0):
    return lambda: mk.pil_jpeg(mk.scene(*hw, seed), quality=quality,
                               subsampling=subsampling, progressive=True)


JPEG_CASES = {}
for _i, _hw in enumerate(((37, 53), (13, 21), (1, 1), (61, 83))):
    for _s in ("444", "422", "420"):
        JPEG_CASES[f"cv2_s{_s}_{_hw[0]}x{_hw[1]}"] = _cv2_progressive(
            _hw, _s, seed=_i)
    JPEG_CASES[f"cv2_grey_{_hw[0]}x{_hw[1]}"] = _cv2_progressive(
        _hw, None, seed=_i, grey=True)
for _rst in (1, 3):
    for _s in ("444", "420"):
        JPEG_CASES[f"cv2_s{_s}_rst{_rst}_41x59"] = _cv2_progressive(
            (41, 59), _s, cv2.IMWRITE_JPEG_RST_INTERVAL, _rst, seed=_rst)
JPEG_CASES["cv2_grey_rst2_41x59"] = _cv2_progressive(
    (41, 59), None, cv2.IMWRITE_JPEG_RST_INTERVAL, 2, seed=5, grey=True)
for _s in ("422", "420"):
    JPEG_CASES[f"cv2_s{_s}_optimized_47x35"] = _cv2_progressive(
        (47, 35), _s, cv2.IMWRITE_JPEG_OPTIMIZE, 1, seed=6)
for _q in (50, 75, 95):
    for _sub in (0, 1, 2):
        JPEG_CASES[f"pil_q{_q}_sub{_sub}_39x51"] = _pil_progressive(
            (39, 51), _q, _sub, seed=_q + _sub)
JPEG_CASES["frame_360x640"] = _cv2_progressive((360, 640), "420", seed=7)
SEPARATE = {
    "s420_one_a_scan": dict(),
    "s444_luma_then_chroma": dict(sampling=((1, 1),) * 3,
                                  scans=((0,), (1, 2))),
    "s422_rst1_cr_first": dict(sampling=((2, 1), (1, 1), (1, 1)),
                               scans=((2,), (0,), (1,)), restart=1),
    "s411_rst5_tables_between": dict(sampling=((4, 1), (1, 1), (1, 1)),
                                     scans=((0, 2), (1,)), restart=5,
                                     tables_between_scans=True),
}
for _k, (_name, _kw) in enumerate(SEPARATE.items()):
    JPEG_CASES[f"separate_scans_{_name}"] = (
        lambda kw=_kw, k=_k: mk.jpeg_separate_scans(
            mk.scene(29 + 4 * k, 45 + 6 * k, 30 + k), 60 + 10 * k, **kw))


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_decodes_as_cv2_and_jax(case, tmp_path):
    data = JPEG_CASES[case]()
    if case.startswith("separate_scans"):      # what the name claims
        sof = data.index(b"\xff\xc0")
        assert data[sof + 9] == 3 and data.count(b"\xff\xda") >= 2
        assert all(data[at + 4] < 3 for at in mk.scan_offsets(data))
    else:
        assert b"\xff\xc2" in data
    held(write(tmp_path, case + ".jpg", data))


def test_image_size_reads_a_progressive_header(tmp_path):
    """``image_size`` takes the size from SOF2 as from SOF0: the stored
    size, as PIL reports it to the JAX package's roidb."""
    path = write(tmp_path, "p.jpg", JPEG_CASES["cv2_s420_61x83"]())
    with Image.open(path) as im:
        assert image_io.image_size(path) == im.size == (83, 61)


# The JAX runtime's largest departure from cv2, in grey levels, on each
# prefix (the first scan alone, the first two, ...) of the files below: its
# libjpeg-turbo 2.1 smooths the blocks of a vertically subsampled component
# otherwise (4:4:4, 4:2:2 and grey prefixes agree; ROADMAP C). On complete
# files it is 0. The first file is the committed fixtures' prefix source;
# the last has an odd number of luma block rows.
PREFIX_FILES = {
    "cv2_s420_45x61": lambda: mk.progressive(mk.scene(45, 61, 9), 75, "420"),
    "cv2_s420_61x83": JPEG_CASES["cv2_s420_61x83"],
    "cv2_s420_37x53": JPEG_CASES["cv2_s420_37x53"],
}
JAX_GAP = {"cv2_s420_45x61": [12, 2, 2, 2, 2, 2, 0, 0, 0],
           "cv2_s420_61x83": [10, 5, 5, 5, 5, 4, 4, 4, 4],
           "cv2_s420_37x53": [7, 2, 2, 2, 2, 0, 0, 0, 0]}


@pytest.mark.parametrize("name", sorted(PREFIX_FILES))
def test_scan_prefixes_equal_cv2(name, tmp_path):
    data = PREFIX_FILES[name]()
    prefixes = mk.scan_prefixes(data)
    assert len(prefixes) == len(JAX_GAP[name])
    gaps = []
    for j, pre in enumerate(prefixes):
        path = write(tmp_path, f"prefix{j}.jpg", pre)
        exp = held(path, jax_equal=False)
        gaps.append(int(np.abs(jax_runtime.decode_image(path).astype(int)
                               - exp).max()))
    assert gaps == JAX_GAP[name]
    held(write(tmp_path, "whole.jpg", data))


def _patched(data: bytes, at: int, value: int) -> bytes:
    out = bytearray(data)
    out[at] = value
    return bytes(out)


def _refusals():
    base = JPEG_CASES["cv2_s420_37x53"]()
    sof = base.index(b"\xff\xc2")
    return {
        "arithmetic": (_patched(base, sof + 1, 0xCB), "lossless arithmetic"),
        "lossless": (_patched(base, sof + 1, 0xC3), "lossless"),
        "hierarchical": (_patched(base, sof + 1, 0xC6), "hierarchical"),
        "12bit": (_patched(base, sof + 4, 12), "12-bit"),
    }


@pytest.mark.parametrize("mode", ["arithmetic", "lossless", "hierarchical",
                                  "12bit"])
def test_progressive_headers_of_refused_modes_raise(mode, tmp_path):
    """A progressive file with its SOF2 patched to SOF11 (lossless
    arithmetic), SOF3 (lossless, here subsampled) or SOF6 (hierarchical),
    or its precision to 12: each way in raises ``UnsupportedImageError``
    naming the mode (``test_torch_decode_modes.py`` reads the arithmetic,
    lossless and four-component files)."""
    data, what = _refusals()[mode]
    path = write(tmp_path, mode + ".jpg", data)
    for read in (image_io.imread_bgr, runtime.decode_image,
                 lambda p: runtime.load_batch([p], [False], MEANS, 16, 32,
                                              32)):
        with pytest.raises(UNSUPPORTED, match=what):
            read(path)


def _scan_header(data: bytes, k: int) -> int:
    """The offset of scan k's Ss byte."""
    at = mk.scan_offsets(data)[k]
    return at + 5 + 2 * data[at + 4]


def _bad_scripts():
    data = JPEG_CASES["cv2_s420_37x53"]()
    second = _scan_header(data, 1)              # Y AC 1-5, Ah 0 Al 2
    first = _scan_header(data, 0)               # DC, Ah 0 Al 1
    sos = mk.scan_offsets(data)
    return {
        "Se below Ss": _patched(data, second + 1, 0),
        "Se past 63": _patched(data, second + 1, 64),
        "Al past 13": _patched(data, first + 2, 14),
        "refinement not by one bit": _patched(data, second + 2, 0x20),
        "a DC band with Se > 0": _patched(data, first + 1, 5),
        "an AC scan first": data[:sos[0]] + data[sos[1]:],
        "a DC scan twice": data[:sos[1]] + data[sos[0]:],
    }


@pytest.mark.parametrize("what", ["Se below Ss", "Se past 63", "Al past 13",
                                  "refinement not by one bit",
                                  "a DC band with Se > 0",
                                  "an AC scan first", "a DC scan twice"])
def test_bad_scan_scripts_raise(what, tmp_path):
    """Scan parameters libjpeg rejects, and progressions it only warns of
    (JWRN_BOGUS_PROGRESSION) and decodes on, raise ``ValueError``: the port
    never fills in what a scan script does not say."""
    path = write(tmp_path, "bad.jpg", _bad_scripts()[what])
    for read in (image_io.imread_bgr, runtime.decode_image):
        with pytest.raises(ValueError, match="progress") as e:
            read(path)
        assert not isinstance(e.value, UNSUPPORTED)


def test_a_scan_after_a_one_scan_sequential_file_raises(tmp_path):
    """A sequential file whose first scan holds every component has no
    other scan (libjpeg's JERR_EOI_EXPECTED): its scan repeated before EOI
    raises ``ValueError`` on both paths, though the buffer could hold it."""
    data = mk.cv2_jpeg(mk.scene(29, 37, 3))
    assert data.count(b"\xff\xda") == 1
    at = mk.scan_offsets(data)[0]
    path = write(tmp_path, "twice.jpg", data[:-2] + data[at:])
    for read in (image_io.imread_bgr, runtime.decode_image):
        with pytest.raises(ValueError, match="a second scan") as e:
            read(path)
        assert not isinstance(e.value, UNSUPPORTED)


TRUNCATE = """
import json, sys
import cv2
import numpy as np
sys.path.insert(0, sys.argv[1])
from tests import make_decode_fixtures as mk
from i2vsgg_tpu_torch.data import jpeg

data = open(sys.argv[2], "rb").read()
# the entropy-coded data of each scan: a cut inside it must raise
inside = []
for at in mk.scan_offsets(data):
    start = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    end = start
    while end + 1 < len(data) and not (
            data[end] == 0xFF and data[end + 1] not in (0, 0xFF)
            and not 0xD0 <= data[end + 1] <= 0xD7):
        end += 1
    inside.append((start, end))
counts = {"raised": 0, "decoded": 0}
for n in range(2, len(data) - 1):
    cut = data[:n]
    try:
        got = jpeg.decode_jpeg(cut)
    except ValueError:
        counts["raised"] += 1
        continue
    assert not any(s <= n < e for s, e in inside), n
    # cv2 refuses most of these (its memory source does not supply the
    # missing EOI of a progressive file); closed with EOI it decodes them
    exp = cv2.imdecode(np.frombuffer(cut + b"\\xff\\xd9", np.uint8),
                       cv2.IMREAD_COLOR)
    assert np.array_equal(got, exp), n
    counts["decoded"] += 1
print(json.dumps(counts))
"""


def _run(script, *argv):
    proc = subprocess.run([sys.executable, "-c", script, ROOT, *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["cv2_s420_rst3_41x59", "cv2_grey_37x53",
                                  "pil_q75_sub1_39x51"])
def test_truncated_progressive_files_raise(case, tmp_path):
    """Every cut of a progressive file, in a subprocess: a cut inside a
    scan's entropy-coded data raises ``ValueError``; a cut between scans
    decodes what the scans before it hold, as cv2 decodes them closed with
    EOI (the JAX runtime's libjpeg supplies the missing EOI; cv2 decodes
    only the last such cut as it is)."""
    path = write(tmp_path, "p.jpg", JPEG_CASES[case]())
    counts = _run(TRUNCATE, path)
    assert counts["raised"] > 0 and counts["decoded"] > 0, counts


FUZZ = """
import json, sys
import cv2
import numpy as np
sys.path.insert(0, sys.argv[1])
from tests import make_decode_fixtures as mk
from i2vsgg_tpu_torch.data import jpeg

rs = np.random.RandomState(int(sys.argv[2]))
counts = {"decoded": 0, "unsupported": 0, "corrupt": 0}
sources = [mk.progressive(mk.scene(41, 57, 1), 80, "420"),
           mk.progressive(mk.scene(33, 47, 2), 90, "444",
                          cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
           mk.cv2_jpeg(mk.scene(29, 35, 3)[..., 0],
                       cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
           mk.pil_jpeg(mk.scene(39, 51, 4), quality=70, progressive=True),
           mk.jpeg_separate_scans(mk.scene(25, 37, 5), 75)]
for src in sources:
    for it in range(60):
        d = bytearray(src)
        kind = it % 3
        if kind == 0:
            for _ in range(rs.randint(1, 6)):
                d[rs.randint(len(d))] = rs.randint(256)
        elif kind == 1:
            for _ in range(rs.randint(1, 6)):
                d[rs.randint(len(d))] ^= 1 << rs.randint(8)
        else:
            at = rs.randint(len(d))
            d[at:at] = rs.randint(0, 256, rs.randint(1, 16)).astype(
                np.uint8).tobytes()
        try:
            out = jpeg.decode_jpeg(bytes(d))
            assert out.dtype == np.uint8 and out.ndim == 3
            counts["decoded"] += 1
        except jpeg.UnsupportedImageError:
            counts["unsupported"] += 1
        except ValueError:
            counts["corrupt"] += 1
print(json.dumps(counts))
"""


def test_mutated_progressive_files_decode_or_raise():
    """300 seeded mutations (bytes set, bits flipped, bytes inserted) of
    progressive files (4:2:0, 4:4:4 with restarts, grey, PIL's) and a
    separate-scan file, in a fresh interpreter: each decodes or raises
    ``ValueError``; a crash is a non-zero exit."""
    counts = _run(FUZZ, "0")
    assert sum(counts.values()) == 300
    assert counts["decoded"] > 0 and counts["corrupt"] > 0, counts


HUGE = """
import json, resource, sys
sys.path.insert(0, sys.argv[1])
from i2vsgg_tpu_torch import runtime
from i2vsgg_tpu_torch.data import jpeg

path = sys.argv[2]
data = open(path, "rb").read()
jpeg.library()
runtime.library()
# from here on an allocation of a gigabyte fails
vm = int(open("/proc/self/statm").read().split()[0]) * resource.getpagesize()
resource.setrlimit(resource.RLIMIT_AS, (vm + (1 << 30),
                                        resource.getrlimit(resource.RLIMIT_AS)[1]))
out = {}
for name, read in (("python", lambda: jpeg.decode_jpeg(data)),
                   ("native", lambda: runtime.decode_image(path))):
    try:
        read()
        out[name] = "decoded"
    except ValueError as e:
        out[name] = str(e)
print(json.dumps(out))
"""


def _first_scan_alone(progressive: bool, sampling, first: int,
                      n: int) -> bytes:
    """A 65500 x 65500 frame of three components at ``sampling`` whose first
    scan holds component ``first`` alone (DC-first where ``progressive``)
    over ``n`` zero bytes of entropy-coded data, then EOI."""
    sof = (bytes([0xFF, 0xC2 if progressive else 0xC0])
           + struct.pack(">HBHHB", 17, 8, 65500, 65500, 3)
           + b"".join(bytes([c + 1, h << 4 | v, 0])
                      for c, (h, v) in enumerate(sampling)))
    sos = (b"\xff\xda" + struct.pack(">HBBB", 8, 1, first + 1, 0)
           + bytes([0, 0 if progressive else 63, 0]))
    return b"\xff\xd8" + sof + sos + bytes(n) + b"\xff\xd9"


@pytest.mark.parametrize("progressive,sampling,first,n", [
    # luma at 1x1 beside chroma at 4x4: 2047^2 luma blocks, 8 to a byte
    (True, ((1, 1), (4, 4), (4, 4)), 0, 530_000),
    # 4:2:0, Cb first: 4094^2 blocks, 4 to a byte
    (False, ((2, 2), (1, 1), (1, 1)), 1, 4_200_000),
], ids=["progressive_luma_1x1_first", "sequential_s420_cb_first"])
def test_a_first_scan_of_one_component_bounds_the_whole_frame(
        progressive, sampling, first, n, tmp_path):
    """A frame of 65500 x 65500 pixels whose first scan, of one component,
    has bytes enough for its own blocks but not for the other components'
    raises ``ValueError`` before a buffer is allocated, on both paths, in a
    subprocess held below a gigabyte more than it has after its imports
    (the buffer, planes and output would take tens of gigabytes)."""
    path = write(tmp_path, "huge.jpg",
                 _first_scan_alone(progressive, sampling, first, n))
    for name, err in _run(HUGE, path).items():
        assert "too short for the image size" in err, (name, err)


# -- PNG -----------------------------------------------------------------------

PNG_CASES = [(ctype, depth, interlace, trns)
             for ctype, depths in mk.PNG_DEPTHS.items() for depth in depths
             for interlace in (0, 1)
             for trns in ((False, True) if ctype in (0, 2, 3) else (False,))]
SIZES = ((23, 31), (1, 1), (2, 3), (5, 1), (3, 9), (9, 7), (8, 8), (4, 6))


@pytest.mark.parametrize("ctype,depth,interlace,trns", PNG_CASES)
def test_png_decodes_as_cv2_and_jax(ctype, depth, interlace, trns,
                                    tmp_path):
    """One (colour type, bit depth) pair, with or without tRNS, with or
    without Adam7, at sizes where passes are empty; the rows filtered with
    each of the five filters in turn."""
    for k, hw in enumerate(SIZES):
        data = mk.png_case(*hw, ctype, depth, 100 * ctype + depth + k,
                           interlace=interlace, trns=trns)
        assert data[24:29] == bytes([depth, ctype, 0, 0, interlace])
        assert (b"tRNS" in data) == trns
        path = write(tmp_path, f"{k}.png", data)
        exp = held(path)
        assert exp.shape == (*hw, 3)


@pytest.mark.parametrize("filter_type", range(5))
def test_each_filter_inside_the_passes(filter_type, tmp_path):
    """Adam7 with every row of every pass under one filter, at 1-9 pixels
    a side and at each pixel width the filters see (1 byte below 8 bits,
    2, 3, 4, 6, 8)."""
    for ctype, depth in ((0, 2), (3, 4), (4, 8), (2, 8), (6, 8), (4, 16),
                         (2, 16), (6, 16)):
        for h in range(1, 10, 2):
            for w in range(1, 10, 3):
                data = mk.png_case(h, w, ctype, depth, h * 10 + w,
                                   interlace=1, filters=(filter_type,))
                held(write(tmp_path, "f.png", data))


@pytest.mark.parametrize("what,ctype,depth", [
    ("bit depth 16 is not defined for colour type 3", 3, 16),
    ("bit depth 4 is not defined for colour type 2", 2, 4),
    ("bit depth 2 is not defined for colour type 6", 6, 2),
    ("bit depth 3 is not defined for colour type 0", 0, 3)])
def test_undefined_bit_depths_are_corrupt(what, ctype, depth, tmp_path):
    good = mk.png_case(5, 7, ctype, 8, 1)
    ihdr = bytearray(good[12:29])               # IHDR's type and payload
    ihdr[12] = depth
    bad = (good[:12] + bytes(ihdr)
           + struct.pack(">I", zlib.crc32(bytes(ihdr))) + good[33:])
    path = write(tmp_path, "bad.png", bad)
    for read in (image_io.imread_bgr, runtime.decode_image):
        with pytest.raises(ValueError, match=what) as e:
            read(path)
        assert not isinstance(e.value, UNSUPPORTED)


def _idat(png: bytes) -> bytes:
    return zlib.decompress(b"".join(
        body for t, body in image_io._png_chunks(png, "<png>")
        if t == b"IDAT"))


def _with_idat(png: bytes, raw: bytes) -> bytes:
    """``png`` (one IDAT chunk, after IHDR) with its image data ``raw``."""
    body = zlib.compress(raw)
    end = png.index(b"IEND") - 4
    return (png[:33] + struct.pack(">I", len(body)) + b"IDAT" + body
            + struct.pack(">I", zlib.crc32(b"IDAT" + body)) + png[end:])


def test_adam7_byte_counts_are_checked(tmp_path):
    """An Adam7 stream one byte short, or a non-interlaced stream labelled
    Adam7, raises ``ValueError`` with the byte count of the passes: for
    7x5 RGB, passes of 1x1, 1x1, 2x1, 1x2, 3x2, 2x4 and 5x3 pixels."""
    samples = np.arange(7 * 5 * 3).reshape(7, 5, 3) % 256
    good = mk.png_image(samples, 2, 8, interlace=1)
    raw = _idat(mk.png_image(samples, 2, 8))
    assert len(raw) == 7 * 16
    want = sum(ph * (1 + 3 * pw) for pw, ph in (
        (1, 1), (1, 1), (2, 1), (1, 2), (3, 2), (2, 4), (5, 3)))
    assert len(_idat(good)) == want
    for name, data in (("short", _idat(good)[:-1]), ("labelled", raw)):
        path = write(tmp_path, name + ".png", _with_idat(good, data))
        for read in (image_io.imread_bgr, runtime.decode_image):
            with pytest.raises(ValueError, match=f"{want} expected"):
                read(path)


def test_a_header_the_stream_cannot_fill_raises(tmp_path):
    """A PNG whose IHDR claims 60000 x 60000 pixels over a stream of a few
    bytes raises ``ValueError`` before the native decoder allocates the
    image (deflate expands at most 1032 times)."""
    good = mk.png_image(np.zeros((2, 2, 1), np.int64), 0, 8)
    ihdr = bytearray(good[12:29])
    ihdr[4:12] = struct.pack(">II", 60000, 60000)
    bad = (good[:12] + bytes(ihdr)
           + struct.pack(">I", zlib.crc32(bytes(ihdr))) + good[33:])
    path = write(tmp_path, "huge.png", bad)
    with pytest.raises(ValueError, match="cannot hold"):
        runtime.decode_image(path)
    with pytest.raises(ValueError, match="expected"):
        image_io.imread_bgr(path)


# -- the committed fixtures -----------------------------------------------------

# this file's sets of the fixtures (``test_torch_decode_modes.py`` holds the
# rest)
SETS = {"jpeg", "prefix", "png", "frames"}
WITH_GOLDEN = sorted(k for k, v in MANIFEST.items()
                     if "golden" in v and v["set"] in SETS)
TWINS = sorted(k for k, v in MANIFEST.items()
               if "twin" in v and v["set"] in SETS)


@pytest.mark.parametrize("name", WITH_GOLDEN)
def test_decode_fixture_equals_its_golden(name):
    entry = MANIFEST[name]
    path = os.path.join(FIXTURES, entry["file"])
    golden = image_io.imread_bgr(os.path.join(FIXTURES, entry["golden"]))
    assert list(golden.shape) == entry["shape"]
    np.testing.assert_array_equal(
        held(path, jax_equal=entry["set"] != "prefix"), golden)


@pytest.mark.parametrize("name", TWINS)
def test_progressive_frame_equals_its_baseline_twin(name):
    entry = MANIFEST[name]
    twin = os.path.join(FIXTURES, entry["twin"])
    path = os.path.join(FIXTURES, entry["file"])
    assert open(path, "rb").read().count(b"\xff\xda") == 10
    assert open(twin, "rb").read().count(b"\xff\xda") == 1
    np.testing.assert_array_equal(held(path), held(twin))


def test_decode_fixtures_cover_the_sets_and_fit():
    """Every set is there, every PNG pair new in this decoder has a file,
    and the directory stays under 512 KiB."""
    sets = {v["set"] for v in MANIFEST.values()}
    assert sets == SETS | {"arith", "four", "lossless", "refused",
                           "arith_frames"}
    pairs = {tuple(int(x[1:]) for x in k.split("_")[1:3])
             for k in MANIFEST if k.startswith("png_")}
    assert pairs == {(c, d) for c, ds in mk.PNG_DEPTHS.items() for d in ds
                     if d != 8}
    assert len(TWINS) == 4
    assert {MANIFEST[k]["shape"][0] for k in TWINS} == {360}
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 512 << 10, total
