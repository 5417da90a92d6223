"""The JPEG modes the port's decoder reads from this slice on, on the CPU,
against ``cv2.imread(path, cv2.IMREAD_COLOR)`` byte for byte, through both
of the port's loaders (``image_io.imread_bgr``, the Python path over
``data/jpeg.py``; ``runtime.decode_image`` and ``runtime.load_batch``, the
native runtime), both over ``csrc/jpeg.cc``:

* arithmetic-coded JPEG (SOF9, SOF10): the committed fixtures of
  ``tests/data/decode`` (set ``arith``) and a matrix that libjpeg writes
  here (``make_decode_fixtures.libjpeg_encode``: sizes down to 1x1, 4:4:4,
  4:2:2, 4:2:0 and grey, sequential and progressive, restart intervals, DAC
  conditioning), each also bit-equal to the JAX runtime's ``decode_image``
  (libjpeg-turbo 2.1); the four 360x640 frames' arithmetic-coded twins
  (set ``arith_frames``) equal to their baseline frames;
* four components (set ``four``, and CMYK and YCCK files written here):
  cv2 is the only oracle; the JAX runtime asks libjpeg for RGB and fails on
  each, as recorded here;
* lossless JPEG (set ``lossless``, and a matrix of ``jpeg_lossless``
  files: every predictor, point transforms, restart intervals, separate
  scans);
* the modes cv2 refuses (set ``refused``): cv2 returns None, and each way
  in raises ``UnsupportedImageError`` naming the mode;
* corrupt arithmetic and lossless data: restart markers out of order, DAC
  segments libjpeg rejects, lossless restart intervals of part of a row,
  bad predictors and a component no scan codes raise ``ValueError`` where
  cv2 decodes nothing; every cut of an arithmetic-coded file inside its
  entropy-coded data raises ``ValueError``; seeded mutations of the
  entropy-coded data decode or raise ``ValueError`` (both in a subprocess,
  so that a crash fails the test and not the worker).

Runtime: about 20 s alone on 6 CPU cores (the libjpeg writer is built once
a worker with ``gcc``, in well under a second).
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from i2vsgg_tpu import runtime as jax_runtime

from i2vsgg_tpu_torch import runtime
from i2vsgg_tpu_torch.data import image_io
from tests import make_decode_fixtures as mk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "decode")
MANIFEST = json.load(open(os.path.join(FIXTURES, "MANIFEST.json")))
MEANS = (102.9801, 115.9465, 122.7717)
UNSUPPORTED = image_io.UnsupportedImageError
S420 = ((2, 2), (1, 1), (1, 1))
SAMPLINGS = {"444": ((1, 1),) * 3, "422": ((2, 1), (1, 1), (1, 1)),
             "420": S420, "grey": None}


def write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


def held(path: str, jax_equal: bool) -> np.ndarray:
    """``path`` through the port's three ways in, each held to cv2's decode
    (and to the JAX runtime's where ``jax_equal``, else the JAX runtime
    must fail); returns cv2's decode."""
    exp = cv2.imread(path, cv2.IMREAD_COLOR)
    assert exp is not None, path
    if jax_equal:
        np.testing.assert_array_equal(jax_runtime.decode_image(path), exp)
    got = image_io.imread_bgr(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(runtime.decode_image(path), exp)
    h, w = exp.shape[:2]
    if min(h, w) >= 2:
        target, pad = 24, 3 * max(h, w) + 8
        images, scales, hw = runtime.load_batch([path, path], [False, True],
                                                MEANS, target, pad, pad)
        for i, flip in enumerate((False, True)):
            want = runtime.preprocess_plain(exp, flip, MEANS, target, pad,
                                            pad)
            np.testing.assert_array_equal(images[i], want[0])
            assert scales[i] == want[1]
    return exp


def sof_marker(data: bytes) -> int:
    for marker, _ in mk._segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return marker
    raise AssertionError("no SOF")


# -- the committed fixtures ---------------------------------------------------

NEW_SETS = ("arith", "four", "lossless")
WITH_GOLDEN = sorted(k for k, v in MANIFEST.items() if v["set"] in NEW_SETS)
ARITH_TWINS = sorted(k for k, v in MANIFEST.items()
                     if v["set"] == "arith_frames")
REFUSED = sorted(k for k, v in MANIFEST.items() if v["set"] == "refused")


@pytest.mark.parametrize("name", WITH_GOLDEN)
def test_fixture_equals_its_golden(name):
    """Each arithmetic-coded, four-component and lossless fixture equals
    its golden (cv2's decode) on both loaders; the arithmetic ones equal the
    JAX runtime's decode, which fails on the others."""
    entry = MANIFEST[name]
    path = os.path.join(FIXTURES, entry["file"])
    golden = image_io.imread_bgr(os.path.join(FIXTURES, entry["golden"]))
    assert list(golden.shape) == entry["shape"]
    arith = entry["set"] == "arith"
    np.testing.assert_array_equal(held(path, jax_equal=arith), golden)
    if not arith:
        with pytest.raises(Exception):
            jax_runtime.decode_image(path)
    assert sof_marker(open(path, "rb").read()) in {
        "arith": (0xC9, 0xCA), "four": (0xC0, 0xC9, 0xCA),
        "lossless": (0xC3,)}[entry["set"]]


@pytest.mark.parametrize("name", ARITH_TWINS)
def test_arithmetic_frame_equals_its_baseline_twin(name):
    """Each 360x640 frame transcoded to arithmetic coding (its baseline
    file's coefficients) decodes to the baseline file's pixels on both
    loaders, as cv2 and the JAX runtime decode it."""
    entry = MANIFEST[name]
    path = os.path.join(FIXTURES, entry["file"])
    twin = os.path.join(FIXTURES, entry["twin"])
    assert sof_marker(open(path, "rb").read()) == 0xC9
    assert sof_marker(open(twin, "rb").read()) == 0xC0
    np.testing.assert_array_equal(held(path, jax_equal=True),
                                  held(twin, jax_equal=True))


@pytest.mark.parametrize("name", REFUSED)
def test_refused_fixture_raises_naming_the_mode(name):
    """A file cv2 refuses under ``IMREAD_COLOR`` raises
    ``UnsupportedImageError`` naming its mode on each way in."""
    entry = MANIFEST[name]
    path = os.path.join(FIXTURES, entry["file"])
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    for read in (image_io.imread_bgr, runtime.decode_image,
                 lambda p: runtime.load_batch([p], [False], MEANS, 16, 32,
                                              32)):
        with pytest.raises(UNSUPPORTED, match=entry["mode"]):
            read(path)


def test_fixtures_cover_the_modes_and_fit():
    """The new sets cover what they claim, and the directory stays under
    512 KiB."""
    markers = {}
    for name in WITH_GOLDEN + ARITH_TWINS:
        entry = MANIFEST[name]
        data = open(os.path.join(FIXTURES, entry["file"]), "rb").read()
        markers.setdefault(entry["set"], set()).add(sof_marker(data))
    assert markers == {"arith": {0xC9, 0xCA}, "four": {0xC0, 0xC9, 0xCA},
                       "lossless": {0xC3}, "arith_frames": {0xC9}}
    predictors = {int(k.split("_")[1][1:]) for k in WITH_GOLDEN
                  if MANIFEST[k]["set"] == "lossless"}
    assert predictors == set(range(1, 8))
    assert len(ARITH_TWINS) == 4
    assert {MANIFEST[k]["mode"] for k in REFUSED} >= {
        "grey", "12-bit lossless", "16-bit lossless", "lossless arithmetic",
        "hierarchical", "YCbCr"}
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 512 << 10, total


# -- files libjpeg writes here ------------------------------------------------

ARITH_CASES = {}
for _i, _hw in enumerate(((37, 53), (13, 21), (1, 1), (61, 83))):
    for _s in SAMPLINGS:
        for _prog in (False, True):
            ARITH_CASES[f"{'prog' if _prog else 'seq'}_{_s}_"
                        f"{_hw[0]}x{_hw[1]}"] = dict(
                hw=_hw, sampling=_s, progressive=_prog, seed=_i)
for _rst in (1, 5):
    for _s in ("444", "420", "grey"):
        ARITH_CASES[f"prog_{_s}_rst{_rst}_41x59"] = dict(
            hw=(41, 59), sampling=_s, progressive=True, restart=_rst,
            seed=_rst)
        ARITH_CASES[f"seq_{_s}_rst{_rst}_41x59"] = dict(
            hw=(41, 59), sampling=_s, restart=_rst, seed=_rst + 1)
for _k, _dac in enumerate(((0, 0, 1), (3, 8, 20), (5, 15, 63))):
    for _prog in (False, True):
        ARITH_CASES[f"{'prog' if _prog else 'seq'}_dac{_k}_45x61"] = dict(
            hw=(45, 61), sampling="420", progressive=_prog, dac=_dac,
            seed=10 + _k)


def arith_file(hw, sampling, progressive=False, restart=0, dac=(0, 1, 5),
               seed=0, quality=75) -> bytes:
    im = mk.scene(*hw, 40 + seed)
    if sampling == "grey":
        return mk.libjpeg_encode(im[..., 1], "grey", quality, True,
                                 progressive, restart, dac)
    return mk.libjpeg_encode(im[..., ::-1], "ycc", quality, True, progressive,
                             restart, dac, SAMPLINGS[sampling])


@pytest.mark.parametrize("case", sorted(ARITH_CASES))
def test_arithmetic_decodes_as_cv2_and_jax(case, tmp_path):
    data = arith_file(**ARITH_CASES[case])
    assert sof_marker(data) == (0xCA if case.startswith("prog") else 0xC9)
    assert b"\xff\xcc" in data                  # a DAC segment
    held(write(tmp_path, case + ".jpg", data), jax_equal=True)


FOUR_CASES = {f"{space}_{'arith' if arith else 'huff'}_"
              f"{'prog' if prog else 'seq'}_{samp}": (space, arith, prog,
                                                      samp)
              for space in ("cmyk", "ycck") for arith in (False, True)
              for prog in (False, True) for samp in ("1x1", "mixed")}


@pytest.mark.parametrize("case", sorted(FOUR_CASES))
def test_four_components_decode_as_cv2(case, tmp_path):
    """CMYK and YCCK written by libjpeg (Adobe transforms 0 and 2), the K
    plane drawn at random: equal to cv2 (YCCK to CMYK by jdcolor.c, then
    OpenCV's CMYK to BGR); the JAX runtime fails on each."""
    space, arith, prog, samp = FOUR_CASES[case]
    rs = np.random.RandomState(len(case))
    h, w = 29, 45
    im = np.concatenate([mk.scene(h, w, len(case)),
                         rs.randint(0, 256, (h, w, 1)).astype(np.uint8)], -1)
    sampling = (((1, 1),) * 4 if samp == "1x1"
                else ((1, 1), (2, 1), (1, 2), (2, 2)))
    # the Adobe transform: byte 11 of the APP14 segment
    data = mk.libjpeg_encode(im, space, 85, arith, prog, 0,
                             sampling=sampling)
    [adobe] = [b for m, b in mk._segments(data) if m == 0xEE]
    assert adobe[11] == (2 if space == "ycck" else 0)
    path = write(tmp_path, case + ".jpg", data)
    held(path, jax_equal=False)
    with pytest.raises(Exception):
        jax_runtime.decode_image(path)


LOSSLESS_CASES = {}
for _p in range(1, 8):
    for _pt in (0, 3):
        LOSSLESS_CASES[f"p{_p}_pt{_pt}_17x23"] = dict(predictor=_p, pt=_pt)
    LOSSLESS_CASES[f"p{_p}_rst2_scans_17x23"] = dict(
        predictor=_p, restart_rows=2, scans=((2,), (0, 1)))
LOSSLESS_CASES["p1_1x1"] = dict(hw=(1, 1))
LOSSLESS_CASES["p4_rst1_2x1"] = dict(hw=(2, 1), predictor=4, restart_rows=1)
LOSSLESS_CASES["p7_pt7_9x5"] = dict(hw=(9, 5), predictor=7, pt=7)


@pytest.mark.parametrize("case", sorted(LOSSLESS_CASES))
def test_lossless_decodes_as_cv2(case, tmp_path):
    """Three components stored as they are (the first in R), shifted up by
    the point transform: cv2's decode, and the picture itself."""
    kw = dict(LOSSLESS_CASES[case])
    hw = kw.pop("hw", (17, 23))
    im = mk.scene(*hw, len(case))
    exp = held(write(tmp_path, case + ".jpg", mk.jpeg_lossless(im, **kw)),
               jax_equal=False)
    pt = kw.get("pt", 0)
    np.testing.assert_array_equal(exp, (im[..., ::-1] >> pt) << pt)


@pytest.mark.parametrize("hw", [(360, 640), (7, 5), (1, 1)])
def test_chip_smokes_lossless_frame_decodes_to_its_picture(hw, tmp_path):
    """``chip_smoke.lossless_frame`` (phase 22b's writer, numpy only: the
    card's machine has no JPEG encoder) writes a file that cv2 and both of
    the port's loaders decode to the picture it was given."""
    import chip_smoke
    im = mk.scene(*hw, 11)
    path = str(tmp_path / "f.jpg")
    chip_smoke.lossless_frame(path, im)
    assert sof_marker(open(path, "rb").read()) == 0xC3
    np.testing.assert_array_equal(held(path, jax_equal=False), im)


def test_lossless_colour_space_follows_libjpeg(tmp_path):
    """Without a JFIF marker any ids read as RGB; an Adobe transform of 0
    too; a JFIF marker or another transform make the file YCbCr, which cv2
    refuses and the port with it."""
    im = mk.scene(11, 13, 5)
    for kw, ok in ((dict(ids=(82, 71, 66)), True), (dict(ids=(4, 5, 6)), True),
                   (dict(adobe=0), True), (dict(adobe=1), False),
                   (dict(jfif=True), False), (dict(jfif=True, adobe=0),
                                              False)):
        path = write(tmp_path, "c.jpg", mk.jpeg_lossless(im, **kw))
        if ok:
            np.testing.assert_array_equal(held(path, jax_equal=False),
                                          im[..., ::-1])
            continue
        assert cv2.imread(path, cv2.IMREAD_COLOR) is None
        with pytest.raises(UNSUPPORTED, match="YCbCr"):
            image_io.imread_bgr(path)


# -- corrupt data -------------------------------------------------------------

def _patch(data: bytes, at: int, value: int) -> bytes:
    out = bytearray(data)
    out[at] = value
    return bytes(out)


def _dac_at(data: bytes) -> int:
    return data.index(b"\xff\xcc")


def _corrupt_cases():
    rst = arith_file((41, 59), "420", restart=1, seed=3)
    r0, r1 = rst.index(b"\xff\xd0"), rst.index(b"\xff\xd1")
    seq = arith_file((37, 53), "444", seed=4)
    dac = _dac_at(seq)
    lossless_rst = mk.jpeg_lossless(mk.scene(13, 9, 6), 1, restart_rows=2)
    dri = lossless_rst.index(b"\xff\xdd")
    lossless = mk.jpeg_lossless(mk.scene(13, 9, 7), 3,
                                scans=((0,), (1,), (2,)))
    sos = mk.scan_offsets(lossless)
    return {
        "arithmetic restart markers swapped": (
            _patch(_patch(rst, r0 + 1, 0xD1), r1 + 1, 0xD0), "restart"),
        "DAC with L above U": (_patch(seq, dac + 5, 0x13), "above U"),
        "DAC table index past 31": (_patch(seq, dac + 4, 0x20), "index"),
        "lossless restart of part of a row": (
            _patch(lossless_rst, dri + 5, 17), "whole number of rows"),
        "lossless predictor 0": (
            _patch(lossless, sos[0] + 7, 0), "lossless scan parameters"),
        "lossless predictor 8": (
            _patch(lossless, sos[0] + 7, 8), "lossless scan parameters"),
        "lossless point transform 8": (
            _patch(lossless, sos[0] + 9, 8), "lossless scan parameters"),
        "lossless component never coded": (
            lossless[:sos[2]] + b"\xff\xd9", "before a scan codes"),
        "lossless scan out of the frame's order": (
            mk.jpeg_lossless(mk.scene(13, 9, 8), 2, scans=((1,), (2, 0))),
            "out of the frame's order"),
    }


@pytest.mark.parametrize("what", sorted(_corrupt_cases()))
def test_corrupt_modes_raise(what, tmp_path):
    """Data libjpeg rejects, or decodes only with a warning, raises
    ``ValueError`` (not ``UnsupportedImageError``) on both loaders; cv2
    decodes nothing of the first five."""
    data, match = _corrupt_cases()[what]
    path = write(tmp_path, "bad.jpg", data)
    if what != "lossless component never coded" and "swapped" not in what:
        assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    for read in (image_io.imread_bgr, runtime.decode_image):
        with pytest.raises(ValueError, match=match) as e:
            read(path)
        assert not isinstance(e.value, UNSUPPORTED)


TRUNCATE = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from tests import make_decode_fixtures as mk
from i2vsgg_tpu_torch.data import jpeg

data = open(sys.argv[2], "rb").read()
[at] = mk.scan_offsets(data)
start = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
whole = jpeg.decode_jpeg(data)
counts = {"raised": 0, "decoded": 0}
for n in range(2, len(data) - 1):
    try:
        got = jpeg.decode_jpeg(data[:n])
    except ValueError:
        counts["raised"] += 1
        continue
    # only the bytes of the coder's flush that it never reads, and EOI,
    # may go
    assert n > len(data) - 6 and np.array_equal(got, whole), n
    counts["decoded"] += 1
print(json.dumps(counts))
"""


def _run(script, *argv):
    proc = subprocess.run([sys.executable, "-c", script, ROOT, *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["seq_420_rst1_41x59", "seq_grey_37x53"])
def test_truncated_arithmetic_files_raise(case, tmp_path):
    """Every cut of a sequential arithmetic-coded file, in a subprocess: a
    cut inside its entropy-coded data raises ``ValueError`` (the coder
    reaches the end of the data, where libjpeg warns); only the last bytes
    may go and leave the picture whole."""
    path = write(tmp_path, "a.jpg", arith_file(**ARITH_CASES[case]))
    counts = _run(TRUNCATE, path)
    assert counts["raised"] > 0, counts


FUZZ = """
import json, resource, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from tests import make_decode_fixtures as mk
from i2vsgg_tpu_torch.data import jpeg

jpeg.library()
# an allocation of two gigabytes fails from here on
vm = int(open("/proc/self/statm").read().split()[0]) * resource.getpagesize()
hard = resource.getrlimit(resource.RLIMIT_AS)[1]
resource.setrlimit(resource.RLIMIT_AS, (vm + (2 << 30), hard))
rs = np.random.RandomState(int(sys.argv[2]))
counts = {"decoded": 0, "corrupt": 0}
sources = [mk.libjpeg_encode(mk.scene(41, 57, 1)[..., ::-1], "ycc", 80,
                             sampling=((2, 2), (1, 1), (1, 1))),
           mk.libjpeg_encode(mk.scene(33, 47, 2)[..., ::-1], "ycc", 90,
                             progressive=True, restart=2),
           mk.libjpeg_encode(mk.scene(29, 35, 3)[..., 0], "grey", 75,
                             progressive=True, dac=(1, 5, 20)),
           mk.jpeg_lossless(mk.scene(17, 23, 4), 5, restart_rows=3)]
for src in sources:
    shape = jpeg.decode_jpeg(src).shape
    first = mk.scan_offsets(src)[0] + 4
    for it in range(60):
        d = bytearray(src)
        kind = it % 3
        # the entropy-coded data and the scan headers only: a frame header
        # may claim any size, and arithmetic-coded data has no length bound
        span = (first, len(d) - 2)
        if kind == 0:
            for _ in range(rs.randint(1, 6)):
                d[rs.randint(*span)] = rs.randint(256)
        elif kind == 1:
            for _ in range(rs.randint(1, 6)):
                d[rs.randint(*span)] ^= 1 << rs.randint(8)
        else:
            p = rs.randint(*span)
            d[p:p] = rs.randint(0, 256, rs.randint(1, 16)).astype(
                np.uint8).tobytes()
        try:
            out = jpeg.decode_jpeg(bytes(d))
        except jpeg.UnsupportedImageError as e:
            raise AssertionError(f"{it}: {e}")
        except ValueError:
            counts["corrupt"] += 1
            continue
        assert out.dtype == np.uint8 and out.shape == shape, it
        counts["decoded"] += 1
print(json.dumps(counts))
"""


def test_mutated_arithmetic_and_lossless_files_decode_or_raise():
    """240 seeded mutations (bytes set, bits flipped, bytes inserted) of the
    scans of three arithmetic-coded files (sequential 4:2:0, progressive
    with restarts, progressive grey with DAC conditioning) and a lossless
    file, in a fresh interpreter held below two gigabytes more than it has
    after its imports: each decodes to the frame's shape or raises
    ``ValueError``; a crash is a non-zero exit. (Where corrupt data parses,
    its coefficients may leave the range in which the C IDCT and cv2's
    SIMD IDCT agree: ROADMAP C.)"""
    counts = _run(FUZZ, "0")
    assert sum(counts.values()) == 240
    assert counts["decoded"] > 0 and counts["corrupt"] > 0, counts
