"""The port's JPEG decoder (``csrc/jpeg.cc`` through ``data/jpeg.py``)
against ``cv2.imread(path, cv2.IMREAD_COLOR)`` on the CPU, byte for byte.

* A matrix of JPEGs that cv2 and PIL write here: every chroma sampling the
  decoder reads (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1) at sizes from 1x1 up,
  grey, qualities 50-100, restart intervals, optimized Huffman tables, PIL's
  encoder, an Adobe RGB file, a file without DHT (Annex K's tables), 16-bit
  quantization tables (SOF1) and EXIF orientations 1-8.
* The committed fixtures of ``tests/data/jpeg`` (``make_jpeg_fixtures.py``):
  each golden equals cv2 here, and the port equals each golden.
* The refused modes raise ``UnsupportedImageError`` naming the mode:
  lossless arithmetic coding (SOF11), subsampled lossless, 12-bit samples
  (each made by patching a baseline file's header). The modes refused
  before the port read them, progressive (written by cv2), colour
  components in separate scans (``make_decode_fixtures.
  jpeg_separate_scans``) and CMYK (PIL), decode as cv2 decodes them (more
  in ``test_torch_decode_formats.py`` and ``test_torch_decode_modes.py``).
* Truncated files raise ``ValueError`` and seeded byte mutations decode or
  raise it, in a subprocess, so that a crash fails the test and not the
  worker.
* ``utils/cuda_build.py::build_host``: the library is keyed by source,
  flags and compiler, and a failed build raises with the compiler's output.
"""

import io
import json
import os
import subprocess
import sys
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

from i2vsgg_tpu_torch.data import image_io, jpeg
from i2vsgg_tpu_torch.utils import cuda_build
from tests.make_decode_fixtures import jpeg_separate_scans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
MANIFEST = json.load(open(os.path.join(FIXTURES, "MANIFEST.json")))
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}


def picture(h, w, seed):
    """Gradients, a few filled discs and Gaussian noise: BGR uint8."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    im = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                   128 * (x + y) / max(h + w - 2, 1)], -1)
    for _ in range(3):
        r = rs.randint(1, max(2, min(h, w) // 2))
        im[(y - rs.randint(h)) ** 2 + (x - rs.randint(w)) ** 2 < r ** 2] = \
            rs.randint(0, 256, 3)
    im += rs.randn(h, w, 3) * 6
    return np.clip(im, 0, 255).astype(np.uint8)


def cv2_writer(*params, grey=False):
    def write(path, im):
        assert cv2.imwrite(path, im[..., 1] if grey else im, list(params))
    return write


def pil_writer(grey=False, **kw):
    def write(path, im):
        src = im[..., 1] if grey else np.ascontiguousarray(im[..., ::-1])
        Image.fromarray(src).save(path, "JPEG", **kw)
    return write


def exif_writer(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    return pil_writer(quality=80, exif=exif)


def dht_stripped(path, im):
    data = cv2.imencode(".jpg", im)[1].tobytes()
    out, pos = bytearray(data[:2]), 2
    while True:
        marker, n = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4],
                                                  "big")
        if marker != 0xC4:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
        if marker == 0xDA:
            break
    open(path, "wb").write(bytes(out + data[pos:]))


CASES = {}
for i, (_name, _code) in enumerate(SAMPLING.items()):
    for j, _hw in enumerate(((1, 1), (7, 5), (16, 16), (37, 53), (64, 97))):
        _q = (50, 75, 90, 95, 100)[(i + j) % 5]
        CASES[f"s{_name}_{_hw[0]}x{_hw[1]}_q{_q}"] = (_hw, cv2_writer(
            cv2.IMWRITE_JPEG_QUALITY, _q,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _code))
for _hw in ((1, 1), (9, 17), (45, 61)):
    CASES[f"grey_cv2_{_hw[0]}x{_hw[1]}"] = (_hw, cv2_writer(grey=True))
CASES["grey_pil_33x41"] = ((33, 41), pil_writer(grey=True, quality=90))
for _rst in (1, 3, 64):
    CASES[f"restart_{_rst}"] = ((49, 67), cv2_writer(
        cv2.IMWRITE_JPEG_RST_INTERVAL, _rst))
CASES["restart_3_optimized"] = ((49, 67), cv2_writer(
    cv2.IMWRITE_JPEG_RST_INTERVAL, 3, cv2.IMWRITE_JPEG_OPTIMIZE, 1))
CASES["optimized_444"] = ((40, 56), cv2_writer(
    cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
    SAMPLING["444"]))
CASES["optimized_420"] = ((40, 56), cv2_writer(cv2.IMWRITE_JPEG_OPTIMIZE, 1))
for _sub, _q in ((0, 60), (1, 95), (2, 75)):
    CASES[f"pil_subsampling{_sub}_q{_q}"] = ((39, 51), pil_writer(
        quality=_q, subsampling=_sub))
CASES["pil_optimized"] = ((39, 51), pil_writer(quality=85, optimize=True))
CASES["adobe_rgb"] = ((39, 51), pil_writer(quality=85, keep_rgb=True))
CASES["no_dht"] = ((33, 41), dht_stripped)
CASES["quant_16bit_sof1"] = ((24, 40), pil_writer(qtables=[
    list(range(200, 264)), list(range(300, 364))]))
for _o in range(1, 9):
    CASES[f"exif_orientation_{_o}"] = ((24, 40), exif_writer(_o))


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_cv2(case, tmp_path):
    (h, w), write = CASES[case]
    path = str(tmp_path / (case + ".jpg"))
    write(path, picture(h, w, sum(map(ord, case))))
    exp = cv2.imread(path, cv2.IMREAD_COLOR)
    got = image_io.imread_bgr(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    assert got.shape == exp.shape
    assert np.array_equal(got, exp)


def test_the_matrix_covers_what_it_claims(tmp_path):
    """The written files carry the modes the matrix names: each sampling,
    restart markers, the Adobe marker, SOF1 with 16-bit tables, no DHT."""
    def bytes_of(case):
        path = str(tmp_path / "f.jpg")
        CASES[case][1](path, picture(*CASES[case][0], 0))
        return open(path, "rb").read()

    for name, code in SAMPLING.items():
        data = bytes_of(next(k for k in CASES
                             if k.startswith(f"s{name}_37x53_")))
        sof = data.index(b"\xff\xc0")
        assert data[sof + 11] == code >> 16          # luma h << 4 | v
    assert b"\xff\xd0" in bytes_of("restart_3")
    assert b"Adobe" in bytes_of("adobe_rgb")
    q16 = bytes_of("quant_16bit_sof1")
    assert b"\xff\xc1" in q16 and q16[q16.index(b"\xff\xdb") + 4] >> 4 == 1
    assert b"\xff\xc4" not in bytes_of("no_dht")


def test_exif_rotation_and_the_stored_size(tmp_path):
    """cv2 turns the image by its EXIF orientation; ``image_size`` reads the
    stored size, as PIL reports it to the JAX package's roidb."""
    path = str(tmp_path / "o6.jpg")
    exif_writer(6)(path, picture(40, 64, 0))
    assert image_io.imread_bgr(path).shape == (64, 40, 3)
    with Image.open(path) as im:
        assert image_io.image_size(path) == im.size == (64, 40)


DECODABLE = sorted(k for k, v in MANIFEST.items() if v["set"] != "refused")
# the fixtures made for a mode the decoder refuses, or refused before it
# read the mode
REFUSED = sorted(k for k, v in MANIFEST.items() if "mode" in v)


@pytest.mark.parametrize("name", DECODABLE)
def test_committed_fixture_equals_its_golden(name):
    path = os.path.join(FIXTURES, name + ".jpg")
    golden = image_io.imread_bgr(os.path.join(FIXTURES,
                                              MANIFEST[name]["golden"]))
    assert np.array_equal(golden, cv2.imread(path, cv2.IMREAD_COLOR))
    assert list(golden.shape) == MANIFEST[name]["shape"]
    assert np.array_equal(image_io.imread_bgr(path), golden)


def test_committed_fixtures_cover_the_sets():
    sets = {v["set"] for v in MANIFEST.values()}
    assert sets == {"coverage", "realistic"}
    assert {MANIFEST[k]["mode"] for k in REFUSED} == {"progressive",
                                                      "four components"}
    shapes = {tuple(v["shape"]) for v in MANIFEST.values()
              if v["set"] == "realistic"}
    assert shapes == {(768, 1024, 3), (1024, 768, 3), (360, 640, 3)}
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 1 << 20


@pytest.mark.parametrize("name", REFUSED)
def test_committed_refused_fixture_raises(name):
    """A mode still refused raises naming it; one read since (progressive)
    decodes to its golden, as cv2 decodes it."""
    path = os.path.join(FIXTURES, name + ".jpg")
    if MANIFEST[name]["set"] != "refused":
        golden = image_io.imread_bgr(os.path.join(FIXTURES,
                                                  MANIFEST[name]["golden"]))
        assert np.array_equal(golden, cv2.imread(path, cv2.IMREAD_COLOR))
        assert np.array_equal(image_io.imread_bgr(path), golden)
        return
    with pytest.raises(image_io.UnsupportedImageError,
                       match=MANIFEST[name]["mode"]):
        image_io.imread_bgr(path)


def _baseline(tmp_path, grey=False):
    im = picture(24, 40, 3)
    data = cv2.imencode(".jpg", im[..., 1] if grey else im)[1].tobytes()
    return bytearray(data)


def _patched_sof(marker=None, precision=None):
    def make(tmp_path):
        data = _baseline(tmp_path)
        sof = data.index(b"\xff\xc0")
        if marker is not None:
            data[sof + 1] = marker
        if precision is not None:
            data[sof + 4] = precision
        return bytes(data)
    return make


def _progressive(tmp_path):
    return cv2.imencode(".jpg", picture(24, 40, 4),
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()


def _cmyk(tmp_path):
    b = io.BytesIO()
    Image.fromarray(picture(24, 40, 5)).convert("CMYK").save(b, "JPEG")
    return b.getvalue()


def _separate_scans(tmp_path):
    """A colour file whose components come in three scans, one each."""
    return jpeg_separate_scans(picture(24, 40, 6))


# mode -> (file maker, what the refusal names; None: a mode the decoder
# refused before it read it, which now decodes as cv2 decodes it)
REFUSALS = {
    "progressive": (_progressive, None),
    "arithmetic": (_patched_sof(marker=0xCB), "lossless arithmetic"),
    "lossless": (_patched_sof(marker=0xC3), "subsampled lossless"),
    "12bit": (_patched_sof(precision=12), "12-bit"),
    "cmyk": (_cmyk, None),
    "separate_scans": (_separate_scans, None),
}


@pytest.mark.parametrize("mode", sorted(REFUSALS))
def test_refused_modes_raise_naming_the_mode(mode, tmp_path):
    make, what = REFUSALS[mode]
    path = str(tmp_path / (mode + ".jpg"))
    open(path, "wb").write(make(tmp_path))
    if what is None:
        exp = cv2.imread(path, cv2.IMREAD_COLOR)
        assert exp is not None
        assert np.array_equal(image_io.imread_bgr(path), exp)
        return
    with pytest.raises(image_io.UnsupportedImageError, match=what):
        image_io.imread_bgr(path)


TRUNCATE = """
import sys
from i2vsgg_tpu_torch.data import jpeg

data = open(sys.argv[1], "rb").read()
start = data.index(b"\\xff\\xda")
for n in list(range(0, start + 20, 7)) + list(range(start + 20,
                                                    len(data) - 2)):
    try:
        jpeg.decode_jpeg(data[:n])
    except ValueError:
        continue
    raise SystemExit(f"a cut at {n} of {len(data)} bytes decoded")
print("cuts", len(data) - 2)
"""


def _run(script, *argv):
    """``script`` in a fresh interpreter: a crash fails the test, not the
    worker."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_truncation_raises_and_a_missing_eoi_does_not(tmp_path):
    """Every cut into the entropy-coded data raises ``ValueError`` (in a
    subprocess); a file cut only by its EOI marker decodes as
    ``cv2.imread`` decodes it (libjpeg supplies the marker, with a
    warning)."""
    data = bytes(_baseline(tmp_path))
    full = str(tmp_path / "full.jpg")
    open(full, "wb").write(data)
    assert _run(TRUNCATE, full).startswith("cuts")
    path = str(tmp_path / "no_eoi.jpg")
    open(path, "wb").write(data[:-2])
    exp = cv2.imread(path, cv2.IMREAD_COLOR)
    assert exp is not None
    assert np.array_equal(image_io.imread_bgr(path), exp)
    assert np.array_equal(jpeg.decode_jpeg(data), exp)


FUZZ = """
import json
import sys
import numpy as np
import cv2
from i2vsgg_tpu_torch.data import jpeg

rs = np.random.RandomState(int(sys.argv[1]))
counts = {"decoded": 0, "unsupported": 0, "corrupt": 0}
for params in ([], [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
               [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111]):
    im = np.clip(rs.randn(41, 57, 3) * 40 + 128, 0, 255).astype(np.uint8)
    base = cv2.imencode(".jpg", im, params)[1].tobytes()
    grey = cv2.imencode(".jpg", im[..., 0])[1].tobytes()
    for src in (base, grey):
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


def test_mutated_files_decode_or_raise_without_crashing():
    """360 seeded mutations (bytes set, bits flipped, bytes inserted) of
    colour, restart-interval, 4:1:1 and grey files, in a fresh interpreter:
    each decodes or raises ``ValueError``; a crash is a non-zero exit."""
    counts = json.loads(_run(FUZZ, "0"))
    assert sum(counts.values()) == 360
    assert counts["decoded"] > 0 and counts["corrupt"] > 0, counts


def test_concurrent_decodes_agree():
    """The decoder keeps no state between calls: four threads decoding
    different files at once get what one thread gets."""
    names = [n for n in DECODABLE if MANIFEST[n]["set"] == "coverage"][:8]
    datas = [open(os.path.join(FIXTURES, n + ".jpg"), "rb").read()
             for n in names]
    want = [jpeg.decode_jpeg(d) for d in datas]
    bad = []

    def work(k):
        for _ in range(20):
            for i, d in enumerate(datas[k::4]):
                if not np.array_equal(jpeg.decode_jpeg(d), want[k + 4 * i]):
                    bad.append(k)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


def test_build_host_keys_and_failures(tmp_path, monkeypatch):
    """The library's name hashes the source, the flags and the compiler;
    a source that does not compile raises with the compiler's output (the
    decoder has no fallback)."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    (csrc / "ok.cc").write_text('extern "C" int seven() { return 7; }\n')
    path = cuda_build.build_host("ok.cc")
    assert path.parent == build and path.exists()
    import ctypes
    assert ctypes.CDLL(str(path)).seven() == 7
    cxx = cuda_build.find_cxx()
    assert path == cuda_build.library_path("ok.cc", cuda_build.HOST_FLAGS,
                                           cxx)
    assert cuda_build.library_path("ok.cc", cuda_build.HOST_FLAGS,
                                   cxx + "-other") != path
    assert cuda_build.library_path("ok.cc", ("-O3",), cxx) != path
    (csrc / "ok.cc").write_text('extern "C" int seven() { return 8; }\n')
    assert cuda_build.library_path("ok.cc", cuda_build.HOST_FLAGS,
                                   cxx) != path
    (csrc / "bad.cc").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="bad.cc") as e:
        cuda_build.build_host("bad.cc")
    assert "error" in str(e.value)
    assert not list(build.glob("bad_*"))
