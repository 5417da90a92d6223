"""The port's native batch loader (``i2vsgg_tpu_torch/runtime``:
``csrc/io_runtime.cc`` linked with ``csrc/jpeg.cc``) against the JAX
package's runtime (``i2vsgg_tpu/runtime``, libjpeg and libpng) and against
the port's Python path, on the CPU:

* ``decode_image``: bit-equal to JAX's on every committed JPEG fixture that
  both decode, EXIF orientations 2-8 and a progressive file included
  (neither runtime applies the orientation; applied afterwards, the port's
  ``imread_bgr``); CMYK fails in JAX's (libjpeg asked for RGB) and equals
  its golden in the port's.
* PNG: colour types 0, 2, 3, 4 and 6, written by cv2, by PIL and by
  ``write_png`` with each row filter, at zlib levels 0, 1, 6 and 9, at 1x1
  and odd widths: bit-equal to JAX's decode and to ``data/image_io.py``'s
  ``decode_png``; 16-bit and Adam7-interlaced PNG too (every depth and
  colour type: ``test_torch_decode_formats.py``); a bad CRC, a bad Adler-32 and a truncated IDAT raise; seeded mutations of
  the zlib stream decode as ``decode_png`` decodes them or raise (in a
  subprocess, so that a crash fails the test and not the worker).
* The inflate against ``zlib.decompress`` on seeded data under each of
  zlib's strategies and two window sizes (through a grey PNG that carries
  the data as its rows).
* ``load_batch``: ``assert_array_equal`` to JAX's (images, scales, hw) on
  mixed PNG and JPEG input, with flips, with a pad smaller than the resized
  image, at 1 and 8 threads; within 1e-3 of the port's ``prep_image``.
* ``pack_planes``: byte-equal to JAX's and to the torch packer.
* The library's name hashes both sources; a missing file raises naming it.
"""

import ctypes
import json
import os
import shutil
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from i2vsgg_tpu import runtime as jax_runtime
from i2vsgg_tpu.ops.pallas import conv1_kernel as jax_conv1

from i2vsgg_tpu_torch import runtime
from i2vsgg_tpu_torch.data import image_io, jpeg
from i2vsgg_tpu_torch.data.pipeline import prep_image
from i2vsgg_tpu_torch.ops import conv1
from i2vsgg_tpu_torch.utils import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
MANIFEST = json.load(open(os.path.join(FIXTURES, "MANIFEST.json")))
MEANS = (102.9801, 115.9465, 122.7717)
UNSUPPORTED = image_io.UnsupportedImageError


def picture(h, w, seed):
    """A smooth gradient with noise: BGR uint8."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    im = np.stack([x * 200.0 / max(w, 1), y * 200.0 / max(h, 1),
                   (x + y) % 97 * 2.0], -1)
    return np.clip(im + rs.randn(h, w, 3) * 9, 0, 255).astype(np.uint8)


def chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def png_bytes(raw: bytes, w: int, h: int, ctype: int, depth: int = 8,
              interlace: int = 0, extra=()) -> bytes:
    """A PNG of the zlib stream ``raw`` (IDAT split in two chunks)."""
    half = len(raw) // 2
    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + b"".join(extra) + chunk(b"IDAT", raw[:half])
            + chunk(b"IDAT", raw[half:]) + chunk(b"IEND", b""))


def idat_stream(path) -> bytes:
    data = open(path, "rb").read()
    return b"".join(body for t, body in image_io._png_chunks(data, path)
                    if t == b"IDAT")


def recompressed(src, dst, level):
    """``src`` with its image data inflated and deflated again at zlib
    ``level``, its other chunks as they were."""
    data = open(src, "rb").read()
    raw = zlib.compress(zlib.decompress(idat_stream(src)), level)
    out, done = [image_io.PNG_SIGNATURE], False
    for ctype, body in image_io._png_chunks(data, src):
        if ctype == b"IDAT":
            if not done:
                out.append(chunk(b"IDAT", raw))
                done = True
        else:
            out.append(chunk(ctype, body))
    open(dst, "wb").write(b"".join(out))


def write_cases(d, kind, level):
    """PNGs of one writer at one zlib level, at 1x1, an odd width and a
    larger odd size; returns their paths."""
    paths = []
    for h, w in ((1, 1), (5, 7), (29, 41)):
        bgr = picture(h, w, h * 100 + w)
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        base = os.path.join(d, f"{kind}_{h}x{w}")
        src = base + "_src.png"
        if kind == "cv2_rgb":
            cv2.imwrite(src, bgr)
        elif kind == "cv2_grey":
            cv2.imwrite(src, bgr[..., 1])
        elif kind == "cv2_rgba":
            cv2.imwrite(src, np.dstack([bgr, bgr[..., 0]]))
        elif kind == "pil_rgb":
            Image.fromarray(rgb).save(src)
        elif kind == "pil_grey":
            Image.fromarray(bgr[..., 1]).save(src)
        elif kind == "pil_grey_alpha":
            Image.fromarray(bgr[..., 1]).convert("LA").save(src)
        elif kind == "pil_rgba":
            Image.fromarray(np.dstack([rgb, bgr[..., 2]]), "RGBA").save(src)
        elif kind == "pil_palette":      # a full palette: 8-bit indices
            im = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                              colors=37)
            pal = im.getpalette()
            im.putpalette(pal + [0] * (768 - len(pal)))
            im.save(src)
        else:
            image_io.write_png(src, bgr, int(kind[-1]))
        path = base + ".png"
        recompressed(src, path, level)
        paths.append(path)
    return paths


WRITERS = ("cv2_rgb", "cv2_grey", "cv2_rgba", "pil_rgb", "pil_grey",
           "pil_grey_alpha", "pil_rgba", "pil_palette", "filter0", "filter1",
           "filter2", "filter3", "filter4")
COLOUR_TYPE = {"cv2_rgb": 2, "cv2_grey": 0, "cv2_rgba": 6, "pil_rgb": 2,
               "pil_grey": 0, "pil_grey_alpha": 4, "pil_rgba": 6,
               "pil_palette": 3}


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("kind", WRITERS)
def test_png_decode_equals_jax_and_decode_png(kind, level, tmp_path):
    for path in write_cases(str(tmp_path), kind, level):
        data = open(path, "rb").read()
        assert data[25] == COLOUR_TYPE.get(kind, 2), path
        got = runtime.decode_image(path)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, jax_runtime.decode_image(path))
        np.testing.assert_array_equal(got, image_io.decode_png(data, path))
        np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))


def test_png_goldens_of_the_jpeg_fixtures():
    """The fixtures' goldens: PNGs that cv2 wrote, up to 1024x768."""
    for name, entry in sorted(MANIFEST.items()):
        if entry["set"] == "refused":
            continue
        path = os.path.join(FIXTURES, entry["golden"])
        got = runtime.decode_image(path)
        assert list(got.shape) == entry["shape"]
        np.testing.assert_array_equal(got, jax_runtime.decode_image(path))
        np.testing.assert_array_equal(got, image_io.imread_bgr(path))


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_jpeg_decode_equals_jax(name):
    """Bit-equal to JAX's runtime on what both decode, EXIF orientations
    unapplied in both (applied afterwards: the port's ``imread_bgr``), the
    progressive fixture included; CMYK fails in JAX's (libjpeg cannot give
    it as RGB) and equals its golden (cv2's decode) in the port's."""
    path = os.path.join(FIXTURES, name + ".jpg")
    if MANIFEST[name].get("mode") == "four components":
        with pytest.raises(Exception):
            jax_runtime.decode_image(path)
        np.testing.assert_array_equal(
            runtime.decode_image(path),
            image_io.imread_bgr(os.path.join(FIXTURES,
                                             MANIFEST[name]["golden"])))
        return
    if MANIFEST[name]["set"] == "refused":
        mode = MANIFEST[name]["mode"]
        with pytest.raises(UNSUPPORTED, match=mode) as e:
            runtime.decode_image(path)
        assert path in str(e.value)
        if mode == "progressive":
            assert jax_runtime.decode_image(path).shape == (37, 53, 3)
        else:
            with pytest.raises(Exception):
                jax_runtime.decode_image(path)
        return
    got = runtime.decode_image(path)
    np.testing.assert_array_equal(got, jax_runtime.decode_image(path))
    orientation = jpeg.exif_orientation(open(path, "rb").read())
    assert (orientation != 1) == (name[:4] == "exif" and name != "exif1_24x40")
    np.testing.assert_array_equal(jpeg.orient(got, orientation),
                                  image_io.imread_bgr(path))


def adam7_png(path, bgr):
    """An 8-bit RGB PNG with Adam7 interlacing (each pass's rows unfiltered),
    which libpng decodes."""
    h, w = bgr.shape[:2]
    rgb = bgr[..., ::-1]
    raw = []
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = rgb[y0::dy, x0::dx]
        for row in sub if sub.shape[1] else ():
            raw.append(b"\0" + row.tobytes())
    open(path, "wb").write(png_bytes(zlib.compress(b"".join(raw)), w, h, 2,
                                     interlace=1))


def test_sixteen_bit_and_interlaced_png_raise_where_jax_decodes(tmp_path):
    """16-bit and Adam7 PNG, refused before the port read them, decode as
    JAX's runtime decodes them: 16 bits cut to the high byte, the passes
    scattered; ``load_batch`` as on the 8-bit picture they hold."""
    bgr = picture(11, 13, 3)
    p16 = str(tmp_path / "deep.png")
    cv2.imwrite(p16, bgr.astype(np.uint16) * 256 + 128)
    assert open(p16, "rb").read()[24] == 16
    np.testing.assert_array_equal(jax_runtime.decode_image(p16), bgr)
    np.testing.assert_array_equal(runtime.decode_image(p16), bgr)
    pint = str(tmp_path / "adam7.png")
    adam7_png(pint, bgr)
    np.testing.assert_array_equal(jax_runtime.decode_image(pint), bgr)
    np.testing.assert_array_equal(runtime.decode_image(pint), bgr)
    p8 = str(tmp_path / "plain.png")
    image_io.write_png(p8, bgr)
    want = runtime.load_batch([p8], [False], MEANS, 16, 32, 32)
    for path in (p16, pint):
        got = runtime.load_batch([path], [False], MEANS, 16, 32, 32)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_corrupt_png_raises(tmp_path):
    """A bad chunk CRC, a bad Adler-32, a truncated IDAT, a missing IEND,
    a stream longer or shorter than the image: each a ``ValueError``."""
    bgr = picture(9, 14, 4)
    rows = np.concatenate([np.zeros((9, 1), np.uint8),
                           bgr[..., ::-1].reshape(9, -1)], 1).tobytes()
    good = zlib.compress(rows, 6)
    cases = {
        "bad CRC": bytearray(png_bytes(good, 14, 9, 2)),
        "Adler-32": png_bytes(good[:-1] + bytes([good[-1] ^ 1]), 14, 9, 2),
        "truncated": png_bytes(good[:-9], 14, 9, 2),
        "without IEND": png_bytes(good, 14, 9, 2)[:-12],
        "expected": png_bytes(zlib.compress(rows + b"\0" * 43), 14, 9, 2),
        "bytes, 387": png_bytes(zlib.compress(rows[:-3]), 14, 9, 2),
    }
    cases["bad CRC"][40] ^= 0x10               # inside the first IDAT
    path = str(tmp_path / "good.png")
    open(path, "wb").write(png_bytes(good, 14, 9, 2))
    np.testing.assert_array_equal(runtime.decode_image(path), bgr)
    for what, data in cases.items():
        path = str(tmp_path / "bad.png")
        open(path, "wb").write(bytes(data))
        with pytest.raises(ValueError, match=what) as e:
            runtime.decode_image(path)
        assert not isinstance(e.value, UNSUPPORTED), what
        with pytest.raises(Exception):
            image_io.imread_bgr(path)


def seeded_stream_data(seed, n=150_000):
    """Bytes a deflate encoder finds every kind of block and match in:
    random stretches, runs, a small alphabet, and copies of earlier data
    from 1 to 32768 bytes back."""
    rs = np.random.RandomState(seed)
    out = bytearray()
    while len(out) < n:
        kind = rs.randint(4)
        k = int(rs.randint(1, 3000))
        if kind == 0:
            out += rs.randint(0, 256, k).astype(np.uint8).tobytes()
        elif kind == 1:
            out += bytes([rs.randint(256)]) * k
        elif kind == 2:
            out += rs.choice(np.frombuffer(b"scene graph ", np.uint8),
                             k).tobytes()
        elif len(out) > 8:
            d = int(rs.randint(1, min(len(out), 32768) + 1))
            for _ in range(min(k, 258 * 4)):
                out.append(out[-d])
    return bytes(out[:n])


@pytest.mark.parametrize("wbits", [9, 15])
@pytest.mark.parametrize("strategy", ["Z_DEFAULT_STRATEGY", "Z_FILTERED",
                                      "Z_HUFFMAN_ONLY", "Z_RLE", "Z_FIXED"])
def test_inflate_equals_zlib_under_each_strategy(strategy, wbits, tmp_path):
    w, h = 999, 150
    data = bytearray(seeded_stream_data(wbits))
    data[::w + 1] = b"\0" * h                  # each row led by filter 0
    for level in (1, 6, 9):
        enc = zlib.compressobj(level, zlib.DEFLATED, wbits, 9,
                               getattr(zlib, strategy))
        stream = enc.compress(bytes(data)) + enc.flush()
        want = np.frombuffer(zlib.decompress(stream), np.uint8)
        path = str(tmp_path / f"{strategy}_{level}.png")
        open(path, "wb").write(png_bytes(stream, w, h, 0))
        got = runtime.decode_image(path)
        np.testing.assert_array_equal(
            got, np.repeat(want.reshape(h, w + 1)[:, 1:, None], 3, 2))


MUTATE = """
import json, sys, zlib
import numpy as np
sys.path.insert(0, sys.argv[1])
from tests.test_torch_runtime import png_bytes, picture
from i2vsgg_tpu_torch import runtime
from i2vsgg_tpu_torch.data import image_io
rs = np.random.RandomState(0)
counts = {"equal": 0, "raised": 0}
for ctype, bpp in ((2, 3), (0, 1), (6, 4)):
    bgr = picture(13, 17, ctype)
    px = {2: bgr[..., ::-1], 0: bgr[..., :1],
          6: np.dstack([bgr[..., ::-1], bgr[..., :1]])}[ctype]
    filt = rs.randint(0, 5, (13, 1)).astype(np.uint8)
    rows = np.concatenate([filt, px.reshape(13, -1)], 1).tobytes()
    for level in (0, 1, 9):
        good = zlib.compress(rows, level)
        for _ in range(40):
            s = bytearray(good)
            for _ in range(rs.randint(1, 4)):
                i = rs.randint(len(s))
                s[i] = rs.randint(256) if rs.rand() < 0.5 else s[i] ^ (
                    1 << rs.randint(8))
            data = png_bytes(bytes(s), 17, 13, ctype)
            path = sys.argv[2]
            open(path, "wb").write(data)
            try:
                want = image_io.decode_png(data, path)
            except Exception:
                want = None
            try:
                got = runtime.decode_image(path)
            except ValueError:
                got = None
            assert (got is None) == (want is None), (ctype, level)
            if got is None:
                counts["raised"] += 1
            else:
                assert np.array_equal(got, want), (ctype, level)
                counts["equal"] += 1
print(json.dumps(counts))
"""


def test_mutated_streams_decode_as_python_or_raise(tmp_path):
    """360 seeded mutations of zlib streams (stored, fixed and dynamic
    blocks) under valid chunk CRCs, in a fresh interpreter: each decodes
    to what ``decode_png`` decodes (a mutation the Adler-32 cannot see
    leaves the image as it was) or raises ``ValueError`` where
    ``decode_png`` raises; a crash is a non-zero exit."""
    proc = subprocess.run(
        [sys.executable, "-c", MUTATE, ROOT, str(tmp_path / "m.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sum(counts.values()) == 360 and counts["raised"] > 300, counts


@pytest.fixture(scope="module")
def batch_files(tmp_path_factory):
    """PNG frames (odd sizes), JPEG stills (landscape and portrait) and a
    committed fixture; none resizes to a whole number of columns at the
    tests' scale 48 but the third."""
    d = tmp_path_factory.mktemp("batch")
    paths = []
    for i, (h, w) in enumerate(((45, 80), (37, 61), (60, 60))):
        p = str(d / f"frame{i}.png")
        image_io.write_png(p, picture(h, w, i), i % 5)
        paths.append(p)
    for i, (h, w) in enumerate(((48, 70), (71, 50))):
        p = str(d / f"still{i}.jpg")
        cv2.imwrite(p, picture(h, w, 10 + i), [cv2.IMWRITE_JPEG_QUALITY, 85])
        paths.append(p)
    paths.append(os.path.join(FIXTURES, "s420_q90_37x53.jpg"))
    return paths


@pytest.mark.parametrize("n_threads", [1, 8])
@pytest.mark.parametrize("pad", [(112, 176), (40, 48)],
                         ids=["fits", "smaller_than_resized"])
def test_load_batch_equals_jax(batch_files, pad, n_threads):
    """Images, scales and sizes bit-equal to JAX's runtime and to the plain
    version, with flips, also where the pad is smaller than the resized
    image (squashed into it, not cropped); 1 and 8 threads alike."""
    flips = [i % 2 == 1 for i in range(len(batch_files))]
    got = runtime.load_batch(batch_files, flips, MEANS, 48, *pad,
                             n_threads=n_threads)
    exp = jax_runtime.load_batch(batch_files, flips, MEANS, 48, *pad,
                                 n_threads=n_threads)
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    one = runtime.load_batch(batch_files, flips, MEANS, 48, *pad,
                             n_threads=1)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)
    for i, path in enumerate(batch_files):
        im, scale, hw = runtime.preprocess_plain(
            runtime.decode_image(path), flips[i], MEANS, 48, *pad)
        np.testing.assert_array_equal(got[0][i], im)
        assert got[1][i] == scale and tuple(got[2][i]) == tuple(hw)


@pytest.fixture(scope="module")
def whole_ratio_files(tmp_path_factory):
    """Images whose sides scale to whole numbers at 48 (0.8, 0.8, 0.4), as
    in the JAX package's own test of its two paths."""
    d = tmp_path_factory.mktemp("whole")
    paths = [str(d / "a.png"), str(d / "b.jpg"), str(d / "c.png")]
    image_io.write_png(paths[0], picture(60, 80, 1), 4)
    cv2.imwrite(paths[1], picture(80, 60, 2), [cv2.IMWRITE_JPEG_QUALITY, 90])
    image_io.write_png(paths[2], picture(120, 160, 3), 1)
    return paths


def python_path(path, flip, target):
    im = image_io.imread_bgr(path)
    return prep_image(im[:, ::-1] if flip else im, target, MEANS)


def test_load_batch_within_the_python_path(whole_ratio_files):
    """Within 1e-3 of ``imread_bgr`` + ``prep_image`` (the JAX package's
    bound between its two paths, at sizes like those of its test), sizes
    and scales equal, padding zero."""
    flips = [False, True, False]
    images, scales, hw = runtime.load_batch(whole_ratio_files, flips, MEANS,
                                            48, 112, 176)
    for i, path in enumerate(whole_ratio_files):
        ref, scale = python_path(path, flips[i], 48)
        rh, rw = ref.shape[:2]
        assert scales[i] == np.float32(scale)
        assert tuple(hw[i]) == (rh, rw)
        np.testing.assert_allclose(images[i, :rh, :rw], ref, rtol=0,
                                   atol=1e-3, err_msg=path)
        assert not images[i, rh:].any() and not images[i, :, rw:].any()


def test_load_batch_off_the_python_path_as_jax_is(batch_files):
    """Where a side does not scale to a whole number of pixels, the JAX
    runtime's source map (``w / rw`` a step) leaves cv2's (``1 / scale``):
    the native batch departs from the Python path by the same amount in
    both packages (a fraction of a pixel, tens of grey levels on edges),
    while sizes and scales stay equal."""
    got, scales, hw = runtime.load_batch(batch_files[:2], [False, True],
                                         MEANS, 48, 112, 176)
    exp = jax_runtime.load_batch(batch_files[:2], [False, True], MEANS, 48,
                                 112, 176)[0]
    from i2vsgg_tpu.data.pipeline import imread_bgr as jax_imread
    from i2vsgg_tpu.data.pipeline import prep_image as jax_prep
    for i, path in enumerate(batch_files[:2]):
        ref, scale = python_path(path, i == 1, 48)
        im = jax_imread(path)
        jref, _ = jax_prep(im[:, ::-1] if i == 1 else im, 48, MEANS)
        rh, rw = ref.shape[:2]
        assert scales[i] == np.float32(scale) and tuple(hw[i]) == (rh, rw)
        gap = np.abs(got[i, :rh, :rw] - ref).max()
        jax_gap = np.abs(exp[i, :rh, :rw] - jref).max()
        assert gap > 1.0 and abs(gap - jax_gap) < 1e-3, (gap, jax_gap)


@pytest.mark.parametrize("shape", [(1, 64, 96), (2, 50, 70), (1, 47, 131),
                                   (3, 33, 40)])
def test_pack_planes_equals_jax_and_the_torch_packer(shape):
    rs = np.random.RandomState(8)
    x = (rs.randn(*shape, 3) * 25).astype(np.float32)
    g = conv1.conv1_plane_geometry(*shape[1:])
    got = runtime.pack_planes(x, g.hq, g.wq)
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    assert tuple(got.shape) == (shape[0], 2, 2, 3, g.hq, g.wq)
    bits = got.view(torch.int16).numpy().view(np.uint16)
    exp = jax_runtime.pack_planes(x, g.hq, g.wq)
    np.testing.assert_array_equal(bits, exp.view(np.uint16))
    np.testing.assert_array_equal(
        bits, jax_conv1.pack_conv1_planes_np(x, native=False).view(np.uint16))
    plain = conv1.pack_conv1_planes_np(x, native=False)
    assert torch.equal(plain.view(torch.int16), got.view(torch.int16))
    assert torch.equal(conv1.pack_conv1_planes_np(x).view(torch.int16),
                       got.view(torch.int16))


def test_pack_planes_writes_every_element():
    """The packer writes the zeros outside the image too, so the memory it
    is handed need not be cleared (``pack_planes`` hands it uninitialised
    memory)."""
    x = (np.random.RandomState(9).randn(2, 37, 53, 3) * 30).astype(np.float32)
    g = conv1.conv1_plane_geometry(37, 53)
    out = np.full((2, 2, 2, 3, g.hq, g.wq), 0xFFFF, np.uint16)
    runtime.library().i2v_pack_planes(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 2, 37, 53, g.hq,
        g.wq, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 3)
    plain = conv1.pack_conv1_planes_np(x, native=False)
    np.testing.assert_array_equal(
        out, plain.view(torch.int16).numpy().view(np.uint16))


def test_native_io_off_takes_the_torch_packer(monkeypatch):
    """``I2VSGG_NATIVE_IO=0`` reaches the packer as it reaches the loader:
    ``pack_conv1_planes_np`` then never calls the runtime."""
    x = np.random.RandomState(10).randn(1, 20, 30, 3).astype(np.float32)
    want = conv1.pack_conv1_planes_np(x, native=False)

    def refused(*a, **k):
        raise AssertionError("the runtime's packer was called")

    monkeypatch.setattr(runtime, "pack_planes", refused)
    monkeypatch.setenv("I2VSGG_NATIVE_IO", "0")
    assert torch.equal(conv1.pack_conv1_planes_np(x).view(torch.int16),
                       want.view(torch.int16))
    monkeypatch.setenv("I2VSGG_NATIVE_IO", "1")
    with pytest.raises(AssertionError, match="packer was called"):
        conv1.pack_conv1_planes_np(x)


def test_missing_and_unreadable_files_raise_naming_them(batch_files,
                                                        tmp_path):
    missing = str(tmp_path / "missing.png")
    with pytest.raises(FileNotFoundError, match="missing.png"):
        runtime.decode_image(missing)
    with pytest.raises(FileNotFoundError, match="missing.png") as e:
        runtime.load_batch(batch_files[:2] + [missing], [False] * 3, MEANS,
                           48, 112, 176)
    assert batch_files[0] not in str(e.value)
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(UNSUPPORTED, match="x.bmp: not a PNG or JPEG"):
        runtime.load_batch([bmp], [False], MEANS, 48, 112, 176)
    tiny = str(tmp_path / "tiny.png")
    image_io.write_png(tiny, np.zeros((1, 5, 3), np.uint8))
    with pytest.raises(ValueError, match="tiny.png.*at least 2 x 2"):
        runtime.load_batch([tiny], [False], MEANS, 48, 112, 176)
    with pytest.raises(RuntimeError):        # JAX's too
        jax_runtime.load_batch([tiny], [False], MEANS, 48, 112, 176)


def test_library_name_hashes_both_sources(tmp_path, monkeypatch):
    """The runtime's library is named by a hash of io_runtime.cc AND the
    jpeg.cc linked into it: an edit to either rebuilds it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for s in runtime.SOURCES:
        shutil.copy(cuda_build.CSRC_DIR / s, csrc / s)
    cxx = cuda_build.find_cxx()
    real = cuda_build.library_path(runtime.SOURCES, cuda_build.HOST_FLAGS, cxx)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    first = cuda_build.library_path(runtime.SOURCES, cuda_build.HOST_FLAGS, cxx)
    assert first == real and first.name.startswith("io_runtime_")
    names = {first}
    for s in runtime.SOURCES:
        with open(csrc / s, "a") as fh:
            fh.write("// edited\n")
        names.add(cuda_build.library_path(runtime.SOURCES,
                                          cuda_build.HOST_FLAGS, cxx))
    assert len(names) == 3
    assert cuda_build.library_path(runtime.SOURCES,
                                   cuda_build.HOST_FLAGS[:-1],
                                   cxx) not in names
