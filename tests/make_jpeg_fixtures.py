"""Write the committed JPEG fixtures of ``tests/data/jpeg/``.

    python tests/make_jpeg_fixtures.py

A script, not a test module: it needs cv2 and PIL, which the machine with
the card lacks, so the JPEGs that ``chip_smoke.py`` checks there come from
the repo. Every image is drawn from a seeded numpy generator (gradients,
filled shapes and mild noise), encoded by cv2 or PIL, and written beside
its golden: ``cv2.imread(path, cv2.IMREAD_COLOR)`` of the file, written with
the port's ``write_png``. ``MANIFEST.json`` lists each file with its set:

* ``coverage``: small files over every chroma sampling the decoder reads,
  grey, odd sizes down to 1x1, qualities 50-100, a restart interval,
  optimized Huffman tables, a file without DHT (the standard tables),
  16-bit quantization tables (SOF1), a PIL-written file, an Adobe RGB file,
  EXIF orientations 1-8, a progressive file and a CMYK file (PIL; each
  entry keeps the ``mode`` the decoder refused it for before it read the
  mode);
* ``realistic``: two VRD-sized stills (1024x768 and 768x1024, 4:2:0 at
  quality 90) and two 360x640 video frames.

Rerunning it rewrites the directory; with the same cv2 and PIL it writes
the same bytes.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jpeg")
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}


def scene(h: int, w: int, seed: int, noise: float = 1.0) -> np.ndarray:
    """A BGR uint8 (h, w, 3) picture: two crossing gradients, a few filled
    discs and boxes, and Gaussian noise of ``noise`` grey levels."""
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


def cv2_jpeg(im: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", im, list(params))
    assert ok
    return buf.tobytes()


def pil_jpeg(im: np.ndarray, **kw) -> bytes:
    rgb = im[..., ::-1] if im.ndim == 3 else im
    b = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb)).save(b, "JPEG", **kw)
    return b.getvalue()


def without_dht(data: bytes) -> bytes:
    """``data`` with its DHT segments removed (cv2 writes the standard
    tables, which a decoder then supplies itself)."""
    out, pos = bytearray(data[:2]), 2
    while True:
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            return bytes(out + data[pos:])


def coverage() -> dict:
    files = {}
    for i, (name, code) in enumerate(SAMPLING.items()):
        q = (50, 75, 90, 95, 100)[i]
        files[f"s{name}_q{q}_37x53"] = cv2_jpeg(
            scene(37, 53, i), cv2.IMWRITE_JPEG_QUALITY, q,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, code)
    files["grey_q80_45x61"] = cv2_jpeg(scene(45, 61, 10)[..., 1],
                                       cv2.IMWRITE_JPEG_QUALITY, 80)
    files["s420_q85_1x1"] = cv2_jpeg(scene(1, 1, 11),
                                     cv2.IMWRITE_JPEG_QUALITY, 85)
    files["s420_q85_7x5"] = cv2_jpeg(scene(7, 5, 12),
                                     cv2.IMWRITE_JPEG_QUALITY, 85)
    files["s422_q60_5x7"] = cv2_jpeg(
        scene(5, 7, 13), cv2.IMWRITE_JPEG_QUALITY, 60,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["422"])
    files["rst3_s420_q85_49x67"] = cv2_jpeg(
        scene(49, 67, 14), cv2.IMWRITE_JPEG_QUALITY, 85,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    files["optimized_s420_q85_49x67"] = cv2_jpeg(
        scene(49, 67, 15), cv2.IMWRITE_JPEG_QUALITY, 85,
        cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    files["no_dht_s420_q70_33x41"] = without_dht(cv2_jpeg(
        scene(33, 41, 16), cv2.IMWRITE_JPEG_QUALITY, 70))
    files["q16bit_sof1_24x40"] = pil_jpeg(
        scene(24, 40, 17), qtables=[list(range(200, 264)),
                                    list(range(300, 364))])
    files["pil_q75_39x51"] = pil_jpeg(scene(39, 51, 18), quality=75)
    files["adobe_rgb_q85_39x51"] = pil_jpeg(scene(39, 51, 19), quality=85,
                                            keep_rgb=True)
    for o in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        files[f"exif{o}_24x40"] = pil_jpeg(scene(24, 40, 20 + o),
                                           quality=80, exif=exif)
    return files


def refused() -> dict:
    """{name: (data, mode)}: the progressive and the CMYK file, refused
    once and now read (``PORTED``)."""
    im = scene(37, 53, 40)
    cmyk = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(im[..., ::-1])).convert(
        "CMYK").save(cmyk, "JPEG", quality=80)
    return {"progressive_37x53": (cv2_jpeg(
                im, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), "progressive"),
            "cmyk_37x53": (cmyk.getvalue(), "four components")}


PORTED = {"progressive_37x53", "cmyk_37x53"}


def realistic() -> dict:
    q90 = (cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
           SAMPLING["420"])
    return {"still_768x1024": cv2_jpeg(scene(768, 1024, 50), *q90),
            "still_1024x768": cv2_jpeg(scene(1024, 768, 51), *q90),
            "frame_360x640_a": cv2_jpeg(scene(360, 640, 52),
                                        cv2.IMWRITE_JPEG_QUALITY, 90),
            "frame_360x640_b": cv2_jpeg(scene(360, 640, 53),
                                        cv2.IMWRITE_JPEG_QUALITY, 90)}


def main() -> int:
    sys.path.insert(0, ROOT)
    from i2vsgg_tpu_torch.data.image_io import write_png
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    manifest = {}
    for kind, files in (("coverage", coverage()), ("realistic", realistic())):
        for name, data in files.items():
            with open(os.path.join(OUT, name + ".jpg"), "wb") as fh:
                fh.write(data)
            golden = cv2.imread(os.path.join(OUT, name + ".jpg"),
                                cv2.IMREAD_COLOR)
            write_png(os.path.join(OUT, name + ".png"), golden, 2)
            manifest[name] = {"set": kind, "golden": name + ".png",
                              "shape": list(golden.shape)}
    for name, (data, mode) in refused().items():
        path = os.path.join(OUT, name + ".jpg")
        with open(path, "wb") as fh:
            fh.write(data)
        manifest[name] = {"set": "refused", "mode": mode}
        if name in PORTED:
            golden = cv2.imread(path, cv2.IMREAD_COLOR)
            write_png(os.path.join(OUT, name + ".png"), golden, 2)
            manifest[name].update(set="coverage", golden=name + ".png",
                                  shape=list(golden.shape))
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(OUT, f))
                for f in os.listdir(OUT))
    print(f"{len(manifest)} fixtures, {total} bytes in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
