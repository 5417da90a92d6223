"""Detection visualization — the port's counterpart of the JAX package's
``utils/vis.py`` (``vis_detections`` of ``lib/model/utils/net_utils.py``):
class- and score-labelled boxes drawn on a frame, with numpy alone (the
card's machine has no PIL).

The boxes are PIL's ``ImageDraw.rectangle(width=2)`` in (204, 0, 0), pixel
for pixel: the corners truncated to integers as PIL's C code casts them,
two rows at the top and bottom edges and two columns at the sides drawn
between them, clipped to the image, as ``ImagingDrawRectangle`` draws them.
The label ``"<class>: <score>"`` goes at the same anchor, ``(x1 + 2,
max(0, y1 - 12))``, in a bitmap font carried here (the glyphs of Pillow's
built-in bitmap font, ``ImageFont.load_default_imagefont``, 6 x 11 pixels).
The JAX package draws it with PIL's default font, which FreeType renders
and numpy cannot reproduce: that is the one deviation (``label_box`` gives
the rectangle the port's label covers). ``save_vis`` writes a PNG with
``data/image_io.py::write_png`` whatever the file's extension.

As in the JAX package, no driver calls it: ``--vis`` is parsed and read
nowhere.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

COLOR = (204, 0, 0)
GLYPH_W, GLYPH_H = 6, 11                     # advance and line height
# ASCII 32-126 as Pillow's bitmap font holds them, each glyph a box that
# ``draw_text`` pastes at its offset in the character's 6 x 11 cell,
# overwriting what an earlier glyph left there, as PIL's ImagingFont pastes
# them: one digit for the left offset + 1, one hex digit for the top row,
# one digit for the width, then two hex digits a row (the leftmost pixel
# the highest of the width's bits)
_GLYPHS = (
    "18100", "232030303030003", "233050505", "1250a0a1f0a0a1f0a0a",
    "115040f191e0f031b1e04", "1251c151e040f1507", "0360e180c1f361f",
    "223030204", "2230102060606060201", "2230402030303030204", "124020f0609",
    "13504041f0404", "283030204", "1551f", "28203", "2240101020204040808",
    "1250e1b1b1b1b1b0e", "1260c3c0c0c0c0c3f", "1250e1b03060c1b1f",
    "1250e1b030e031b0e", "126060e16363f0606", "1251f181e1b03131e",
    "1250e1b181e1b1b0e", "1251f1b0306060c0c", "1250e1b1b0e1b1b0e",
    "1250e1b1b0f031b0e", "25203000003", "153030000030204", "13403060c0603",
    "1440f000f", "2340c0603060c", "1350e13060c000c", "1261c32262a2a27301c",
    "0373c1c143e3677", "0363e1b1e1b1b3e", "1350f1b18181b0e",
    "0363e1b1b1b1b3e", "0363f181e181b3f", "0363f181e18183c",
    "1350e1b181f1b0f", "03777363e363677", "1340f060606060f",
    "0360f060636361c", "0377634383c367b", "0363c1818181b3f",
    "036311b1b1f1535", "037773a3a363672", "1350e1b1b1b1b0e",
    "0363e1b1b1e183c", "1350e1b1b1b1b0e03", "0377c36363c367b",
    "1350f191e07131e", "0363f2d0c0c0c1e", "03777363636361c",
    "0377736141c1c08", "0376b2a2a3e1c14", "136331e0c0c1e33",
    "03773331e0c0c1e", "1351f1b060c1b1f", "2230706060606060607",
    "1240808040402020101", "2230703030303030307", "125040e1b", "1a63f",
    "223060201", "1461c361e363f", "02638181e1b1b1b3e", "1450e1b181b0e",
    "1260e061e3636361f", "1450e1b1f180f", "125070c1f0c0c0c1f",
    "1461b3636361e063c", "02638181e1b1b1b1b", "1260c003c0c0c0c3f",
    "12403000f03030303030e", "0277030363c383c37", "1263c0c0c0c0c0c3f",
    "0463e1f151515", "046361b1b1b1b", "1450e1b1b1b0e", "0463e1b1b1b1e183c",
    "1461b3636361e060f", "146371d18183c", "1461e381e073e",
    "12618183e18181b0e", "047763636361f", "0463b1b0e0e04", "0476b2a3e1e14",
    "1463b1e0c1e37", "047773636141c1870", "1451f160c1b1f",
    "2240306060c06060603", "33101010101010101", "1240c0606030606060c",
    "1450d16",
)


def _glyph(ch: str):
    """(left offset, top row, the box's rows as bool (h, w)) of a character
    (unknown ones: a space)."""
    i = ord(ch) - 32
    code = _GLYPHS[i if 0 <= i < len(_GLYPHS) else 0]
    dx0, y0, w = int(code[0]) - 1, int(code[1], 16), int(code[2])
    rows = np.frombuffer(bytes.fromhex(code[3:]), np.uint8)
    return dx0, y0, (rows[:, None] >> np.arange(w - 1, -1, -1) & 1).astype(
        bool)


def _hline(img, x0: int, y: int, x1: int):
    h, w = img.shape[:2]
    if not 0 <= y < h:
        return
    x0, x1 = min(x0, x1), max(x0, x1)
    if x0 >= w or x1 < 0:
        return
    img[y, max(x0, 0):min(x1, w - 1) + 1] = COLOR


def _vline(img, x: int, y0: int, y1: int):
    """PIL's vertical ``line32``: |y1 - y0| points from y0 towards y1, y1
    left out."""
    h, w = img.shape[:2]
    if not 0 <= x < w:
        return
    ys = np.arange(y0, y1) if y1 >= y0 else np.arange(y0, y1, -1)
    ys = ys[(ys >= 0) & (ys < h)]
    img[ys, x] = COLOR


def draw_rectangle(img: np.ndarray, xy, width: int = 2) -> None:
    """PIL's ``ImageDraw.rectangle(xy, outline=COLOR, width=width)`` on an
    (H, W, 3) uint8 RGB array, in place."""
    x0, y0, x1, y1 = (float(v) for v in xy)
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    for i in range(width):
        _hline(img, x0, y0 + i, x1)
        _hline(img, x0, y1 - i, x1)
        _vline(img, x1 - i, y0 + width, y1 - width + 1)
        _vline(img, x0 + i, y0 + width, y1 - width + 1)


def label_box(x: float, y: float, text: str) -> tuple:
    """(left, top, right, bottom), right and bottom excluded, of the pixels
    ``draw_text`` may set for ``text`` at (x, y)."""
    x, y = int(x), int(y)
    return x, y, x + GLYPH_W * len(text), y + GLYPH_H


def draw_text(img: np.ndarray, xy, text: str) -> None:
    """``text`` in the bitmap font in COLOR at ``xy`` (truncated to
    integers), clipped to the image, in place: as PIL draws it with
    Pillow's bitmap font, the glyphs pasted into a mask of the text's
    cells, the mask's set pixels drawn."""
    x0, y0, x1, y1 = label_box(*xy, text)
    mask = np.zeros((y1 - y0, x1 - x0), bool)
    for k, ch in enumerate(text):
        dx0, top, box = _glyph(ch)
        h, w = box.shape
        left = GLYPH_W * k + dx0
        cut = max(0, -left)                       # the first glyph's -1
        right = min(left + w, mask.shape[1])
        mask[top:top + h, left + cut:right] = box[:, cut:right - left]
    ys, xs = np.nonzero(mask)
    ys, xs = ys + y0, xs + x0
    keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[keep], xs[keep]] = COLOR


def vis_detections(im_bgr: np.ndarray, class_name: str, dets: np.ndarray,
                   thresh: float = 0.8) -> np.ndarray:
    """Draw detections of one class. dets: (N, 5) [x1, y1, x2, y2, score].

    Returns the image (RGB uint8) with boxes drawn; input is BGR like the
    pipeline's decoded frames.
    """
    img = np.ascontiguousarray(im_bgr[..., ::-1]).astype(np.uint8)
    for i in range(dets.shape[0]):
        score = float(dets[i, -1])
        if score <= thresh:
            continue
        x1, y1, x2, y2 = [float(v) for v in dets[i, :4]]
        draw_rectangle(img, (x1, y1, x2, y2))
        draw_text(img, (x1 + 2, max(0.0, y1 - 12)),
                  f"{class_name}: {score:.3f}")
    return img


def save_vis(im_bgr: np.ndarray, all_class_dets: Sequence,
             classes: Sequence[str], out_path: str,
             thresh: float = 0.5) -> None:
    """Draw every class's detections and write ``out_path`` (a PNG)."""
    from i2vsgg_tpu_torch.data.image_io import write_png

    img = np.ascontiguousarray(im_bgr[..., ::-1]).astype(np.uint8)
    for j, dets in enumerate(all_class_dets):
        if j == 0 or dets is None or len(dets) == 0:
            continue
        img = vis_detections(img[..., ::-1], classes[j], np.asarray(dets),
                             thresh)
    write_png(out_path, np.ascontiguousarray(img[..., ::-1]))
