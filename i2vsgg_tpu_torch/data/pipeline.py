"""Host-side input pipeline — the port's counterpart of
``i2vsgg_tpu/data/pipeline.py``: decode, mean subtraction, shortest-side
resize, static padding into buckets, and the batched loader with its
prefetch thread.

cv2 is not on the card's machine, so the port decodes with
``data/image_io.py`` (PNG, and sequential and progressive JPEG through its
own decoder, ``data/jpeg.py``) and resizes with its own copy of
``cv2.resize(..., interpolation=cv2.INTER_LINEAR)``:

* the output is ``round(w * fx)`` x ``round(h * fy)`` and output pixel
  ``d`` samples source ``(d + 0.5) / f - 0.5`` (computed in double, the
  fraction then rounded to f32); horizontally the first and last source
  pixels take weight 1 past the borders, vertically the two source rows are
  clamped to the image and keep their weights;
* f32 images (``prep_image``) interpolate in f32, within 1e-4 of cv2's
  result on mean-subtracted frames (cv2 rounds its products in another
  order; tests/test_torch_drivers.py);
* uint8 images (``prep_image_u8``) follow cv2's fixed point: 11-bit
  coefficients, the horizontal pass in int32, the vertical as
  ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)`` then ``(x + 2) >> 2``
  — bit-equal to cv2 at the scales the loader meets (tests/
  test_torch_drivers.py), off by one on under 0.1 % of values at upscales
  near 10x.

``DetectionLoader`` loads through the native runtime by default
(``i2vsgg_tpu_torch/runtime``: ``csrc/io_runtime.cc``, decode, resize and
pad a whole batch on a thread pool with the GIL released, bit-equal to the
JAX package's default batches), as the JAX package's loader does;
``native=False`` or ``I2VSGG_NATIVE_IO=0`` takes the Python path above (its
JPEG decoder releases the GIL too, so the prefetch thread decodes beside
the main thread). Unlike the JAX package, a runtime that does not build
raises with the compiler's output instead of falling back. The two paths
differ by a fraction of a pixel where a side does not scale to a whole
number of pixels (``runtime.preprocess_plain``), and the native path leaves
a JPEG's EXIF orientation unapplied, as the JAX runtime's libjpeg does; the
uint8 transport always takes the Python path. The loader's training branch (``training=True``: the ratio-sorted roidb without
its ``need_crop`` entries, flipped entries mirrored, aspect-grouped batches
in a seeded random order, GT rows beyond ``MAX_NUM_GT_BOXES`` shuffled and
truncated) feeds ``tools/trainval_det_da.py``; in a process group each
rank takes its slice of the batch order (``parallel/mesh.py::host_shard``,
JAX's multi-host split).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from i2vsgg_tpu_torch import runtime
from i2vsgg_tpu_torch.config import Config
from i2vsgg_tpu_torch.data.image_io import imread_bgr
from i2vsgg_tpu_torch.parallel.mesh import host_shard

__all__ = ["DEFAULT_BUCKETS", "DetectionLoader", "bucket_hw",
           "dequantize_image_u8", "imread_bgr", "prep_image",
           "prep_image_u8", "resize_linear"]

# landscape bucket widths for height 608; portrait is the transpose.
DEFAULT_BUCKETS = (608, 736, 896, 1056, 1216)


def dequantize_image_u8(images_u8: torch.Tensor, im_info: torch.Tensor,
                        pixel_means: Sequence[float]) -> torch.Tensor:
    """On-device inverse of the uint8 transport: uint8 BGR (B, H, W, 3) ->
    mean-subtracted float32, with the padding beyond each image's true size
    (``im_info[:, :2]``) re-zeroed so that it equals the f32 transport
    exactly (f32 batches pad after the subtraction)."""
    dev = images_u8.device
    x = images_u8.to(torch.float32) - torch.as_tensor(
        pixel_means, dtype=torch.float32, device=dev)
    hh = torch.arange(images_u8.shape[1], device=dev)[None, :, None]
    ww = torch.arange(images_u8.shape[2], device=dev)[None, None, :]
    info = im_info.to(device=dev)
    mask = ((hh < info[:, 0][:, None, None])
            & (ww < info[:, 1][:, None, None]))
    return x * mask[..., None].to(torch.float32)


def bucket_hw(h: int, w: int, buckets: Sequence[int] = DEFAULT_BUCKETS,
              base: int = 608) -> Tuple[int, int]:
    """Static padded shape for a resized image."""
    long_side = max(h, w)
    for b in buckets:
        if long_side <= b:
            padded = b
            break
    else:
        padded = buckets[-1]
    return (base, padded) if w >= h else (padded, base)


def _axis_map(n_src: int, n_dst: int, scale: float):
    """cv2's INTER_LINEAR source index and fraction of each output pixel
    along one axis: ``(d + 0.5) / scale - 0.5`` in double, its floor, and
    the fraction rounded to f32."""
    f = (np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / scale) - 0.5
    s = np.floor(f).astype(np.int64)
    return s, (f - s).astype(np.float32)


def resize_linear(im: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(im, None, None, fx=scale, fy=scale,
    interpolation=cv2.INTER_LINEAR)`` for an (H, W, C) f32 or uint8
    image (see the module docstring for how close each is)."""
    h, w = im.shape[:2]
    dh, dw = int(round(h * scale)), int(round(w * scale))
    sx, fx = _axis_map(w, dw, scale)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, w - 1)
    sx1 = np.minimum(sx + 1, w - 1)
    sy, fy = _axis_map(h, dh, scale)
    r0, r1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    one = np.float32(1.0)
    if im.dtype == np.uint8:
        coef = np.float32(2048.0)                  # INTER_RESIZE_COEF_SCALE
        a0 = np.rint((one - fx) * coef).astype(np.int32)[None, :, None]
        a1 = np.rint(fx * coef).astype(np.int32)[None, :, None]
        b0 = np.rint((one - fy) * coef).astype(np.int32)[:, None, None]
        b1 = np.rint(fy * coef).astype(np.int32)[:, None, None]
        src = im.astype(np.int32)
        rows = src[:, sx] * a0 + src[:, sx1] * a1
        v = (((rows[r0] >> 4) * b0) >> 16) + (((rows[r1] >> 4) * b1) >> 16)
        return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    if im.dtype != np.float32:
        raise TypeError(f"resize_linear takes f32 or uint8, not {im.dtype}")
    a0, a1 = (one - fx)[None, :, None], fx[None, :, None]
    rows = im[:, sx] * a0 + im[:, sx1] * a1
    b0, b1 = (one - fy)[:, None, None], fy[:, None, None]
    return rows[r0] * b0 + rows[r1] * b1


def prep_image(im_bgr: np.ndarray, target_size: int,
               pixel_means: Sequence[float]) -> Tuple[np.ndarray, float]:
    """Mean-subtract + shortest-side resize (f32). [blob.py:20-52]"""
    im = im_bgr.astype(np.float32) - np.asarray(pixel_means, np.float32)
    h, w = im.shape[:2]
    im_scale = float(target_size) / min(h, w)
    return resize_linear(im, im_scale), im_scale


def prep_image_u8(im_bgr: np.ndarray, target_size: int
                  ) -> Tuple[np.ndarray, float]:
    """Shortest-side resize in uint8, without mean subtraction: the uint8
    transport, dequantized on the device by ``dequantize_image_u8``."""
    h, w = im_bgr.shape[:2]
    im_scale = float(target_size) / min(h, w)
    return resize_linear(im_bgr, im_scale), im_scale


class DetectionLoader:
    """Batched detection data iterator with a prefetch thread.

    Each batch is decoded, resized and padded by the native runtime
    (``runtime.load_batch``, threaded, GIL-free) unless ``native`` is False
    (default: ``I2VSGG_NATIVE_IO``, on unless "0") or ``uint8_transport``
    is set; the Python path (``imread_bgr`` + ``prep_image`` an image) is
    the other. A runtime that does not build raises here.

    Training: aspect-grouped batches of the ratio-sorted roidb in a seeded
    random order; in a process group each rank takes its slice of it
    (``parallel/mesh.py::host_shard``), every rank with the same ``seed``,
    as every JAX host does.

    Eval (``training=False``): the roidb in order, batches of
    ``batch_size`` (the last one ragged), each image mean-subtracted f32
    (``image``) or, with ``uint8_transport``, resized uint8 BGR
    (``image_u8``); each batch padded to the largest bucket shape of its
    images, with ``im_info`` the true resized size. ``gt_truncate``:
    "shuffle" (random permutation, then truncate) or "first" (the first
    ``MAX_NUM_GT_BOXES`` in annotation order, which the SGG drivers need:
    their relation triples index that order)."""

    def __init__(self, roidb: List[Dict], ratio_index: np.ndarray,
                 cfg: Config, batch_size: int = 1, training: bool = True,
                 seed: int = 0, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 prefetch: int = 2, native: Optional[bool] = None,
                 gt_truncate: str = "shuffle",
                 uint8_transport: bool = False):
        if gt_truncate not in ("shuffle", "first"):
            raise ValueError(f"gt_truncate {gt_truncate!r}: 'shuffle' or "
                             "'first'")
        self.gt_truncate = gt_truncate
        self.uint8_transport = uint8_transport
        # the runtime packs mean-subtracted f32; the uint8 transport is not
        self.native = runtime.wanted(native) and not uint8_transport
        if self.native:
            runtime.library()           # a failed build raises here
        self.cfg = cfg
        self.training = training
        self.batch_size = batch_size
        self.buckets = buckets
        self.rng = np.random.RandomState(seed)
        if training:
            roidb_sorted = [roidb[i] for i in ratio_index]
            self.entries = [e for e in roidb_sorted if not e.get("need_crop")]
            # in a process group, each rank loads its contiguous slice of
            # the ratio-sorted roidb (unchanged in one process)
            self.entries = host_shard(self.entries, batch_size)
        else:
            self.entries = list(roidb)
        self.prefetch = prefetch

    @property
    def path(self) -> str:
        """Which path loads the batches, as the drivers print it."""
        if self.native:
            return "native runtime (csrc/io_runtime.cc, 8 threads)"
        return ("Python (imread_bgr + prep_image_u8, uint8 transport)"
                if self.uint8_transport else "Python (imread_bgr + prep_image)")

    def __len__(self):
        return len(self.entries) // self.batch_size if self.training \
            else (len(self.entries) + self.batch_size - 1) // self.batch_size

    def _load_one(self, entry: Dict):
        im = imread_bgr(entry["image"])
        if entry.get("flipped"):
            im = im[:, ::-1, :]
        target = (self.cfg.TRAIN.SCALES if self.training
                  else self.cfg.TEST.SCALES)[0]
        if self.uint8_transport:
            im, scale = prep_image_u8(im, target)
        else:
            im, scale = prep_image(im, target, self.cfg.PIXEL_MEANS)
        return im, scale, entry["boxes"] * scale, entry["gt_classes"]

    def _pack_batch(self, items):
        g = self.cfg.TRAIN.MAX_NUM_GT_BOXES
        hw = [bucket_hw(im.shape[0], im.shape[1], self.buckets)
              for im, *_ in items]
        ph = max(h for h, w in hw)
        pw = max(w for h, w in hw)
        b = len(items)
        img_dtype = np.uint8 if self.uint8_transport else np.float32
        images = np.zeros((b, ph, pw, 3), img_dtype)
        im_info = np.zeros((b, 3), np.float32)
        gt = np.zeros((b, g, 5), np.float32)
        num_boxes = np.zeros((b,), np.int32)
        for i, (im, scale, boxes, classes) in enumerate(items):
            h, w = im.shape[:2]
            h, w = min(h, ph), min(w, pw)
            images[i, :h, :w] = im[:h, :w]
            im_info[i] = [h, w, scale]
            n = len(boxes)
            if n > g:
                boxes, classes, n = self._truncate_gt(boxes, classes, g)
            if n:
                gt[i, :n, :4] = np.clip(boxes[:, :4], 0,
                                        [w - 1, h - 1, w - 1, h - 1])
                gt[i, :n, 4] = classes
            num_boxes[i] = n
        key = "image_u8" if self.uint8_transport else "image"
        return {key: images, "im_info": im_info, "gt_boxes": gt,
                "num_boxes": num_boxes}

    def _pack_batch_native(self, group: List[int]) -> Dict:
        """The whole batch decoded, resized and padded by the runtime into
        the bucket that the roidb's recorded sizes give."""
        cfg = self.cfg
        target = (cfg.TRAIN.SCALES if self.training else cfg.TEST.SCALES)[0]
        entries = [self.entries[i] for i in group]
        hw_pred = []
        for e in entries:
            s = float(target) / min(e["height"], e["width"])
            hw_pred.append(bucket_hw(int(round(e["height"] * s)),
                                     int(round(e["width"] * s)),
                                     self.buckets))
        ph = max(h for h, w in hw_pred)
        pw = max(w for h, w in hw_pred)
        images, scales, hw = runtime.load_batch(
            [e["image"] for e in entries],
            [bool(e.get("flipped")) for e in entries],
            cfg.PIXEL_MEANS, target, ph, pw)
        b = len(entries)
        g = cfg.TRAIN.MAX_NUM_GT_BOXES
        im_info = np.zeros((b, 3), np.float32)
        gt = np.zeros((b, g, 5), np.float32)
        num_boxes = np.zeros((b,), np.int32)
        for i, e in enumerate(entries):
            h, w = int(hw[i, 0]), int(hw[i, 1])
            im_info[i] = [h, w, scales[i]]
            boxes = e["boxes"] * scales[i]
            classes = e["gt_classes"]
            n = len(boxes)
            if n > g:
                boxes, classes, n = self._truncate_gt(boxes, classes, g)
            if n:
                gt[i, :n, :4] = np.clip(boxes[:, :4], 0,
                                        [w - 1, h - 1, w - 1, h - 1])
                gt[i, :n, 4] = classes
            num_boxes[i] = n
        return {"image": images, "im_info": im_info, "gt_boxes": gt,
                "num_boxes": num_boxes}

    def _truncate_gt(self, boxes, classes, g):
        if self.gt_truncate == "first":
            return boxes[:g], classes[:g], g
        order = self.rng.permutation(len(boxes))[:g]
        return boxes[order], classes[order], g

    def _index_order(self) -> List[List[int]]:
        n = len(self.entries)
        bs = self.batch_size
        if not self.training:
            return [list(range(i, min(i + bs, n))) for i in range(0, n, bs)]
        # aspect-grouped: consecutive (ratio-sorted) groups in random order
        return [list(range(gidx * bs, (gidx + 1) * bs))
                for gidx in self.rng.permutation(n // bs)]

    def _produce(self, order, out_q, stop: threading.Event):
        try:
            for group in order:
                if stop.is_set():
                    return
                if self.native:
                    batch = self._pack_batch_native(group)
                else:
                    batch = self._pack_batch([self._load_one(self.entries[i])
                                              for i in group])
                batch["indices"] = np.asarray(group, np.int64)
                out_q.put(batch)
        except Exception as e:                  # re-raised by the consumer
            out_q.put(e)
        finally:
            out_q.put(None)

    def __iter__(self) -> Iterator[Dict]:
        order = self._index_order()
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(order, q, stop),
                             daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            while t.is_alive():                 # unblock a full queue
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    t.join(timeout=0.05)
