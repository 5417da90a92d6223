"""roidb preparation: sizes, aspect-ratio ranking, filtering, combination —
the port's own copy of ``i2vsgg_tpu/data/roidb.py``, which reads each
image's size from its file header (``data/image_io.py::image_size``)
instead of through PIL.

Rebuild of ``lib/roi_data_layer/roidb.py:16-143``: enrich each roidb entry
with image path/size and per-box max class/overlap, rank by aspect ratio
clamped to [0.5, 2] (entries outside get ``need_crop`` — the reference's
drivers then skip those images: ``roibatchLoader.py:89-90`` +
``trainval_net_instance_styleD_bilinear.py:242-243``; we mark them and the
loader crops instead, see pipeline.py), filter boxless entries, and support
``"a+b"`` multi-dataset concatenation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from i2vsgg_tpu_torch.data.factory import get_imdb
from i2vsgg_tpu_torch.data.image_io import image_size


def prepare_roidb(imdb) -> None:
    """Add path/width/height/max_classes/max_overlaps. [roidb.py:16-46]"""
    roidb = imdb.roidb
    sizes = [image_size(imdb.image_path_at(i))         # (w, h)
             for i in range(imdb.num_images)]
    n_real = imdb.num_images
    for i in range(len(roidb)):
        roidb[i]["img_id"] = i
        roidb[i]["image"] = imdb.image_path_at(i % n_real)
        roidb[i]["width"] = sizes[i % n_real][0]
        roidb[i]["height"] = sizes[i % n_real][1]
        gt_overlaps = roidb[i]["gt_overlaps"]
        if hasattr(gt_overlaps, "toarray"):
            gt_overlaps = gt_overlaps.toarray()
        roidb[i]["max_overlaps"] = gt_overlaps.max(axis=1) if len(gt_overlaps) else np.zeros(0)
        roidb[i]["max_classes"] = gt_overlaps.argmax(axis=1) if len(gt_overlaps) else np.zeros(0, np.int64)


def rank_roidb_ratio(roidb) -> Tuple[np.ndarray, np.ndarray]:
    """Aspect ratios clamped to [0.5, 2] + need_crop flag, sorted.
    [roidb.py:50-76]"""
    ratios = []
    for entry in roidb:
        ratio = entry["width"] / float(entry["height"])
        if ratio > 2:
            entry["need_crop"] = 1
            ratio = 2
        elif ratio < 0.5:
            entry["need_crop"] = 1
            ratio = 0.5
        else:
            entry["need_crop"] = 0
        ratios.append(ratio)
    ratios = np.asarray(ratios)
    order = np.argsort(ratios)
    return ratios[order], order


def filter_roidb(roidb):
    """Drop images without usable boxes. [roidb.py:78-95]"""
    return [e for e in roidb if len(e["boxes"]) > 0]


def combined_roidb(imdb_names: str, training: bool = True,
                   use_flipped: bool = True):
    """Load one or more (``"+"``-joined) datasets into a single roidb.
    [roidb.py:99-143]

    Returns (imdb, roidb, ratio_list, ratio_index).
    """
    def one(name):
        imdb = get_imdb(name)
        prepare_roidb(imdb)
        if training and use_flipped:
            imdb.append_flipped_images()
            prepare_roidb(imdb)
        return imdb

    names = imdb_names.split("+")
    imdbs = [one(n) for n in names]
    imdb = imdbs[0]
    roidb = []
    for d in imdbs:
        roidb.extend(d.roidb)
    if training:
        roidb = filter_roidb(roidb)
    ratio_list, ratio_index = rank_roidb_ratio(roidb)
    return imdb, roidb, ratio_list, ratio_index
