"""The learnable synthetic corpus of the serving gates — the port's copy of
the JAX package's ``tests/fixtures.py`` generators (``VRD15``,
``_write_xml``, ``LEARNABLE_CLASSES``, ``_COLORS``, ``_geom_relations``,
``make_learnable_dataset``, ``make_learnable_video_dataset``).

Solid-colour rectangles on dark noise, class = colour, and geometry
predicates recoverable from the boxes, so that a detector and a relation
head trained on it have a real signal, and detection mAP and relation R@50
on the held-out split mean something. Every ``RandomState`` draw comes in
the JAX generator's order (the colour jitter included), so the same seed
gives the same boxes, pixels, annotations and splits.

The card's machine has no PIL. The images are drawn with numpy and written
with ``data/image_io.py::write_png``, which takes BGR: the RGB array PIL
would take is written as ``im[..., ::-1]``. Every image is a PNG file,
whatever ``ext`` names it: the MVRD stills keep the ``.jpg`` name that
``data/factory.py`` asks for, and both packages' loaders pick the decoder
from the file's first bytes. (The JAX generator writes lossy JPEG there.)
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from i2vsgg_tpu_torch.data.image_io import write_png

VRD15 = ("airplane", "ball", "bear", "bicycle", "bus", "car", "cat", "dog",
         "elephant", "horse", "motorcycle", "person", "skateboard", "sofa",
         "train")
LEARNABLE_CLASSES = VRD15[:8]     # one solid colour per class (below)
_COLORS = [(230, 30, 30), (30, 230, 30), (40, 40, 235), (230, 230, 30),
           (230, 30, 230), (30, 230, 230), (240, 140, 20), (150, 150, 150)]
# geometry-derived predicates: recoverable from the boxes
LEARNABLE_PREDICATES = ("left-of", "above", "overlaps", "larger", "near")


def _write_xml(path, size, objs):
    h, w = size
    lines = ["<annotation>", f"<size><width>{w}</width>"
             f"<height>{h}</height><depth>3</depth></size>"]
    for name, (x1, y1, x2, y2) in objs:
        lines += ["<object>", f"<name>{name}</name>",
                  "<difficult>0</difficult>",
                  "<bndbox>", f"<xmin>{x1 + 1}</xmin>", f"<ymin>{y1 + 1}</ymin>",
                  f"<xmax>{x2 + 1}</xmax>", f"<ymax>{y2 + 1}</ymax>",
                  "</bndbox>", "</object>"]
    lines.append("</annotation>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _write_image(path, rgb):
    """The RGB image PIL's ``Image.fromarray(rgb).save`` takes, as a PNG."""
    write_png(path, rgb[..., ::-1])


def _geom_relations(objs):
    """All ordered pairs with their geometry-true predicate ids."""
    rels = []
    for s, (_, (sx1, sy1, sx2, sy2)) in enumerate(objs):
        for o, (_, (ox1, oy1, ox2, oy2)) in enumerate(objs):
            if s == o:
                continue
            if sx2 < ox1:
                rels.append((s, 0, o))                      # left-of
            if sy2 < oy1:
                rels.append((s, 1, o))                      # above
            iw = min(sx2, ox2) - max(sx1, ox1)
            ih = min(sy2, oy2) - max(sy1, oy1)
            if iw > 0 and ih > 0:
                rels.append((s, 2, o))                      # overlaps
            if ((sx2 - sx1) * (sy2 - sy1)
                    > 1.5 * (ox2 - ox1) * (oy2 - oy1)):
                rels.append((s, 3, o))                      # larger
            cdist = np.hypot((sx1 + sx2) - (ox1 + ox2),
                             (sy1 + sy2) - (oy1 + oy2)) / 2
            if cdist < 60:
                rels.append((s, 4, o))                      # near
    return rels


def _devkit_dirs(root, ds_name):
    base = os.path.join(root, ds_name)
    for sub in ("Annotations", "JPEGImages",
                os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    return base


def make_learnable_dataset(root, ds_name, n_images, ext=".jpg", seed=0,
                           hw=(240, 320), split_frac=0.75,
                           index_fmt="im{:04d}", min_obj=2, max_obj=5,
                           size_range=(30, 90)):
    """Stills a detector can learn: solid-colour rectangles on a dark noisy
    background, class == colour, in a VOC devkit ``<root>/<ds_name>`` with
    ``trainval``/``val`` (the first ``split_frac``) and ``test`` splits and
    ``source_gt_rels.pkl``. Returns (annos dict, gt_rels dict)."""
    rng = np.random.RandomState(seed)
    base = _devkit_dirs(root, ds_name)
    h, w = hw
    annos, gt_rels = {}, {}
    indices = [index_fmt.format(i) for i in range(n_images)]
    for index in indices:
        im = (rng.rand(h, w, 3) * 40).astype(np.uint8)      # dark noise bg
        objs = []
        for _ in range(rng.randint(min_obj, max_obj + 1)):
            bw = rng.randint(*size_range)
            bh = rng.randint(*size_range)
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            ci = rng.randint(len(LEARNABLE_CLASSES))
            col = np.asarray(_COLORS[ci]) + rng.randint(-15, 16, 3)
            im[y1:y1 + bh, x1:x1 + bw] = np.clip(col, 0, 255)
            objs.append((LEARNABLE_CLASSES[ci],
                         (x1, y1, x1 + bw - 1, y1 + bh - 1)))
        _write_image(os.path.join(base, "JPEGImages", index + ext), im)
        _write_xml(os.path.join(base, "Annotations", index + ".xml"),
                   (h, w), objs)
        annos[index] = objs
        gt_rels[index] = _geom_relations(objs)
    n_train = int(n_images * split_frac)
    splits = {"trainval": indices[:n_train], "val": indices[:n_train],
              "test": indices[n_train:]}
    for split, idxs in splits.items():
        with open(os.path.join(base, "ImageSets", "Main",
                               split + ".txt"), "w") as f:
            f.write("\n".join(idxs) + "\n")
    with open(os.path.join(base, "source_gt_rels.pkl"), "wb") as f:
        pickle.dump(gt_rels, f)
    return annos, gt_rels


def make_learnable_video_dataset(root, ds_name, n_videos=20, n_frames=24,
                                 ext=".png", seed=0, hw=(240, 320),
                                 split_frac=0.5, min_obj=2, max_obj=3,
                                 size_range=(50, 110), max_speed=3,
                                 min_gt_len=10):
    """Videos of the same rectangles, each moving at a constant velocity and
    bouncing off the walls for ``n_frames`` frames: VOC frames named
    ``vid{v:02d}_{f:04d}``, per-frame geometry relations
    (``source_gt_rels.pkl``), and video-level relation GT (each maximal run
    of a (subject, predicate, object) lasting >= ``min_gt_len`` frames, in
    the schema of ``video/metrics.py::evaluate``) in
    ``video_annotations_{trainval,test}.json``. Splits are by video (the
    first ``split_frac`` of them trainval). Returns (annos, gt_rels,
    video_ann)."""
    rng = np.random.RandomState(seed)
    base = _devkit_dirs(root, ds_name)
    h, w = hw
    class_ids = {c: i + 1 for i, c in enumerate(VRD15)}   # bg = 0
    annos, gt_rels, video_ann = {}, {}, {}
    split_indices = {"trainval": [], "test": []}
    n_train_videos = int(n_videos * split_frac)
    for v in range(n_videos):
        vid = f"vid{v:02d}"
        split = "trainval" if v < n_train_videos else "test"
        n_obj = rng.randint(min_obj, max_obj + 1)
        sizes, pos, vel, cls = [], [], [], []
        for _ in range(n_obj):
            bw = rng.randint(*size_range)
            bh = rng.randint(*size_range)
            sizes.append((bw, bh))
            pos.append([rng.uniform(0, w - bw), rng.uniform(0, h - bh)])
            vel.append(rng.uniform(-max_speed, max_speed, 2))
            cls.append(rng.randint(len(LEARNABLE_CLASSES)))
        per_frame_objs = []
        for f in range(n_frames):
            index = f"{vid}_{f:04d}"
            im = (rng.rand(h, w, 3) * 40).astype(np.uint8)
            objs = []
            for oi in range(n_obj):
                bw, bh = sizes[oi]
                x1 = int(round(pos[oi][0]))
                y1 = int(round(pos[oi][1]))
                ci = cls[oi]
                col = np.asarray(_COLORS[ci]) + rng.randint(-15, 16, 3)
                im[y1:y1 + bh, x1:x1 + bw] = np.clip(col, 0, 255)
                objs.append((LEARNABLE_CLASSES[ci],
                             (x1, y1, x1 + bw - 1, y1 + bh - 1)))
                # advance with wall bounce
                for ax, lim in ((0, w - bw), (1, h - bh)):
                    pos[oi][ax] += vel[oi][ax]
                    if pos[oi][ax] < 0 or pos[oi][ax] > lim:
                        vel[oi][ax] = -vel[oi][ax]
                        pos[oi][ax] = np.clip(pos[oi][ax], 0, lim)
            _write_image(os.path.join(base, "JPEGImages", index + ext), im)
            _write_xml(os.path.join(base, "Annotations", index + ".xml"),
                       (h, w), objs)
            annos[index] = objs
            gt_rels[index] = _geom_relations(objs)
            split_indices[split].append(index)
            per_frame_objs.append(objs)
        # maximal constant runs -> video-level GT trajectories
        presence = {}
        for f, objs in enumerate(per_frame_objs):
            for s, p, o in gt_rels[f"{vid}_{f:04d}"]:
                presence.setdefault((s, p, o), []).append(f)
        rels_out = []
        for (s, p, o), frames in presence.items():
            run_start = prev = frames[0]
            runs = []
            for f in frames[1:] + [None]:
                if f is None or f != prev + 1:
                    runs.append((run_start, prev + 1))
                    run_start = f
                prev = f
            for fs, fe in runs:
                if fe - fs < min_gt_len:
                    continue
                rels_out.append({
                    "triplet": [class_ids[per_frame_objs[0][s][0]], p,
                                class_ids[per_frame_objs[0][o][0]]],
                    "duration": [fs, fe],
                    "sub_traj": [list(map(float, per_frame_objs[f][s][1]))
                                 for f in range(fs, fe)],
                    "obj_traj": [list(map(float, per_frame_objs[f][o][1]))
                                 for f in range(fs, fe)],
                })
        video_ann[vid] = rels_out
    for split, idxs in split_indices.items():
        with open(os.path.join(base, "ImageSets", "Main",
                               split + ".txt"), "w") as f:
            f.write("\n".join(idxs) + "\n")
        # val mirrors trainval (the dataset factory's naming)
        if split == "trainval":
            with open(os.path.join(base, "ImageSets", "Main",
                                   "val.txt"), "w") as f:
                f.write("\n".join(idxs) + "\n")
        with open(os.path.join(base,
                               f"video_annotations_{split}.json"),
                  "w") as f:
            vids = {f"vid{v:02d}" for v in (
                range(n_train_videos) if split == "trainval"
                else range(n_train_videos, n_videos))}
            json.dump({k: v for k, v in video_ann.items() if k in vids}, f)
    with open(os.path.join(base, "source_gt_rels.pkl"), "wb") as f:
        pickle.dump(gt_rels, f)
    return annos, gt_rels, video_ann
