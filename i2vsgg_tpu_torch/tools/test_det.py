"""Detection evaluation — the port's counterpart of the JAX package's
``tools/test_det.py`` (rebuild of ``test_net_instance_styleD_bilinear.py:
42-237``): per batch, detection and the box decode with per-class NMS and
the top-100 cap on the device (``serve.decode_detections``), then the
per-class VOC result files and mAP (``imdb.evaluate_detections``,
``eval/voc_eval.py``). Writes ``<save_dir>/eval/<imdbval_name>/
detections.pkl`` and the result files under ``.../adapt/``. It runs on one
device; ``--mesh`` is read and ignored, as by the JAX driver.

Usage:
  python -m i2vsgg_tpu_torch.tools.test_det --dataset MVidVRD --net res101 \\
      --load_name models/res101/MVRD/session_1/<step> [--device cpu]
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import torch


@torch.no_grad()
def run_detection(model, loader, cfg, dev, max_det: int = 100):
    """Yield (indices, Detections as numpy) per loader batch."""
    from i2vsgg_tpu_torch.data.pipeline import dequantize_image_u8
    from i2vsgg_tpu_torch.serve import Detections, decode_detections

    t_load = t_run = 0.0
    it = iter(loader)
    while True:
        t0 = time.time()
        batch = next(it, None)
        t_load += time.time() - t0
        if batch is None:
            break
        t0 = time.time()
        im_info = torch.as_tensor(batch["im_info"], device=dev)
        if "image_u8" in batch:
            images = dequantize_image_u8(
                torch.as_tensor(batch["image_u8"], device=dev), im_info,
                cfg.PIXEL_MEANS)
        else:
            images = torch.as_tensor(batch["image"], dtype=torch.float32,
                                     device=dev)
        out = model.inference(images, im_info)
        dets = decode_detections(
            out["rois"], out["roi_valid"], out["cls_prob"], out["bbox_pred"],
            im_info, cfg, max_det=max_det,
            max_per_class=cfg.TEST.MAX_PER_CLASS or max_det,
            score_thresh=0.0)
        dets = Detections(*(x.cpu().numpy() for x in dets))
        t_run += time.time() - t0
        yield batch["indices"], dets
    print(f"  eval phases: load {t_load:.1f}s run {t_run:.1f}s", flush=True)


def main(argv=None):
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.data.pipeline import DetectionLoader
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
    from i2vsgg_tpu_torch.models.layers import init_weights
    from i2vsgg_tpu_torch.tools.common import (apply_act_scales, ckpt_of,
                                               config_from_args, metadata_of)
    from i2vsgg_tpu_torch.train.checkpoint import restore_intersection
    from i2vsgg_tpu_torch.utils.device import resolve_device

    args = set_dataset_args(parse_args(argv), test=True)
    if args.mesh:
        # the JAX driver parses --mesh and evaluates on one device too
        print(f"--mesh {args.mesh}: evaluation runs on one device",
              flush=True)
    dev = resolve_device(args.device)
    cfg = config_from_args(args, verbose=True)
    # pooling_mode travels in the checkpoint and overrides cfg
    # [test_net_instance_styleD_bilinear.py:80-81]; applied before the
    # detector is built, since the port's detector reads it at
    # construction
    meta = metadata_of(args.load_name)
    if meta.get("pooling_mode"):
        cfg = cfg.replace(POOLING_MODE=meta["pooling_mode"])

    imdb, roidb, _, idx = combined_roidb(args.imdbval_name, training=False,
                                         use_flipped=False)
    print(f"{len(roidb)} eval images ({args.imdbval_name})")
    loader = DetectionLoader(roidb, idx, cfg, args.batch_size, training=False,
                             uint8_transport=args.uint8_upload)
    print(f"loader: {loader.path}")

    model = FasterRCNN_DA(num_classes=len(imdb.classes), cfg=cfg,
                          backbone=args.net,
                          class_agnostic=args.class_agnostic,
                          ic=args.ic, gc=args.gc)
    init_weights(model, torch.Generator().manual_seed(0))
    ckpt = ckpt_of(args.load_name)
    if ckpt is not None:
        restore_intersection(*ckpt, model)
        print(f"loaded {args.load_name}")
    apply_act_scales(model, args)
    model.to(dev).eval()

    n = len(roidb)
    all_boxes = [[np.empty((0, 5), np.float32) for _ in range(n)]
                 for _ in range(len(imdb.classes))]
    max_det = cfg.TEST.MAX_DETECTIONS_PER_IMAGE
    t0 = time.time()
    done = 0
    for indices, dets in run_detection(model, loader, cfg, dev, max_det):
        for bi, img_i in enumerate(indices):
            keep = dets.valid[bi]
            for j in range(1, len(imdb.classes)):
                sel = keep & (dets.classes[bi] == j)
                all_boxes[j][img_i] = np.hstack(
                    [dets.boxes[bi][sel],
                     dets.scores[bi][sel][:, None]]).astype(np.float32)
            done += 1
        if done % 100 < args.batch_size:
            print(f"  {done}/{n} images ({done / (time.time() - t0):.1f}/s)")

    out_dir = os.path.join(args.save_dir, "eval", args.imdbval_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "detections.pkl"), "wb") as f:
        pickle.dump(all_boxes, f)
    aps = imdb.evaluate_detections(all_boxes, out_dir, setting="adapt")
    print(f"mAP {aps['mAP']:.4f}; total eval time "
          f"{time.time() - t0:.1f}s")
    return aps


if __name__ == "__main__":
    main(sys.argv[1:])
