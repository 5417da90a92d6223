"""Static per-tensor activation scales for the int8 trunk — the port's
counterpart of the JAX package's ``tools/calibrate_act_scales.py``, with its
flags plus ``--device``.

The float detector runs inference over ``<dataset>_test`` with
``I2VSGG_INT8_CALIB=1``, so that every ``BNConv`` records the abs-max of its
input, the running maximum over calls (``models/backbones.py``). Batches of
``--bs`` run until ``--n_images`` is reached; the count is checked before
each batch, so whole batches count, as in JAX. The file written is the JAX
tool's: ``{"ckpt", "n_images", "scales": {path: absmax / 127}}``, keyed by
the flax path (``trunk/layer3/block0/conv2``), which ``--act_scales`` of
either package's drivers reads (``quantize_trunk_params``).

As in the JAX tool, the config is the defaults with ``--cfg`` over them (no
``cfgs/<net>.yml``), and ``I2VSGG_DATA_ROOT`` defaults to ``--data``. The
detector is built and restored as ``test_det`` builds it: ``init_weights``
from seed 0, ``restore_intersection``, the checkpoint's ``pooling_mode``
applied before the build. ``I2VSGG_PALLAS_BOTTLENECK=1`` is refused: the
chain computes layer3's identity tail without calling its convs, which would
go unrecorded.

Usage:
  python -m i2vsgg_tpu_torch.tools.calibrate_act_scales \\
      --ckpt models/res101/MVRD/session_1/<step> --dataset MVRD \\
      --net res101 --n_images 64 --json runs/calib/act_scales.json \\
      [--cfg POOLING_MODE align] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint in the port's format: <ckpt_dir>/<step>")
    ap.add_argument("--dataset", default="MVRD")
    ap.add_argument("--net", default="res50")
    ap.add_argument("--n_images", type=int, default=64)
    ap.add_argument("--bs", type=int, default=4)
    # outside runs/quant_trunk_ab, whose files read as A/B artifacts
    ap.add_argument("--json", default="runs/calib/act_scales.json")
    ap.add_argument("--cfg", nargs="*", default=[])
    ap.add_argument("--data", default="runs/parity_r3/data")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


@torch.no_grad()
def main(argv=None) -> dict:
    args = parse_args(argv)
    if os.environ.get("I2VSGG_PALLAS_BOTTLENECK") == "1":
        raise ValueError(
            "I2VSGG_PALLAS_BOTTLENECK=1: the bottleneck chain computes "
            "layer3's identity tail without calling its convs, so their "
            "inputs would go unrecorded; calibrate with the switch off")
    os.environ.setdefault("I2VSGG_DATA_ROOT", args.data)

    from i2vsgg_tpu_torch.config import Config, cfg_from_list
    from i2vsgg_tpu_torch.data.pipeline import DetectionLoader
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.models.backbones import act_absmax
    from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
    from i2vsgg_tpu_torch.models.layers import init_weights
    from i2vsgg_tpu_torch.tools.common import ckpt_of, metadata_of
    from i2vsgg_tpu_torch.train.checkpoint import restore_intersection
    from i2vsgg_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = cfg_from_list(list(args.cfg), Config())
    meta = metadata_of(args.ckpt)
    if meta.get("pooling_mode"):
        cfg = cfg.replace(POOLING_MODE=meta["pooling_mode"])
    imdb, roidb, _, idx = combined_roidb(f"{args.dataset}_test",
                                         training=False, use_flipped=False)
    loader = DetectionLoader(roidb, idx, cfg, args.bs, training=False)
    model = FasterRCNN_DA(num_classes=len(imdb.classes), cfg=cfg,
                          backbone=args.net, ic=True, gc=True)
    init_weights(model, torch.Generator().manual_seed(0))
    restore_intersection(*ckpt_of(args.ckpt), model)
    model.to(dev).eval()

    absmax: dict = {}
    seen = 0
    saved = os.environ.get("I2VSGG_INT8_CALIB")
    os.environ["I2VSGG_INT8_CALIB"] = "1"
    try:
        for bi, batch in enumerate(loader):
            if seen >= args.n_images:
                break
            model.inference(
                torch.as_tensor(batch["image"], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(batch["im_info"], device=dev))
            absmax = act_absmax(model)        # one transfer a batch
            seen += batch["image"].shape[0]
            print(f"batch {bi}: {seen} images", flush=True)
    finally:
        if saved is None:
            os.environ.pop("I2VSGG_INT8_CALIB", None)
        else:
            os.environ["I2VSGG_INT8_CALIB"] = saved

    scales = {k: v / 127.0 for k, v in absmax.items()}
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"ckpt": args.ckpt, "n_images": seen, "scales": scales},
                  f, indent=1, sort_keys=True)
    print(f"wrote {len(scales)} scales ({seen} images) -> {args.json}")
    return scales


if __name__ == "__main__":
    main(sys.argv[1:])
