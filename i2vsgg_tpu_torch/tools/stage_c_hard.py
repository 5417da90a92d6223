"""Stage C on the hard video set: the trained relation pipeline's R@50 where
the top-50 cut binds — the port's counterpart of the JAX package's
``tools/stage_c_hard.py``, with its flags plus ``--depth`` and ``--device``.

The 10-video Stage C set carries so few GT relation instances (32) that
every arm scores R@50 = 1.0. This tool evaluates a trained Stage B head on
a regenerated hard set (``parity_run.make_data(hard_videos=True)``: 4-6
smaller, faster objects a video with same-class ambiguity, ~40-80 GT
instances a video) with ``parity_run.eval_video_rel`` (GT boxes as the
detections, the scorer's predicate scores, per-frame top-100 tuples,
association, evaluation at vIoU 0.5): rel mAP, R@50, R@100, tagging
P@1/5/10 and the GT count. The arm trains on the original data; only the
evaluation videos are hard.

The ours arm rebuilds the scorer from ``--ours_ckpt <ckpt_dir>/<step>``
with ``quant_ab.build_scorer`` (f32, no retraining), and scores the hard
set with ``I2VSGG_DATA_ROOT`` swapped to it, then restored. The results go
to ``<hard_out>/stage_c_hard.json`` under ``ours_hard``.

The reference arm is not ported: it retrains the reference's head through
``parity/refshim.py``, which needs the reference's sources
(``/root/reference``); ``--arms`` with ``ref`` raises ``ValueError``
before anything runs. The default ``--arms`` is ``ours`` (JAX's:
``ours,ref``).

Usage:
  python -m i2vsgg_tpu_torch.tools.stage_c_hard --out runs/torch_gate_arm \\
      --hard_out runs/torch_stage_c_hard --arms ours --depth 101 \\
      --ours_ckpt runs/torch_gate_arm/res101/MVRD_SGG/session_951/672 \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REF_REFUSED = ("the reference arm retrains the reference's head through "
               "parity/refshim.py, which needs the reference's sources "
               "(/root/reference); the port runs --arms ours")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/parity_r3",
                    help="original parity campaign dir (training data + "
                         "ours Stage-B checkpoints live here)")
    ap.add_argument("--hard_out", default="runs/parity_r4c")
    ap.add_argument("--seed", type=int, default=1,
                    help="ref retrain seed; should match the seed of "
                         "--ours_ckpt's session for a paired comparison")
    ap.add_argument("--ours_ckpt", required=True)
    ap.add_argument("--ref_head", default="",
                    help="reuse a previously saved ref head state_dict "
                         "instead of retraining")
    ap.add_argument("--steps", type=int, default=672)
    ap.add_argument("--n_videos", type=int, default=24)
    ap.add_argument("--arms", default="ours")
    ap.add_argument("--depth", type=int, default=None,
                    help="the scorer's trunk depth (parity_run.HP's, 50, by "
                         "default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from i2vsgg_tpu_torch.tools.parity_run import HP, eval_video_rel, make_data
    from i2vsgg_tpu_torch.tools.quant_ab import build_scorer
    from i2vsgg_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    arms = args.arms.split(",")
    if "ref" in arms:
        raise ValueError(REF_REFUSED)
    device = resolve_device(args.device)
    if args.depth is not None:
        HP["depth"] = args.depth

    orig_root = os.path.join(args.out, "data")
    hard_root = os.path.join(args.hard_out, "data")
    os.environ["I2VSGG_DATA_ROOT"] = orig_root

    if not os.path.isdir(os.path.join(hard_root, "MVidVRD")):
        # the campaign's generator and classes; only the density and speed
        # of the videos differ
        make_data(hard_root, n_source=4, n_target=args.n_videos,
                  video_target=True, hard_videos=True)
        print(f"hard video set -> {hard_root}")
    with open(os.path.join(hard_root, "MVidVRD",
                           "video_annotations_test.json")) as f:
        gt = json.load(f)
    n_gt = sum(len(v) for v in gt.values())
    print(f"hard test set: {len(gt)} videos, {n_gt} GT relation instances")

    results = {"n_gt_hard": n_gt, "n_videos": len(gt),
               "ours_ckpt": args.ours_ckpt, "seed": args.seed}
    path = os.path.join(args.hard_out, "stage_c_hard.json")
    os.makedirs(args.hard_out, exist_ok=True)

    def finish(key, val):
        results[key] = val
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"{key}: {val}", flush=True)

    if "ours" in arms:
        ckpt_dir = os.path.dirname(args.ours_ckpt)
        step = int(os.path.basename(args.ours_ckpt))
        fn = build_scorer(ckpt_dir, step, False, orig_root, device)
        os.environ["I2VSGG_DATA_ROOT"] = hard_root
        try:
            finish("ours_hard", eval_video_rel(fn, hard_root))
        finally:
            os.environ["I2VSGG_DATA_ROOT"] = orig_root

    print(json.dumps({k: v for k, v in results.items()
                      if k.endswith("_hard")}))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
