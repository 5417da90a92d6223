"""Quality A/B of the serving capacity cuts — the port's counterpart of the
JAX package's ``tools/capacity_ab.py``, with its flags plus ``--device``.

One detector is evaluated by the port's ``test_det`` at several
(``TEST.RPN_PRE_NMS_TOP_N``, ``TEST.RPN_POST_NMS_TOP_N``,
``TEST.MAX_DETECTIONS_PER_IMAGE`` [, ``TEST.MAX_PER_CLASS``]) capacities; a
capacity is validated when its mAP matches the full-capacity row's
(``bench.py``'s ``_gate_rpn_capacity`` and ``_gate_det8`` read the rows).
The detector is trained here (``--steps`` of ``trainval_det_da`` from the
port's init with bn3 zeroed, on a 600x800 learnable corpus written under
``<out>/data``) unless ``--ckpt <ckpt_dir>/<step>`` names one, with
``--data`` and ``--cfg`` the data root and config it was trained with; a
``/res50/`` or ``/res101/`` in that path sets ``--net``.

Rows are keyed ``pre{P}_rpn{N}_det{D}[_mpc{M}]``; the JSON
(``{"step", "ckpt_dir", "dataset", "results": {key: {"mAP", "eval_s"}}}``)
is rewritten after every row, so an interrupted sweep keeps what it ran.
Each evaluation writes its detections under ``<out>/eval_pid<pid>``.
The JSON goes to ``<out>/capacity_ab.json``; ``--out`` defaults to
``runs/torch_capacity_ab``, not to the JAX tool's ``runs/capacity_ab``,
whose committed files ``bench.py`` reads.

Usage:
  python -m i2vsgg_tpu_torch.tools.capacity_ab \\
      --ckpt runs/torch_gate_arm/res101/MVRD/session_902/288 \\
      --data runs/torch_gate_arm/data --cfg <the arm's overrides> \\
      --rows 1024:128:16,512:128:8,1024:128:8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# 600-short-side config, reference anchors (cfgs/res101.yml)
CFG = ["ANCHOR_SCALES", "[4, 8, 16]",
       "TRAIN.SCALES", "[600]", "TEST.SCALES", "[600]",
       "TRAIN.RPN_PRE_NMS_TOP_N", "6000",
       "TRAIN.RPN_POST_NMS_TOP_N", "256",
       "TRAIN.RPN_POST_NMS_TOP_N_TARGET", "128",
       "TEST.RPN_PRE_NMS_TOP_N", "6000",
       "POOLING_MODE", "align"]
# (pre_nms, post_nms, max_det): the reference capacity first, then each
# serving cut on its own and combined; max_det 8 quarters the SGG head's
# pairs (240 -> 56)
SWEEP = [(6000, 300, 100), (6000, 128, 100), (1024, 128, 100),
         (1024, 128, 16), (6000, 300, 16), (1024, 128, 8), (6000, 300, 8)]


def make_data(root, n=200, split=0.4):
    """200 stills at 600x800 (80 trainval) and a 24-still target set."""
    from i2vsgg_tpu_torch.tools.learnable_data import make_learnable_dataset
    os.makedirs(root, exist_ok=True)
    make_learnable_dataset(root, "MVRD", n, ".jpg", seed=11,
                           hw=(600, 800), split_frac=split,
                           min_obj=2, max_obj=6, size_range=(60, 220))
    make_learnable_dataset(root, "MVidVRD", 24, ".png", seed=12,
                           hw=(600, 800), index_fmt="vid00_{:04d}",
                           min_obj=2, max_obj=6, size_range=(60, 220))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/torch_capacity_ab")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--net", default="res101")
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="sweep an existing checkpoint <ckpt_dir>/<step> "
                         "instead of training one")
    ap.add_argument("--data", default="",
                    help="with --ckpt: the data root it was trained on")
    ap.add_argument("--cfg", nargs="*", default=None,
                    help="with --ckpt: the config overrides it was trained "
                         "with, in place of the 600-scale CFG")
    ap.add_argument("--dataset", default="MVRD")
    ap.add_argument("--rows", default="",
                    help="comma-separated pre:post:det[:mpc] rows in place "
                         "of the default 7-row sweep (mpc: "
                         "TEST.MAX_PER_CLASS; 0 or absent ties it to det)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from i2vsgg_tpu_torch.tools.test_det import main as eval_main
    from i2vsgg_tpu_torch.train.checkpoint import latest_step

    args = parse_args(argv)
    cfg = list(CFG if args.cfg is None else args.cfg)
    data_root = args.data or os.path.join(args.out, "data")
    if not args.ckpt and not os.path.isdir(os.path.join(data_root, "MVRD")):
        make_data(data_root)
        print(f"600-scale learnable dataset -> {data_root}")
    os.environ["I2VSGG_DATA_ROOT"] = data_root

    ckpt_dir = os.path.join(args.out, args.net, "MVRD", "session_902")
    if args.ckpt:
        ckpt_dir = os.path.dirname(args.ckpt)
        args.skip_train = True
        # the checkpoint dictates the architecture: a res50 checkpoint under
        # the res101 default would evaluate a mostly random trunk
        for net in ("res50", "res101"):
            if f"/{net}/" in f"/{args.ckpt}/" and args.net != net:
                print(f"--net {args.net} contradicts ckpt path "
                      f"({net}); using {net}")
                args.net = net
    if not args.skip_train:
        from i2vsgg_tpu_torch.tools.trainval_det_da import main as train_main
        train_main([
            "--dataset", "MVRD", "--dataset_t", "MVidVRD",
            "--net", args.net, "--bs", "1",
            "--epochs", "99", "--max_steps", str(args.steps),
            "--lr", "5e-4", "--lr_decay_step", "5",
            "--eta", "0.1", "--eta_style", "0.001", "--style_lambda", "1",
            "--clip", "10", "--ic", "--gc", "--zero_init_residual",
            "--disp_interval", "20", "--s", "902",
            "--save_dir", args.out, "--device", args.device, "--cfg"] + cfg)

    step = (int(os.path.basename(args.ckpt)) if args.ckpt
            else latest_step(ckpt_dir))
    if not step:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")

    sweep = SWEEP
    if args.rows:
        sweep = [tuple(int(x) for x in row.split(":"))
                 for row in args.rows.split(",")]
    results = {}
    for row in sweep:
        pre_nms, rpn_topn, max_det = row[:3]
        mpc = row[3] if len(row) > 3 else 0
        t0 = time.time()
        aps = eval_main([
            "--dataset", args.dataset, "--net", args.net, "--bs", "1",
            "--ic", "--gc",
            # a detections directory a process: two sweeps sharing one
            # would interleave their per-class files
            "--save_dir", os.path.join(args.out, f"eval_pid{os.getpid()}"),
            "--load_name", os.path.join(ckpt_dir, str(step)),
            "--device", args.device,
            "--cfg"] + cfg + ["TEST.RPN_POST_NMS_TOP_N", str(rpn_topn),
                              "TEST.RPN_PRE_NMS_TOP_N", str(pre_nms),
                              "TEST.MAX_DETECTIONS_PER_IMAGE", str(max_det),
                              "TEST.MAX_PER_CLASS", str(mpc)])
        key = (f"pre{pre_nms}_rpn{rpn_topn}_det{max_det}"
               + (f"_mpc{mpc}" if mpc else ""))
        results[key] = {"mAP": float(aps["mAP"]),
                        "eval_s": round(time.time() - t0, 1)}
        print(f"{key}: mAP {results[key]['mAP']:.4f}")
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "capacity_ab.json"), "w") as f:
            json.dump({"step": step, "ckpt_dir": ckpt_dir,
                       "dataset": args.dataset, "results": results},
                      f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
