"""Quality A/B of the int8 trunk (``--int8_trunk``) — the port's counterpart
of the JAX package's ``tools/quant_trunk_ab.py``, with its flags and
defaults plus ``--device``.

One Stage A checkpoint is evaluated twice by the port's ``test_det`` on
each dataset's test split: the float arm, then the int8 arm with
``--int8_trunk <mode>`` (default ``sim``, the fake-quant twin: the same
integer taps convolved in f32; ``mxu:<scope>`` runs the int8 products)
and, with ``--act_scales``, the static activation scales of a calibration
file (``calibrate_act_scales``). Each evaluation writes its detections
under its own ``<out>/eval_pid<pid>`` (concurrent runs sharing a directory
would corrupt each other's files). The JSON is the JAX tool's: ``ckpt``,
``mode``, ``net``, ``ckpt_fingerprint``, ``act_scales``, ``fp`` and
``int8`` (``{dataset: {"mAP", "eval_s"}}``) and ``delta`` (int8 - fp).

``--reuse_fp <json>`` copies the float arm of an earlier run instead of
evaluating it again, refused with ``ValueError`` (JAX's tool asserts)
unless that run named the same checkpoint path, its fingerprint (names,
sizes and mtimes of the checkpoint's ``step_%08d/`` files) equals this
one's, and it evaluated every dataset.

Usage:
  python -m i2vsgg_tpu_torch.tools.quant_trunk_ab --out runs/ab \\
      --ckpt models/res101/MVRD/session_1/<step> --net res101 \\
      --mode mxu:layer2,layer3,layer4,@3x3 \\
      --act_scales runs/calib/act_scales.json [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time


def ckpt_fingerprint(ckpt: str) -> str:
    """Content fingerprint of the port's checkpoint ``<ckpt_dir>/<step>``:
    the relative names, sizes and mtimes of the files under
    ``<ckpt_dir>/step_%08d/`` (no reads). It changes whenever the checkpoint
    is rewritten, which ``--reuse_fp`` has to detect."""
    step = int(os.path.basename(ckpt))
    path = os.path.join(os.path.dirname(ckpt), f"step_{step:08d}")
    h = hashlib.sha1()
    for root, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            st = os.stat(os.path.join(root, f))
            h.update(f"{os.path.relpath(os.path.join(root, f), path)}"
                     f":{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/parity_r3")
    ap.add_argument("--ckpt", required=True,
                    help="Stage A checkpoint in the port's format: "
                         "<ckpt_dir>/<step>")
    ap.add_argument("--data", default="",
                    help="data root the checkpoint was trained on "
                         "(default <out>/data)")
    ap.add_argument("--net", default="res50")
    ap.add_argument("--dataset", default="MVRD")
    ap.add_argument("--dataset_t", default="",
                    help="optional second (target-domain) eval dataset")
    ap.add_argument("--cfg", nargs="*", default=[],
                    help="config overrides matching the checkpoint")
    ap.add_argument("--rpn_topn", type=int, default=128)
    ap.add_argument("--pre_nms", type=int, default=1024)
    ap.add_argument("--max_det", type=int, default=16)
    ap.add_argument("--json",
                    default="runs/quant_trunk_ab/quant_trunk_ab.json")
    ap.add_argument("--mode", default="sim",
                    help="the int8 arm's --int8_trunk value: 'sim' "
                         "(fake-quant) or 'mxu', with an optional scope, "
                         "e.g. 'sim:layer1,layer2'")
    ap.add_argument("--act_scales", default="",
                    help="calibration JSON (calibrate_act_scales): gate the "
                         "static-activation-scale int8 arm instead of the "
                         "dynamic abs-max")
    ap.add_argument("--reuse_fp", default="",
                    help="an earlier quant_trunk_ab.json whose fp arm used "
                         "the same checkpoint and datasets: copy it instead "
                         "of evaluating it again")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def reused_fp(path: str, results: dict, datasets: list) -> dict:
    """The fp arm of the earlier run ``path``, refused (``ValueError``) as
    the JAX tool refuses it: another checkpoint path, another fingerprint,
    or a dataset it did not evaluate."""
    with open(path) as f:
        prev = json.load(f)
    ckpt = results["ckpt"]
    if prev["ckpt"] != ckpt:
        raise ValueError(f"--reuse_fp arm was evaluated on {prev['ckpt']}, "
                         f"not {ckpt}")
    # the same path may hold a checkpoint rewritten since: compare contents
    prev_fpr = prev.get("ckpt_fingerprint")
    if prev_fpr is not None and prev_fpr != results["ckpt_fingerprint"]:
        raise ValueError(
            f"--reuse_fp arm was evaluated on a different {ckpt} "
            f"(fingerprint {prev_fpr} != {results['ckpt_fingerprint']}): the "
            "checkpoint was rewritten since; evaluate the fp arm again")
    if prev_fpr is None:
        print("WARNING: the --reuse_fp artifact has no checkpoint "
              "fingerprint; its fp arm cannot be checked against this "
              "checkpoint")
    missing = [ds for ds in datasets if ds not in prev["fp"]]
    if missing:
        raise ValueError(f"--reuse_fp arm lacks datasets {missing}")
    return {ds: prev["fp"][ds] for ds in datasets}


def main(argv=None) -> dict:
    from i2vsgg_tpu_torch.tools.test_det import main as eval_main

    args = parse_args(argv)
    os.environ["I2VSGG_DATA_ROOT"] = args.data or os.path.join(args.out,
                                                               "data")
    ckpt = args.ckpt
    datasets = [args.dataset] + ([args.dataset_t] if args.dataset_t else [])
    results = {"ckpt": ckpt, "mode": args.mode, "net": args.net,
               "ckpt_fingerprint": ckpt_fingerprint(ckpt)}
    if args.act_scales:
        results["act_scales"] = args.act_scales
    if args.reuse_fp:
        results["fp"] = reused_fp(args.reuse_fp, results, datasets)
        results["fp_reused_from"] = args.reuse_fp
        print("fp arm reused:",
              {ds: results["fp"][ds]["mAP"] for ds in datasets})
    for arm in ("fp", "int8"):
        if arm in results:
            continue
        lever = []
        if arm == "int8":
            lever = ["--int8_trunk", args.mode] + (
                ["--act_scales", args.act_scales] if args.act_scales else [])
        r = {}
        for ds in datasets:
            t0 = time.time()
            aps = eval_main(lever + [
                "--dataset", ds, "--net", args.net, "--bs", "1", "--ic",
                "--gc", "--save_dir",
                os.path.join(args.out, f"eval_pid{os.getpid()}"),
                "--load_name", ckpt, "--device", args.device,
                "--cfg"] + list(args.cfg) + [
                    "TEST.RPN_POST_NMS_TOP_N", str(args.rpn_topn),
                    "TEST.RPN_PRE_NMS_TOP_N", str(args.pre_nms),
                    "TEST.MAX_DETECTIONS_PER_IMAGE", str(args.max_det)])
            r[ds] = {"mAP": float(aps["mAP"]),
                     "eval_s": round(time.time() - t0, 1)}
            print(f"{arm}/{ds}: mAP {r[ds]['mAP']:.4f} "
                  f"({r[ds]['eval_s']}s)")
        results[arm] = r
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    results["delta"] = {ds: results["int8"][ds]["mAP"]
                        - results["fp"][ds]["mAP"] for ds in datasets}
    with open(args.json, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["delta"]))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
