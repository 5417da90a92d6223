"""Quality A/B of the int8 fc6/fc7 serving path (``DenseInt8``) — the port's
counterpart of the JAX package's ``tools/quant_ab.py``, with its flags plus
``--depth`` and ``--device``.

One trained Stage B checkpoint is scored twice, with the fc6/fc7 tower in
f32 and as ``DenseInt8`` (the same tensors, weights quantized per output
channel and activations per row at run time), on the parity harness's
Stage B metrics (``parity_run.eval_sgg``: predicate top-1 and pred mAP over
the test split's GT pairs) and, with ``--stage_c``, the video relation
pipeline (``eval_video_rel``: rel mAP, R@50, ...). ``delta`` is int8 - f32
for every float metric. ``bench.py::_gate_int8`` reads the JSON.

The scorer's trunk is built at ``parity_run.HP["depth"]`` (``--depth``,
default 50). Where the checkpoint's trunk has another depth, the JAX tool
loads the names the two share and scores a truncated trunk without a word
(a res50 scorer takes a res101 checkpoint's first 6 layer3 blocks); this
tool raises ``ValueError`` naming both depths.

The data root is ``<out>/data``; the checkpoint ``--ckpt
<ckpt_dir>/<step>``, else the newest of ``<out>/res<depth>/MVRD_SGG/
session_<951 + seed>``. ``--json`` defaults to
``runs/torch_quant_ab/quant_ab.json``, not to the JAX tool's committed
``runs/quant_ab/quant_ab.json``.

Usage:
  python -m i2vsgg_tpu_torch.tools.quant_ab --out runs/torch_gate_arm \\
      --depth 101 --stage_c [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def checkpoint_depth(ckpt_dir: str, step: int):
    """The ResNet depth of the checkpoint's ``trunk``, from its blocks a
    stage (``models/backbones.py::RESNET_STAGES``), or None without one."""
    from i2vsgg_tpu_torch.models.backbones import RESNET_STAGES
    from i2vsgg_tpu_torch.train.checkpoint import load_state_dict
    blocks = [set() for _ in range(3)]
    for name in load_state_dict(ckpt_dir, step):
        parts = name.split(".")
        if (len(parts) > 2 and parts[0] == "trunk"
                and parts[1] in ("layer1", "layer2", "layer3")):
            blocks[int(parts[1][-1]) - 1].add(parts[2])
    counts = tuple(len(b) for b in blocks)
    for depth, stages in RESNET_STAGES.items():
        if stages[:3] == counts:
            return depth
    return None


def build_scorer(ckpt_dir, step, int8, data_root, device="cuda"):
    """The scorer of checkpoint ``<ckpt_dir>/<step>`` (``parity_run.
    sgg_scorer``: 8 boxes, 56 pairs): an ``SGGModel`` with an f32 trunk at
    ``HP["depth"]`` and the default head, its fc6/fc7 ``DenseInt8`` with
    ``int8``. A checkpoint whose trunk has another depth raises
    ``ValueError``."""
    from i2vsgg_tpu_torch.models.backbones import ResNetTrunk
    from i2vsgg_tpu_torch.models.layers import init_weights
    from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
    from i2vsgg_tpu_torch.tools.parity_run import HP, sgg_scorer
    from i2vsgg_tpu_torch.train.checkpoint import restore_intersection

    held = checkpoint_depth(ckpt_dir, step)
    if held != HP["depth"]:
        raise ValueError(
            f"{ckpt_dir}@{step} holds a res{held} trunk; the scorer builds "
            f"res{HP['depth']} (--depth {held}): scoring it would load the "
            "layers the two share and leave the rest")
    model = SGGModel(VRDHead(int8_fc=int8),
                     trunk=ResNetTrunk(depth=HP["depth"],
                                       dtype=torch.float32))
    init_weights(model, torch.Generator().manual_seed(0))
    restore_intersection(ckpt_dir, step, model)
    return sgg_scorer(model, device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/parity_r3",
                    help="parity campaign dir holding the data and the "
                         "Stage B checkpoint")
    ap.add_argument("--seed", type=int, default=0,
                    help="ours Stage B session = 951 + seed")
    ap.add_argument("--ckpt", default="",
                    help="explicit checkpoint <ckpt_dir>/<step> (overrides "
                         "--out's session)")
    ap.add_argument("--stage_c", action="store_true",
                    help="also run the video relation-detection eval")
    ap.add_argument("--json", default="runs/torch_quant_ab/quant_ab.json")
    ap.add_argument("--depth", type=int, default=None,
                    help="the scorer's trunk depth (parity_run.HP's, 50, by "
                         "default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from i2vsgg_tpu_torch.tools.parity_run import HP, eval_sgg, eval_video_rel
    from i2vsgg_tpu_torch.train.checkpoint import latest_step
    from i2vsgg_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.depth is not None:
        HP["depth"] = args.depth
    data_root = os.path.join(args.out, "data")
    os.environ["I2VSGG_DATA_ROOT"] = data_root

    if args.ckpt:
        ckpt_dir = os.path.dirname(args.ckpt)
        step = int(os.path.basename(args.ckpt))
    else:
        ckpt_dir = os.path.join(args.out, f"res{HP['depth']}", "MVRD_SGG",
                                f"session_{951 + args.seed}")
        step = latest_step(ckpt_dir)
    if not step:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    print(f"checkpoint: {ckpt_dir}/{step}")

    results = {"ckpt": f"{ckpt_dir}/{step}"}
    for arm, int8 in (("fp32", False), ("int8", True)):
        fn = build_scorer(ckpt_dir, step, int8, data_root, device)
        r = eval_sgg(fn)
        if args.stage_c:
            r.update(eval_video_rel(fn, data_root))
        results[arm] = r
        print(f"{arm}: {json.dumps(r)}")
    results["delta"] = {
        k: results["int8"][k] - results["fp32"][k]
        for k in results["fp32"] if isinstance(results["fp32"][k], float)}
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["delta"]))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
