"""Train the res101 Stage A checkpoint that the serving gates evaluate — the
port's counterpart of the JAX package's ``tools/train_gate_arm.py``, with
its flags plus ``--device``.

The gates (``capacity_ab``, ``quant_trunk_ab``, ``calibrate_act_scales``)
must judge the architecture the serving program deploys,
``FasterRCNN_DA(backbone="res101")``, on a detector that learned something:
``bench.py`` voids a gate whose float arm scores below 0.15. This tool
trains it with the port's ``trainval_det_da`` on a seeded learnable corpus
(``learnable_data.py``), written under ``--data`` (default ``<out>/data``)
when it is absent; a root holding only part of the corpus is refused.

Profiles: ``parity240`` (the default), the parity campaign's corpus and
recipe (``parity_run.HP`` and ``CFG_OVERRIDES``: 300 stills at 240x320 of
which 48 train, 20 videos of 24 frames), x0.1 at every ``--lr_decay_step``
epochs (2: at step 192 of 288); ``bench600``, the bench's serving scale
and anchors (``cfgs/res101.yml``) on 600x800 stills.

The JAX tool starts from the torch reference's random init, exported and
converted (``parity_run.shared_init``, ``--pretrained_backbone <pth>
--pretrained_full``), which needs the reference's sources. The port passes
``--zero_init_residual`` in their place: its own seeded init with every
bn3 scale zeroed, as the JAX driver trains without the reference. Every
other flag is the JAX tool's.

Checkpoints: ``<out>/res<depth>/MVRD/session_<901 + seed>/step_%08d``;
``--out`` defaults to ``runs/torch_gate_arm``, not to the JAX tool's
``runs/parity_r5``, so that no run of the port writes into the JAX
campaign's directory.

Usage:
  python -m i2vsgg_tpu_torch.tools.train_gate_arm \\
      [--profile bench600] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

CORPUS_FILES = (("MVRD",), ("MVidVRD",), ("MVidVRD", "source_so_prior.pkl"))


def _missing(data_root: str) -> list:
    """The corpus's parts absent from ``data_root``; a root holding some
    but not all of them raises ``SystemExit`` (delete it to regenerate)."""
    required = [os.path.join(data_root, *p) for p in CORPUS_FILES]
    missing = [p for p in required if not os.path.exists(p)]
    if missing and len(missing) < len(required):
        raise SystemExit(
            f"partial data root {data_root}: missing {missing} while other "
            "artifacts exist — delete the directory and rerun to regenerate "
            "a consistent corpus")
    return missing


def ensure_parity_data(data_root: str):
    """The parity corpus (300 stills, 48 of them trainval; 20 videos of 24
    frames, 10 trainval), written when absent."""
    from i2vsgg_tpu_torch.tools.parity_run import make_data
    if _missing(data_root):
        make_data(data_root, n_source=300, source_split=0.16,
                  n_target=20, target_split=0.5, video_target=True,
                  n_frames=24, hard_videos=False)
        print(f"parity dataset regenerated -> {data_root}", flush=True)


BENCH600_CFG = ["ANCHOR_SCALES", "[4, 8, 16]",
                "TRAIN.SCALES", "[600]", "TEST.SCALES", "[600]",
                "TRAIN.RPN_PRE_NMS_TOP_N", "6000",
                "TRAIN.RPN_POST_NMS_TOP_N", "256",
                "TRAIN.RPN_POST_NMS_TOP_N_TARGET", "128",
                "TEST.RPN_PRE_NMS_TOP_N", "6000",
                "POOLING_MODE", "align"]


def ensure_bench600_data(data_root: str):
    """The 600-short-side corpus at the bench's serving scale (200 MVRD
    stills at 600x800, 80 trainval; 100 target stills, 80 trainval, so that
    both domains give 160 steps an epoch with flips), written when
    absent."""
    from i2vsgg_tpu_torch.tools import learnable_data
    if not _missing(data_root):
        return
    os.makedirs(data_root, exist_ok=True)
    learnable_data.make_learnable_dataset(
        data_root, "MVRD", 200, ".jpg", seed=11, hw=(600, 800),
        split_frac=0.4, min_obj=2, max_obj=6, size_range=(60, 220))
    learnable_data.make_learnable_dataset(
        data_root, "MVidVRD", 100, ".png", seed=12, hw=(600, 800),
        index_fmt="vid00_{:04d}", split_frac=0.8, min_obj=2, max_obj=6,
        size_range=(60, 220))
    import pickle

    import numpy as np
    prior = np.random.RandomState(9).dirichlet(np.ones(5), size=(15, 15))
    with open(os.path.join(data_root, "MVidVRD",
                           "source_so_prior.pkl"), "wb") as f:
        pickle.dump(prior, f)
    print(f"bench600 dataset -> {data_root}", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/torch_gate_arm")
    ap.add_argument("--data", default="",
                    help="data root (default <out>/data)")
    ap.add_argument("--steps", type=int, default=288)
    ap.add_argument("--depth", type=int, default=101)
    ap.add_argument("--lr_decay_step", type=int, default=2,
                    help="decay x0.1 every N epochs")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--profile", default="parity240",
                    choices=["parity240", "bench600"],
                    help="parity240: the parity corpus and recipe; "
                         "bench600: the bench's 600-px scale and anchors")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def train_argv(args, spe: int) -> list:
    """``trainval_det_da``'s command line for the arm, ``spe`` the source
    and target loaders' shorter length."""
    from i2vsgg_tpu_torch.tools import parity_run as pr
    hp = pr.HP
    epochs = max(1, -(-args.steps // spe))
    return [
        "--dataset", "MVRD", "--dataset_t", "MVidVRD",
        "--net", f"res{args.depth}", "--bs", str(hp["bs"]),
        "--epochs", str(epochs), "--max_steps", str(args.steps),
        "--lr", str(hp["lr"]), "--lr_decay_step", str(args.lr_decay_step),
        "--eta", str(hp["eta"]), "--eta_style", str(hp["eta_style"]),
        "--style_lambda", str(hp["style_lambda"]), "--clip", str(hp["clip"]),
        "--zero_init_residual",
        "--ic", "--gc", "--compute_dtype", "float32",
        "--disp_interval", "20", "--s", str(901 + args.seed),
        "--save_dir", args.out, "--cfg"] + pr.CFG_OVERRIDES + [
        "RNG_SEED", str(pr._run_seed(args.seed)), "--device", args.device]


def main(argv=None) -> str:
    """Train the arm; returns its checkpoint directory. Sets
    ``parity_run.HP`` (and, for ``bench600``, ``CFG_OVERRIDES``) for the
    process, as the JAX tool does."""
    from i2vsgg_tpu_torch.tools import parity_run as pr
    from i2vsgg_tpu_torch.tools.trainval_det_da import main as train_main

    args = parse_args(argv)
    pr.HP["depth"] = args.depth
    if args.profile == "bench600":
        pr.HP["scales"] = 600
        pr.HP["anchor_scales"] = [4, 8, 16]
        pr.CFG_OVERRIDES = list(BENCH600_CFG)

    data_root = args.data or os.path.join(args.out, "data")
    if args.profile == "bench600":
        ensure_bench600_data(data_root)
    else:
        ensure_parity_data(data_root)
    os.environ["I2VSGG_DATA_ROOT"] = data_root

    _, ls, lt = pr._loaders(pr._our_cfg(), pr.HP["bs"])
    train_main(train_argv(args, min(len(ls), len(lt))))
    ckpt_dir = os.path.join(args.out, f"res{args.depth}", "MVRD",
                            f"session_{901 + args.seed}")
    print(f"gate arm ckpts -> {ckpt_dir}", flush=True)
    return ckpt_dir


if __name__ == "__main__":
    main(sys.argv[1:])
