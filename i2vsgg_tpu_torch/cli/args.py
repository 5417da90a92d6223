"""Shared CLI flag surface of the port's drivers — the port's own copy of
``i2vsgg_tpu/cli/args.py`` (``parse_args``, ``set_dataset_args``), whose
flag names and defaults follow the reference's
``lib/model/utils/parser_func.py:5-213``.

The port adds ``--device`` (default ``cuda``): the drivers run on the card
and raise without one (``utils/device.resolve_device``); ``--device cpu``
runs them on the CPU, as the tests do.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train/eval an I2VSGG network")
    # datasets / net [parser_func.py:10-27]
    p.add_argument("--dataset", default="MVRD", type=str,
                   help="source training dataset")
    p.add_argument("--dataset_t", default="MVidVRD", type=str,
                   help="target training dataset")
    p.add_argument("--net", default="res101", type=str,
                   help="vgg16, res50, res101")
    # schedule
    p.add_argument("--start_epoch", default=1, type=int)
    p.add_argument("--epochs", dest="max_epochs", default=20, type=int)
    p.add_argument("--gamma", default=5, type=float)
    p.add_argument("--disp_interval", default=100, type=int)
    p.add_argument("--checkpoint_interval", default=10000, type=int)
    p.add_argument("--save_dir", default="models", type=str)
    p.add_argument("--load_name", default="models", type=str)
    p.add_argument("--nw", dest="num_workers", default=0, type=int)
    # accepted-and-ignored GPU flags so reference scripts run unchanged
    p.add_argument("--cuda", action="store_true",
                   help="[ignored: see --device]")
    p.add_argument("--mGPUs", action="store_true",
                   help="[ignored]")
    # DA knobs [parser_func.py:53-67]
    p.add_argument("--gc", action="store_true",
                   help="global-level context vector")
    p.add_argument("--ic", action="store_true",
                   help="instance-level context vector")
    p.add_argument("--cr", action="store_true",
                   help="consistency regularization")
    p.add_argument("--ls", dest="large_scale", action="store_true")
    p.add_argument("--bs", dest="batch_size", default=1, type=int)
    p.add_argument("--cag", dest="class_agnostic", action="store_true")
    p.add_argument("--vis", action="store_true")
    # optimization [parser_func.py:78-112]
    p.add_argument("--o", dest="optimizer", default="sgd", type=str)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--eta", default=0.1, type=float)
    p.add_argument("--eta_uplmt", default=1, type=float)
    p.add_argument("--eta_style", default=0.01, type=float)
    p.add_argument("--lr_decay_step", default=5, type=int)
    p.add_argument("--lr_decay_gamma", default=0.1, type=float)
    p.add_argument("--s", dest="session", default=1, type=int)
    # --resume: under torchrun, whose own parser takes --r for an
    # abbreviation of its options (--rdzv-*, --role, --run-path, ...)
    p.add_argument("--r", "--resume", dest="resume", action="store_true")
    p.add_argument("--checksession", default=1, type=int)
    p.add_argument("--checkepoch", default=1, type=int)
    p.add_argument("--checkpoint", default=0, type=int)
    # logging [parser_func.py:115-126]
    p.add_argument("--use_tfb", dest="use_tfboard", action="store_true")
    p.add_argument("--tfb_path", type=str)
    p.add_argument("--image_dir", default="images")
    # style [parser_func.py:131-137]
    p.add_argument("--transform_method", default="scale", type=str)
    p.add_argument("--style_lambda", default=1e7, type=float)
    # vrd knobs [parser_func.py:139-196]
    p.add_argument("--num_classes", default=15, type=int)
    p.add_argument("--num_relations", default=62, type=int)
    p.add_argument("--zero_init_residual", action="store_true",
                   help="zero every bottleneck's bn3 scale at init "
                        "(training only; synthetic harnesses)")
    p.add_argument("--uint8_upload", action="store_true",
                   help="eval/serve: upload resized uint8 BGR frames and do "
                        "the mean subtraction on the device (4x smaller "
                        "host-to-device copies). Differs from the f32 "
                        "transport only by the uint8 rounding of resized "
                        "pixels")
    p.add_argument("--max_pairs", default=64, type=int,
                   help="static per-image pair padding in SGG training")
    p.add_argument("--source_so_prior_path",
                   default="./data/MVidVRD/source_so_prior.pkl")
    p.add_argument("--source_gt_rels_path",
                   default="./data/MVidVRD/source_gt_rels.pkl")
    p.add_argument("--target_gt_rels_path",
                   default="./data/MVidVRD/target_gt_rels.pkl")
    p.add_argument("--use_obj_visual", default=True, type=_bool)
    p.add_argument("--use_semantic", default=True, type=_bool)
    p.add_argument("--spatial_type", default=2, type=int)
    p.add_argument("--vrd_task", default="rel_det", type=str,
                   choices=("rel_det", "pre_det"))
    p.add_argument("--vrd_lr", default=1e-5, type=float)
    p.add_argument("--decay_spe", default=0, type=int,
                   help="steps-per-epoch anchor for the SGG lr decay; 0 = "
                        "the loader's length")
    p.add_argument("--glove_path", default="./models/glove.6B.300d.txt")
    p.add_argument("--predicate_file",
                   default="./data/MVidVRD/predicates.json")
    p.add_argument("--emb_dim", default=300, type=int)
    p.add_argument("--vrd_fc_dim", default=4096, type=int,
                   help="fc6/fc7 width of the vrd head (4096 = reference)")
    p.add_argument("--vrd_pooling", default="pool",
                   choices=("pool", "align"),
                   help="vrd-head roi pooling: 'pool' = reference parity "
                        "(resnet_SGG_emb.py:82 ROIPool), 'align' = "
                        "RoIAlignAvg (train and serve must match). Recorded "
                        "in SGG checkpoint metadata; eval/serve read it back")
    p.add_argument("--int8_fc6", action="store_true",
                   help="eval/serve: run the vrd fc6/fc7 towers as int8 "
                        "products (DenseInt8, checkpoint-compatible names)")
    p.add_argument("--act_scales", default="",
                   help="eval/serve: calibration JSON — with --int8_trunk "
                        "mxu:<scope> or sim:<scope>, pre-quantize the "
                        "in-scope trunk kernels and use static per-tensor "
                        "activation scales instead of the per-conv dynamic "
                        "abs-max")
    p.add_argument("--int8_trunk", nargs="?", const="mxu", default="off",
                   help="eval/serve: run the ResNet bottleneck convs "
                        "int8-quantized (per-out-channel weights, "
                        "per-tensor activations; BNConv, "
                        "models/backbones.py): 'mxu' (the bare-flag "
                        "default) or 'sim' (fake-quant: the same integer "
                        "taps convolved in f32, the quality gate's mode), "
                        "with an optional layer scope, e.g. "
                        "'mxu:layer3,@3x3'")
    p.add_argument("--semi", action="store_true")
    p.add_argument("--mesh", default=0, type=int,
                   help="data parallelism. Training: the world size, one "
                        "process a card (launch with torchrun "
                        "--nproc_per_node N; --bs is per process); 0 takes "
                        "the world size, another value is refused. "
                        "serve_video: N local devices in one process (0: "
                        "one device). test_det/test_sgg: ignored, they run "
                        "on one device, as the JAX drivers do")
    p.add_argument("--pretrained_backbone", default="",
                   help="torch .pth (torchvision/caffe-converted layout) to "
                        "initialize the backbone from (reference: "
                        "cfg.RESNET_PATH, lib/model/utils/config.py:246-248)")
    p.add_argument("--pretrained_full", action="store_true",
                   help="with a jwyang-layout --pretrained_backbone: load "
                        "every matching tensor")
    p.add_argument("--clip", default=-1.0, type=float,
                   help="global-norm gradient clip; -1 = auto (10 for "
                        "vgg16, off otherwise)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--max_steps", default=0, type=int,
                   help="hard step cap (0 = full epochs); for smoke runs")
    p.add_argument("--keep_ckpts", default=0, type=int,
                   help="keep only the newest K epoch checkpoints (plus the "
                        "best-metric one); 0 = keep all")
    p.add_argument("--video_ann", default="",
                   help="video_annotations JSON for relation metrics")
    p.add_argument("--profile_dir", default="",
                   help="trainval_det_da: a torch.profiler trace of "
                        "steps 10-20 (trace.json; under torchrun "
                        "trace_rank<r>.json, one a rank)")
    p.add_argument("--cfg", dest="extra_cfgs", nargs="*", default=[],
                   help="extra KEY VALUE config overrides "
                        "(reference cfg_from_list format)")
    p.add_argument("--frame_map", default="",
                   help="frame->(video,fno) map pickle (data/VidOR/map.pkl)")
    # the port's addition
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def _bool(v):
    return str(v).lower() in ("1", "true", "yes")


# dataset name -> (train imdb, val imdb) wiring; extends the reference's
# MVRD/MVidVRD-only table [parser_func.py:193-213] to all four datasets.
_WIRING = {
    "MVRD": ("MVRD_trainval", "MVRD_test"),
    "MVidVRD": ("MVidVRD_val", "MVidVRD_test"),
    "MVG": ("MVG_trainval", "MVG_test"),
    "MVidOR": ("MVidOR_val", "MVidOR_test"),
}

_SET_CFGS = ["ANCHOR_SCALES", "[8, 16, 32]", "ANCHOR_RATIOS", "[0.5, 1, 2]",
             "TRAIN.MAX_NUM_GT_BOXES", "30"]


def set_dataset_args(args, test: bool = False):
    """Attach imdb names + cfg overrides. [parser_func.py:193-213]

    Sets ``I2VSGG_INT8_TRUNK`` from ``--int8_trunk`` (``1[:scope]`` for
    ``mxu``, ``sim[:scope]`` for ``sim``) or removes it (``off``), so that
    a stale shell value cannot leak into a run."""
    mode = getattr(args, "int8_trunk", "off") or "off"
    kind, _, only = mode.partition(":")
    scope = f":{only}" if only else ""
    if kind == "mxu":
        os.environ["I2VSGG_INT8_TRUNK"] = "1" + scope
    elif kind == "sim":
        os.environ["I2VSGG_INT8_TRUNK"] = "sim" + scope
    elif kind == "off":
        os.environ.pop("I2VSGG_INT8_TRUNK", None)
    else:
        raise ValueError(f"--int8_trunk: unknown kind {kind!r} "
                         "(off | mxu[:layers] | sim[:layers])")
    if args.dataset not in _WIRING:
        raise KeyError(f"unknown --dataset {args.dataset}")
    # test drivers evaluate the target's test split [parser_func.py:205]
    args.imdb_name = _WIRING[args.dataset][0]
    args.imdbval_name = _WIRING[args.dataset][1]
    args.set_cfgs = list(_SET_CFGS)
    if not test and getattr(args, "dataset_t", None):
        if args.dataset_t not in _WIRING:
            raise KeyError(f"unknown --dataset_t {args.dataset_t}")
        args.imdb_name_target = _WIRING[args.dataset_t][0]
        args.imdbval_name_target = _WIRING[args.dataset_t][1]
        args.set_cfgs_target = list(_SET_CFGS)
    # net -> YAML config wiring [parser_func.py:210-212]
    args.cfg_file = (f"cfgs/{args.net}_ls.yml" if args.large_scale
                     else f"cfgs/{args.net}.yml")
    return args
