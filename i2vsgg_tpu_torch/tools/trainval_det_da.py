"""Stage A: adversarial domain-adaptive detector training — the port's
counterpart of the JAX package's ``tools/trainval_det_da.py`` (rebuild of
``trainval_net_instance_styleD_bilinear.py:48-437``): source detection
losses and the target's LSGAN discriminator passes in one training step
(``train/det_da.py``), epoch-boundary lr decay, a checkpoint at the end of
every epoch with the reference's metadata, and the reference's loss names in
``<ckpt_dir>/logs/metrics.jsonl``.

Checkpoints go to ``<save_dir>/<net>/<dataset>/session_<s>/step_%08d``, in
the port's format (``train/checkpoint.py``); ``--r`` resumes from the newest
one there (weights, momentum, step), ``--load_name <dir>/<step>`` starts from
a detector without its heads, ``--pretrained_backbone`` from a torchvision
or jwyang state dict. The port's loader decodes PNG and JPEG
(``data/image_io.py``), so the paper's pairing runs as it is: the MVRD
stills (JPEG) as the source, the MVidVRD frames (PNG) as the target.

Data parallel on N cards: ``torchrun --nproc_per_node N -m
i2vsgg_tpu_torch.tools.trainval_det_da ... --bs <per card>``, one process a
card (``parallel/mesh.py``): each rank loads its slice of both roidbs, the
step is the global batch's (``train/det_da.py``), rank 0 writes the
checkpoints and the metrics.

Usage (as scripts/port_instance_styleD_resnet101.sh runs it):
  python -m i2vsgg_tpu_torch.tools.trainval_det_da --dataset MVRD \\
      --dataset_t MVidVRD --net res101 --lr 5e-4 --lr_decay_step 10 \\
      --epochs 10 --eta 0.1 --eta_style 0.001 --style_lambda 1 --ic --gc \\
      [--device cpu]
"""

from __future__ import annotations

import os
import sys

import torch


def _to_device(batch, dev):
    return {k: torch.as_tensor(batch[k]).to(dev)
            for k in ("image", "im_info", "gt_boxes")}


def _pretrained(model, path: str, net: str, full: bool):
    """``--pretrained_backbone``: a jwyang detector (every tensor but the
    ``DETECTOR_INIT_EXCLUDE`` heads, or all with ``--pretrained_full``) or a
    torchvision-layout backbone (trunk and head)."""
    from i2vsgg_tpu_torch.train.checkpoint import DETECTOR_INIT_EXCLUDE
    from i2vsgg_tpu_torch.utils import torch_import as ti
    sd = ti.load_torch_checkpoint(path)
    if "RCNN_base.0.weight" in sd:
        imported = ti.jwyang_detector_params(sd, int(net[3:]))
        if not full:
            imported = {k: v for k, v in imported.items()
                        if not any(f".{t}." in f".{k}."
                                   for t in DETECTOR_INIT_EXCLUDE)}
    elif net == "vgg16":
        imported = {**ti.prefixed("trunk", ti.vgg16_trunk_params(sd)),
                    **ti.prefixed("head", ti.vgg16_head_params(sd))}
    else:
        depth = int(net[3:])
        imported = {**ti.prefixed("trunk", ti.resnet_trunk_params(sd, depth)),
                    **ti.prefixed("head", ti.resnet_head_params(sd, depth))}
    ti.merge_imported(model, imported)
    print(f"backbone initialized from {path}")


def main(argv=None):
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.data.pipeline import DetectionLoader
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
    from i2vsgg_tpu_torch.models.inits import init_module, zero_init_residual
    from i2vsgg_tpu_torch.parallel.mesh import replicate
    from i2vsgg_tpu_torch.tools.common import (ckpt_of, config_from_args,
                                               init_data_parallel)
    from i2vsgg_tpu_torch.train.checkpoint import (latest_step,
                                                   restore_detector_init,
                                                   restore_full,
                                                   save_on_rank0)
    from i2vsgg_tpu_torch.train.det_da import TrainState, train_step
    from i2vsgg_tpu_torch.train.optim import (ReferenceSGD,
                                              step_decay_schedule)
    from i2vsgg_tpu_torch.utils.device import resolve_device
    from i2vsgg_tpu_torch.utils.logging import (MetricsLogger, StepTimer,
                                                start_profiler)

    args = set_dataset_args(parse_args(argv))
    init_data_parallel(args)
    dev = resolve_device(args.device)
    cfg = config_from_args(args, verbose=True)

    print(f"source roidb: {args.imdb_name}")
    imdb_s, roidb_s, _, idx_s = combined_roidb(args.imdb_name)
    print(f"target roidb: {args.imdb_name_target}")
    _, roidb_t, _, idx_t = combined_roidb(args.imdb_name_target)
    print(f"{len(roidb_s)} source / {len(roidb_t)} target images")
    bs = args.batch_size
    loader_s = DetectionLoader(roidb_s, idx_s, cfg, bs, training=True,
                               seed=cfg.RNG_SEED)
    loader_t = DetectionLoader(roidb_t, idx_t, cfg, bs, training=True,
                               seed=cfg.RNG_SEED + 1)
    print(f"loader: {loader_s.path}")
    steps_per_epoch = min(len(loader_s), len(loader_t))

    model = FasterRCNN_DA(num_classes=len(imdb_s.classes), cfg=cfg,
                          backbone=args.net,
                          class_agnostic=args.class_agnostic, ic=args.ic,
                          gc=args.gc, training_tree=True)
    init_module(model, torch.Generator().manual_seed(cfg.RNG_SEED))
    if args.zero_init_residual:
        zero_init_residual(model)
        print("zero-init-residual: bn3 scales zeroed")
    model.to(dev)
    schedule = step_decay_schedule(args.lr, args.lr_decay_step,
                                   args.lr_decay_gamma, steps_per_epoch)
    # the reference clips at 10 for VGG16; --clip overrides
    clip = args.clip if args.clip >= 0 else (
        10.0 if args.net == "vgg16" else 0.0)
    opt = ReferenceSGD(model, schedule, cfg, clip_norm=clip)
    state = TrainState(model, opt, step=0, seed=cfg.RNG_SEED)

    ckpt_dir = os.path.join(args.save_dir, args.net, args.dataset,
                            f"session_{args.session}")
    if args.resume:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"--r given but no checkpoint in "
                                    f"{ckpt_dir}")
        state.step = restore_full(ckpt_dir, step, model, opt)
        print(f"resumed from step {step}")
    elif ckpt_of(args.load_name) is not None:
        restore_detector_init(*ckpt_of(args.load_name), model)
        print(f"detector-init from {args.load_name} (heads re-initialized)")
    elif args.pretrained_backbone:
        _pretrained(model, args.pretrained_backbone, args.net,
                    args.pretrained_full)
    # every rank starts from rank 0's weights, whatever it drew or read
    replicate(model)

    logger = MetricsLogger(args.tfb_path or os.path.join(ckpt_dir, "logs"),
                           args.use_tfboard)
    timer = StepTimer()
    stop_profiler = None
    start_epoch = state.step // max(steps_per_epoch, 1) + 1
    for epoch in range(start_epoch, args.max_epochs + 1):
        it_s, it_t = iter(loader_s), iter(loader_t)
        for _ in range(steps_per_epoch):
            batch_s = _to_device(next(it_s), dev)
            batch_t = _to_device(next(it_t), dev)
            if args.profile_dir and state.step == 10:
                stop_profiler = start_profiler(args.profile_dir)
            metrics = train_step(state, batch_s, batch_t, eta=args.eta,
                                 eta_style=args.eta_style,
                                 style_lambda=args.style_lambda, cr=args.cr)
            if stop_profiler is not None and state.step == 20:
                stop_profiler()
                stop_profiler = None
                print(f"profiler trace -> {args.profile_dir}")
            timer.tick(bs)
            if state.step % args.disp_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["imgs_per_sec"] = timer.rate()
                logger.log_scalars("train", m, state.step)
                print(f"[session {args.session}][epoch {epoch:2d}]"
                      f"[iter {state.step:6d}] loss: {m['loss']:.4f} "
                      f"rpn_cls {m['loss_rpn_cls']:.4f} "
                      f"rpn_box {m['loss_rpn_box']:.4f} "
                      f"rcnn_cls {m['loss_rcnn_cls']:.4f} "
                      f"rcnn_box {m['loss_rcnn_box']:.4f} "
                      f"d_s {m['dloss_s_p']:.4f} d_t {m['dloss_t_p']:.4f} "
                      f"({m['imgs_per_sec']:.1f} img/s)", flush=True)
            if args.max_steps and state.step >= args.max_steps:
                break
        save_on_rank0(ckpt_dir, model.state_dict(), state.step, metadata={
            "session": args.session, "epoch": epoch,
            "pooling_mode": cfg.POOLING_MODE,
            "class_agnostic": args.class_agnostic, "net": args.net,
            "dataset": args.dataset, "classes": list(imdb_s.classes)},
            optimizer_state=opt.state_dict(),
            keep_last=args.keep_ckpts or None)
        print(f"checkpoint @ step {state.step} (epoch {epoch})", flush=True)
        if args.max_steps and state.step >= args.max_steps:
            break
    if stop_profiler is not None:
        stop_profiler()
    logger.close()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
