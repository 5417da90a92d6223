"""Stage B: relation (SGG) head training on a frozen detector's features —
the port's counterpart of the JAX package's ``tools/trainval_sgg.py``
(the intended flow of ``trainval_net_SGG_emb.py``): GT object pairs of
each source image are scored against the predicate embeddings and trained
with multi-label BCE (``train/sgg.py``); only the ``vrd`` head trains, on a
trunk restored from a Stage A checkpoint (``restore_sgg_init``, the
reference's load mode 3).

GT relations come from a pickle ``{image_index: [(s_idx, pred_id,
o_idx)]}`` keyed by the image's basename (``--source_gt_rels_path``). A
batch without a valid pair is skipped without a step, so the step count
and the lr's decay (``--decay_spe``, else the loader's length) follow the
pair-bearing updates. Checkpoints go to
``<save_dir>/<net>/<dataset>_SGG/session_<s>/step_%08d`` at the end of
every epoch, in the port's format with the JAX driver's metadata
(``vrd_pooling`` among it, which ``test_sgg`` reads back). The port's
loader decodes PNG and JPEG, so it trains on the MVRD stills.

Data parallel on N cards: ``torchrun --nproc_per_node N -m
i2vsgg_tpu_torch.tools.trainval_sgg ... --bs <per card>``: each rank loads
its slice of the roidb, the loss is the global batch's (``train/sgg.py``), a
batch is skipped only when no rank's images have a valid pair (the JAX
driver tests its global batch), and rank 0 writes the checkpoints.

Usage (as scripts/port_SGG_emb_resnet.sh runs it):
  python -m i2vsgg_tpu_torch.tools.trainval_sgg --dataset MVRD \\
      --net res101 --vrd_lr 1e-4 --num_relations 62 \\
      --load_name models/res101/MVRD/session_1/<step> \\
      --source_gt_rels_path data/MVidVRD/source_gt_rels.pkl [--device cpu]
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch


def _pair_batch(batch, roidb, gt_rels, max_pairs: int, n_rel: int):
    """The loader batch's padded pair rows (``build_pair_batch`` per image,
    keyed by the image's basename): ix1, ix2, labels, valid."""
    from i2vsgg_tpu_torch.train.sgg import build_pair_batch
    b = batch["image"].shape[0]
    ix1 = np.zeros((b, max_pairs), np.int64)
    ix2 = np.zeros((b, max_pairs), np.int64)
    labels = np.zeros((b, max_pairs, n_rel), np.float32)
    valid = np.zeros((b, max_pairs), bool)
    for bi, ridx in enumerate(batch["indices"]):
        index = os.path.splitext(os.path.basename(
            roidb[int(ridx)]["image"]))[0]
        ix1[bi], ix2[bi], labels[bi], valid[bi] = build_pair_batch(
            gt_rels.get(index, []), int(batch["num_boxes"][bi]), max_pairs,
            n_rel)
    return ix1, ix2, labels, valid


def main(argv=None):
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.data.pipeline import DetectionLoader
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.models.glove import load_predicate_vectors
    from i2vsgg_tpu_torch.models.inits import init_module
    from i2vsgg_tpu_torch.models.layers import torch_dtype
    from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
    from i2vsgg_tpu_torch.parallel.mesh import global_sum, replicate
    from i2vsgg_tpu_torch.tools.common import (build_trunk, ckpt_of,
                                               config_from_args,
                                               init_data_parallel)
    from i2vsgg_tpu_torch.train.checkpoint import (restore_sgg_init,
                                                   save_on_rank0)
    from i2vsgg_tpu_torch.train.det_da import TrainState
    from i2vsgg_tpu_torch.train.sgg import sgg_optimizer, train_step
    from i2vsgg_tpu_torch.utils.device import resolve_device
    from i2vsgg_tpu_torch.utils.logging import MetricsLogger, StepTimer

    args = set_dataset_args(parse_args(argv))
    init_data_parallel(args)
    dev = resolve_device(args.device)
    cfg = config_from_args(args, verbose=True)

    # flips are off: the relation triples index the ORIGINAL box order
    imdb, roidb, _, idx = combined_roidb(args.imdb_name, use_flipped=False)
    print(f"{len(roidb)} source images ({args.imdb_name})")
    gt_rels = {}
    if os.path.exists(args.source_gt_rels_path):
        with open(args.source_gt_rels_path, "rb") as f:
            gt_rels = pickle.load(f)
        print(f"{len(gt_rels)} images with relation annotations")
    else:
        print(f"WARNING: {args.source_gt_rels_path} not found; "
              "training signal will be empty pairs")

    prd_vecs = torch.as_tensor(load_predicate_vectors(args), device=dev)
    n_rel = prd_vecs.shape[0]
    bs = args.batch_size
    max_pairs = args.max_pairs
    # gt_truncate="first": the triples index the annotation order, so a
    # crowded image keeps its first MAX_NUM_GT_BOXES boxes in order
    loader = DetectionLoader(roidb, idx, cfg, bs, training=True,
                             seed=cfg.RNG_SEED, gt_truncate="first")
    print(f"loader: {loader.path}")
    steps_per_epoch = len(loader)

    model = SGGModel(
        VRDHead(emb_dim=args.emb_dim, spatial_type=args.spatial_type,
                use_obj_visual=args.use_obj_visual, fc_dim=args.vrd_fc_dim,
                pooling=args.vrd_pooling,
                in_channels=512 if args.net == "vgg16" else 1024),
        trunk=build_trunk(args.net, torch_dtype(cfg.COMPUTE_DTYPE)))
    init_module(model, torch.Generator().manual_seed(0))
    ckpt = ckpt_of(args.load_name)
    if ckpt is not None:
        stats = restore_sgg_init(*ckpt, model)
        print(f"trunk restored from Stage-A checkpoint {args.load_name} "
              f"({stats['copied']} of {stats['total']} tensors)")
    model.to(dev)
    # every rank starts from rank 0's weights
    replicate(model)

    # the reference decays vrd_lr by 0.9 every epoch; the step count only
    # advances on pair-bearing updates, so the decay is anchored on that
    # count (--decay_spe when the caller knows it, else the loader length)
    decay_spe = max(args.decay_spe or steps_per_epoch, 1)

    def schedule(step):
        return args.vrd_lr * (0.9 ** (step // decay_spe))

    opt = sgg_optimizer(model, schedule, cfg)
    state = TrainState(model, opt, step=0, seed=cfg.RNG_SEED)

    ckpt_dir = os.path.join(args.save_dir, args.net, f"{args.dataset}_SGG",
                            f"session_{args.session}")
    logger = MetricsLogger(args.tfb_path or os.path.join(ckpt_dir, "logs"),
                           args.use_tfboard)
    timer = StepTimer()
    for epoch in range(args.start_epoch, args.max_epochs + 1):
        for batch in loader:
            ix1, ix2, labels, valid = _pair_batch(batch, roidb, gt_rels,
                                                  max_pairs, n_rel)
            if not int(global_sum(torch.tensor(int(valid.any())))):
                # no relation in the (global) batch: nothing to learn, no
                # step taken, on every rank alike
                continue
            b = batch["image"].shape[0]
            sgg_batch = {
                "image": torch.as_tensor(batch["image"]).to(dev),
                "im_info": torch.as_tensor(batch["im_info"]).to(dev),
                "obj_boxes": torch.as_tensor(
                    batch["gt_boxes"][:, :, :4]).to(dev),
                "ix1": torch.as_tensor(ix1).to(dev),
                "ix2": torch.as_tensor(ix2).to(dev),
                "pair_valid": torch.as_tensor(valid).to(dev),
                "rel_labels": torch.as_tensor(labels).to(dev)}
            metrics = train_step(state, sgg_batch, prd_vecs)
            timer.tick(b)
            if state.step % args.disp_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["imgs_per_sec"] = timer.rate()
                logger.log_scalars("sgg_train", m, state.step)
                print(f"[epoch {epoch:2d}][iter {state.step:6d}] "
                      f"rel loss: {m['loss']:.4f} "
                      f"pairs {int(m['n_pairs'])} "
                      f"({m['imgs_per_sec']:.1f} img/s)", flush=True)
            if args.max_steps and state.step >= args.max_steps:
                break
        save_on_rank0(ckpt_dir, model.state_dict(), state.step, metadata={
            "session": args.session, "epoch": epoch, "stage": "sgg",
            "net": args.net, "num_relations": int(n_rel),
            "emb_dim": args.emb_dim, "spatial_type": args.spatial_type,
            # evaluation builds the head with the pooling it trained with
            "vrd_pooling": args.vrd_pooling},
            optimizer_state=opt.state_dict(),
            keep_last=args.keep_ckpts or None)
        print(f"checkpoint @ step {state.step} (epoch {epoch})", flush=True)
        if args.max_steps and state.step >= args.max_steps:
            break
    logger.close()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
