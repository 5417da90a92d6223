"""SGG evaluation + video association + vIoU relation metrics — the port's
counterpart of the JAX package's ``tools/test_sgg.py``
(rebuild of ``test_net_SGG_emb.py:42-326``).

Per frame, the target's GT boxes act as detections; all ordered pairs are
predicate-scored by Stage B (``SGGModel.forward``: its own trunk, then the
head), ``detection_output`` packs the top-100 (pair, predicate) tuples,
frames are grouped per video, associated into relation trajectories and
scored with vIoU mAP / R@50/100 / tagging P@K — or, with ``--vrd_task
pre_det``, predicate recognition with the so-prior.
It runs on one device; ``--mesh`` is read and ignored, as by the JAX
driver.

Usage:
  python -m i2vsgg_tpu_torch.tools.test_sgg --dataset MVidVRD --net res101 \\
      --load_name models/res101/MVRD_SGG/session_1/<step> \\
      --video_ann data/MVidVRD/video_annotations_static.json [--device cpu]
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time

import numpy as np
import torch


def frame_key(index: str, frame_map):
    """An image index -> (video, frame number): from ``frame_map``, else
    parsed as ``<video>_<frame_no>``."""
    if frame_map is not None and index in frame_map:
        vid, fno = frame_map[index]
        return str(vid), int(fno)
    if "_" in index:
        vid, fno = index.rsplit("_", 1)
        try:
            return vid, int(fno)
        except ValueError:
            pass
    return index, 0


@torch.no_grad()
def score_frames(model, batch, prd, layout, g: int, dev):
    """Stage B on each frame of a loader batch, its GT boxes as detections
    -> (rel_prob (B, P, n_rel), pair_valid (B, P)) as numpy."""
    ix1, ix2, pair_static = layout
    images = torch.as_tensor(batch["image"], dtype=torch.float32, device=dev)
    im_info = torch.as_tensor(batch["im_info"], device=dev)
    boxes = torch.as_tensor(batch["gt_boxes"][:, :, :4], device=dev)
    nbox = torch.as_tensor(batch["num_boxes"], device=dev)
    zeros = torch.zeros((g,), dtype=torch.long, device=dev)
    rel_prob, pair_valid = [], []
    for f in range(images.shape[0]):
        pv = (ix1 < nbox[f]) & (ix2 < nbox[f])
        out = model(images[f:f + 1], im_info[f], boxes[f], zeros, ix1, ix2,
                    pv, prd, pair_static=pair_static)
        rel_prob.append(torch.softmax(out["scores"].float(), dim=-1))
        pair_valid.append(pv)
    return (torch.stack(rel_prob).cpu().numpy(),
            torch.stack(pair_valid).cpu().numpy())


def main(argv=None):
    from i2vsgg_tpu_torch.cli.args import parse_args, set_dataset_args
    from i2vsgg_tpu_torch.data.pipeline import DetectionLoader
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.models.glove import load_predicate_vectors
    from i2vsgg_tpu_torch.models.layers import init_weights, torch_dtype
    from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
    from i2vsgg_tpu_torch.serve import (make_pair_indices, pair_layout)
    from i2vsgg_tpu_torch.tools.common import (build_trunk, ckpt_of,
                                               config_from_args,
                                               vrd_pooling_of)
    from i2vsgg_tpu_torch.train.checkpoint import restore_intersection
    from i2vsgg_tpu_torch.utils.device import resolve_device
    from i2vsgg_tpu_torch.video.association import association
    from i2vsgg_tpu_torch.video.metrics import (detection_output, evaluate,
                                                evaluate_recognition,
                                                recognition_output)

    args = set_dataset_args(parse_args(argv), test=True)
    if args.mesh:
        # the JAX driver parses --mesh and evaluates on one device too
        print(f"--mesh {args.mesh}: evaluation runs on one device",
              flush=True)
    dev = resolve_device(args.device)
    cfg = config_from_args(args, verbose=True)

    imdb, roidb, _, idx = combined_roidb(args.imdbval_name, training=False,
                                         use_flipped=False)
    print(f"{len(roidb)} eval frames ({args.imdbval_name})")
    # gt_truncate="first": GT-pair recognition indexes the original
    # annotation order; only applies when n > g
    loader = DetectionLoader(roidb, idx, cfg, batch_size=args.batch_size,
                             training=False, gt_truncate="first")
    print(f"loader: {loader.path}")

    prd_np = load_predicate_vectors(args)
    n_rel = prd_np.shape[0]
    g = cfg.TRAIN.MAX_NUM_GT_BOXES
    ix1_np, ix2_np = make_pair_indices(g)

    # pooling mode must match what the checkpoint was trained with
    # (test_net_instance_styleD_bilinear.py:80-81)
    vrd_pooling = vrd_pooling_of(args.load_name, args.vrd_pooling)
    model = SGGModel(VRDHead(emb_dim=args.emb_dim,
                             spatial_type=args.spatial_type,
                             use_obj_visual=args.use_obj_visual,
                             fc_dim=args.vrd_fc_dim, pooling=vrd_pooling,
                             int8_fc=args.int8_fc6),
                     trunk=build_trunk(args.net,
                                       torch_dtype(cfg.COMPUTE_DTYPE)))
    init_weights(model, torch.Generator().manual_seed(0))
    ckpt = ckpt_of(args.load_name)
    if ckpt is not None:
        restore_intersection(*ckpt, model)
        print(f"loaded {args.load_name}")
    model.to(dev).eval()

    frame_map = None
    if args.frame_map and os.path.exists(args.frame_map):
        with open(args.frame_map, "rb") as f:
            frame_map = pickle.load(f)

    # static all-pairs layout -> unordered-union dedup (exact)
    layout = pair_layout(g, dev)
    prd = torch.as_tensor(prd_np, device=dev)

    # recognition task (vrd_task=pre_det): GT pairs, predicate scores fused
    # with the log so-prior [lib/utils.py:570-582]; sub/obj scores are the
    # GT one-hots
    recognition = args.vrd_task == "pre_det"
    gt_rels = {}
    so_prior = None
    if recognition:
        if os.path.exists(args.target_gt_rels_path):
            with open(args.target_gt_rels_path, "rb") as f:
                gt_rels = pickle.load(f)
        if os.path.exists(args.source_so_prior_path):
            with open(args.source_so_prior_path, "rb") as f:
                so_prior = pickle.load(f)
    n_cls = len(imdb.classes)
    recognition_preds = {}

    frame_detections = {}
    t0 = time.time()
    done = 0
    for batch in loader:
        rel_prob, pv = score_frames(model, batch, prd, layout, g, dev)
        for bi, ridx in enumerate(batch["indices"]):
            entry = roidb[int(ridx)]
            index = os.path.splitext(os.path.basename(entry["image"]))[0]
            vid, fno = frame_key(index, frame_map)
            n = int(batch["num_boxes"][bi])
            scale = float(batch["im_info"][bi, 2])
            boxes = batch["gt_boxes"][bi, :n, :4] / scale
            classes = batch["gt_boxes"][bi, :n, 4].astype(int)
            confs = np.ones((n,), np.float32)
            sel = pv[bi]
            out = detection_output(rel_prob[bi][sel], boxes, classes, confs,
                                   ix1_np[sel], ix2_np[sel], top_k=100)
            tuples = []
            if out is not None:
                rlp, tconfs, sboxes, oboxes, _ = out
                for t in range(min(100, len(tconfs))):
                    tuples.append([float(tconfs[t]),
                                   [int(c) for c in rlp[t]],
                                   [sboxes[t].tolist(), oboxes[t].tolist()],
                                   t])
            frame_detections.setdefault(vid, []).append([fno, tuples])
            if recognition:
                # raw cosine scores for GT pairs + so-prior fusion
                raw = np.log(np.clip(rel_prob[bi], 1e-12, None))
                for (s, p, o) in gt_rels.get(index, []):
                    if s >= n or o >= n:
                        continue
                    pair_slots = np.where((ix1_np == s) & (ix2_np == o))[0]
                    if not len(pair_slots) or not pv[bi][pair_slots[0]]:
                        continue
                    sc, oc = int(classes[s]), int(classes[o])
                    sub_s = np.zeros(n_cls)
                    obj_s = np.zeros(n_cls)
                    sub_s[sc] = 1.0
                    obj_s[oc] = 1.0
                    prior = (so_prior[sc - 1, oc - 1]
                             if so_prior is not None
                             else np.full((n_rel,), 1.0 / n_rel))
                    _, _, pre_s = recognition_output(
                        sub_s[None], obj_s[None], raw[pair_slots[0]][None],
                        prior[None], n_rel)
                    recognition_preds.setdefault(vid, []).append({
                        "triplet": [sc, int(p), oc],
                        "sub_score": sub_s.tolist(),
                        "obj_score": obj_s.tolist(),
                        "pre_score": pre_s[0].tolist()})
            done += 1
        if done % 200 < args.batch_size:
            print(f"  {done} frames ({done / (time.time() - t0):.1f}/s)")

    out_dir = os.path.join(args.save_dir, "eval",
                           f"{args.imdbval_name}_SGG")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "frame_detections.json"), "w") as f:
        json.dump(frame_detections, f)
    print(f"frame detections -> {out_dir}/frame_detections.json")

    if recognition:
        with open(os.path.join(out_dir, "recognition.json"), "w") as f:
            json.dump(recognition_preds, f)
        return evaluate_recognition(recognition_preds,
                                    num_fg_classes=n_cls - 1)

    video_relations = association(frame_detections,
                                  objects=list(imdb.classes),
                                  predicates=[str(i) for i in range(n_rel)])
    with open(os.path.join(out_dir, "video_relations.json"), "w") as f:
        json.dump(video_relations, f)

    if args.video_ann and os.path.exists(args.video_ann):
        with open(args.video_ann) as f:
            gt = json.load(f)
        mAP, rec_at_n, prec_at_n = evaluate(video_relations, gt)
        print(f"relation detection mAP: {mAP:.4f}")
        for k, v in rec_at_n.items():
            print(f"recall@{k}: {v:.4f}")
        for k, v in prec_at_n.items():
            print(f"tagging precision@{k}: {v:.4f}")
        return mAP, rec_at_n, prec_at_n
    print("no --video_ann given; skipping vIoU metrics")
    return video_relations


if __name__ == "__main__":
    main(sys.argv[1:])
