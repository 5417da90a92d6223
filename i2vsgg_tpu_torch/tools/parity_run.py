"""The "ours" arm of the parity campaign — the port's copy of the helpers of
the JAX package's ``tools/parity_run.py`` that ``train_gate_arm``,
``capacity_ab`` and ``quant_ab`` use: the shared recipe (``HP``,
``CFG_OVERRIDES``), the corpus (``make_data``), the loaders and seeds, Stage
B's data, training and scoring (``train_ours_sgg``), and the two quality
evaluations (``eval_sgg``: predicate top-1 and pred mAP over the test
split's GT pairs; ``eval_video_rel``: the video relation-detection
pipeline, rel mAP and R@50).

The reference arm is not ported: it builds the torch reference through
``parity/refshim.py``, which needs the reference's sources. In place of the
reference's exported random init (JAX's ``shared_init`` converted by
``save_converted``), ``save_init`` saves the port's own seeded detector
init with every bottleneck's bn3 scale zeroed, as the JAX package starts
when it trains without the reference (``--zero_init_residual``). It is
Stage B's trunk in ``train_ours_sgg``, as the converted init is in JAX.

``device`` (default ``cuda``, raising without a card; ``cpu`` for the
CPU) is where the drivers and the scorer run.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# the parity recipe: the reference scripts' Stage A hyperparameters scaled
# to the synthetic corpus (anchors that fit 50-110 px objects, 240-px
# images), gradients clipped at 10
HP = dict(lr=5e-4, momentum=0.9, weight_decay=1e-4, double_bias=1,
          eta=0.1, eta_style=0.001, style_lambda=1.0, cr=False, clip=10.0,
          scales=240, anchor_scales=[2, 4, 8], bs=1, depth=50)
CFG_OVERRIDES = ["ANCHOR_SCALES", "[2, 4, 8]",
                 "TRAIN.SCALES", "[240]", "TEST.SCALES", "[240]",
                 "TRAIN.RPN_PRE_NMS_TOP_N", "3000",
                 "TRAIN.RPN_POST_NMS_TOP_N", "256",
                 "TRAIN.RPN_POST_NMS_TOP_N_TARGET", "128",
                 "TEST.RPN_PRE_NMS_TOP_N", "3000",
                 "TEST.RPN_POST_NMS_TOP_N", "128",
                 "POOLING_MODE", "align"]
N_REL = 5                      # the corpus's geometry predicates
SGG_LR = 1e-3                  # Stage B's vrd lr


def make_data(root, n_source=48, n_target=24, seed=0, source_split=0.75,
              target_split=0.75, video_target=False, n_frames=24,
              hard_videos=False):
    """The parity corpus under ``root``: MVRD stills (1-3 large objects),
    MVidVRD as videos (``video_target``: Stage A's target stills are the
    trainval frames, Stage C evaluates the held-out videos) or as stills,
    and the so-prior pickle. ``hard_videos``: 4-6 smaller, faster objects a
    video, many short GT runs."""
    from i2vsgg_tpu_torch.tools.learnable_data import (
        make_learnable_dataset, make_learnable_video_dataset)
    os.makedirs(root, exist_ok=True)
    make_learnable_dataset(root, "MVRD", n_source, ".jpg", seed=seed,
                           split_frac=source_split,
                           min_obj=1, max_obj=3, size_range=(50, 110))
    if video_target:
        vid_kw = (dict(min_obj=4, max_obj=6, size_range=(30, 70),
                       max_speed=7) if hard_videos
                  else dict(size_range=(50, 110)))
        make_learnable_video_dataset(root, "MVidVRD", n_videos=n_target,
                                     n_frames=n_frames, seed=seed + 1,
                                     split_frac=target_split, **vid_kw)
    else:
        make_learnable_dataset(root, "MVidVRD", n_target, ".png",
                               seed=seed + 1, index_fmt="vid00_{:04d}",
                               split_frac=target_split,
                               min_obj=1, max_obj=3, size_range=(50, 110))
    import pickle
    prior = np.random.RandomState(9).dirichlet(np.ones(N_REL),
                                               size=(15, 15))
    with open(os.path.join(root, "MVidVRD", "source_so_prior.pkl"),
              "wb") as f:
        pickle.dump(prior, f)
    return root


def _loaders(cfg, bs, seed=3):
    """The source and target training loaders of ``I2VSGG_DATA_ROOT``'s
    MVRD and MVidVRD trainval splits -> (source imdb, source loader, target
    loader)."""
    from i2vsgg_tpu_torch.data.pipeline import DetectionLoader
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    imdb_s, roidb_s, _, idx_s = combined_roidb("MVRD_trainval")
    _, roidb_t, _, idx_t = combined_roidb("MVidVRD_trainval")
    ls = DetectionLoader(roidb_s, idx_s, cfg, bs, training=True, seed=seed)
    lt = DetectionLoader(roidb_t, idx_t, cfg, bs, training=True,
                         seed=seed + 1)
    return imdb_s, ls, lt


def _run_seed(seed: int) -> int:
    """Per-run RNG stream base: seed 0 keeps the historical value 3."""
    return 3 + 1000 * seed


def _our_cfg():
    from i2vsgg_tpu_torch.config import Config, cfg_from_list
    return cfg_from_list(list(CFG_OVERRIDES), Config()).replace(
        COMPUTE_DTYPE="float32")


def save_init(out_dir):
    """The detector's training init at ``HP["depth"]`` (ic+gc, both
    discriminators, the port's training inits from seed 0) with every
    bottleneck's bn3 scale zeroed, saved in the port's format as step 0 of
    ``<out_dir>/res<depth>/MVRD/session_shared`` with metadata
    ``pooling_mode=align``; an existing one is kept. Returns
    ``<ckpt_dir>/0``, a ``--load_name``."""
    from i2vsgg_tpu_torch.models.faster_rcnn import FasterRCNN_DA
    from i2vsgg_tpu_torch.models.inits import init_module, zero_init_residual
    from i2vsgg_tpu_torch.train.checkpoint import latest_step, save_checkpoint
    ckpt_dir = os.path.join(out_dir, f"res{HP['depth']}", "MVRD",
                            "session_shared")
    if latest_step(ckpt_dir) != 0:
        imdb_s, _, _ = _loaders(_our_cfg(), HP["bs"])
        det = FasterRCNN_DA(num_classes=len(imdb_s.classes), cfg=_our_cfg(),
                            backbone=f"res{HP['depth']}", ic=True, gc=True,
                            training_tree=True)
        init_module(det, torch.Generator().manual_seed(0))
        zero_init_residual(det)
        save_checkpoint(ckpt_dir, det.state_dict(), 0,
                        metadata={"pooling_mode": "align", "arm": "shared"})
    return os.path.join(ckpt_dir, "0")


def _sgg_spe():
    """Pair-bearing trainval images: the driver's updates an epoch (it
    skips batches without a pair), the anchor of the x0.9/epoch decay."""
    return len(_stage_b_data("trainval"))


def _prd_vecs():
    return np.random.RandomState(0).randn(N_REL, 300).astype(np.float32)


def _pairs_of(rels):
    """Unique ordered pairs with multi-label targets.
    [faster_rcnn_SGG_emb.py:184-237]"""
    pairs, labels = [], []
    for s, p, o in rels:
        if (s, o) not in pairs:
            pairs.append((s, o))
            labels.append(np.zeros(N_REL, np.float32))
        labels[pairs.index((s, o))][p] = 1.0
    return pairs, labels


def _stage_b_data(split):
    """(index, image (H, W, 3) f32 BGR prepared, scale, boxes, classes,
    pairs, labels) of each MVRD image of ``split`` with a GT pair."""
    import pickle
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    from i2vsgg_tpu_torch.data.pipeline import prep_image
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    cfg = _our_cfg()
    _, roidb, _, _ = combined_roidb(f"MVRD_{split}", use_flipped=False)
    with open(os.path.join(os.environ["I2VSGG_DATA_ROOT"], "MVRD",
                           "source_gt_rels.pkl"), "rb") as f:
        gt_rels = pickle.load(f)
    out = []
    for e in roidb:
        index = os.path.splitext(os.path.basename(e["image"]))[0]
        im, scale = prep_image(imread_bgr(e["image"]), 240, cfg.PIXEL_MEANS)
        pairs, labels = _pairs_of(gt_rels.get(index, []))
        if not pairs:
            continue
        out.append((index, im, scale, e["boxes"] * scale,
                    e["gt_classes"], pairs, labels))
    return out


def train_ours_sgg(data_root, out_dir, steps, seed=0, device="cuda"):
    """Train the SGG head by the port's ``trainval_sgg`` over the trunk of
    ``save_init``'s checkpoint (session ``951 + seed``; an existing
    checkpoint at ``steps`` or later is reused); return its score_fn."""
    from i2vsgg_tpu_torch.tools.trainval_sgg import main as sgg_main
    from i2vsgg_tpu_torch.train.checkpoint import latest_step

    det_ckpt = save_init(out_dir)
    session = str(951 + seed)
    ckpt_dir = os.path.join(out_dir, f"res{HP['depth']}", "MVRD_SGG",
                            f"session_{session}")
    if (latest_step(ckpt_dir) or 0) >= steps:
        print(f"train_ours_sgg: reusing {ckpt_dir} @ "
              f"{latest_step(ckpt_dir)}", flush=True)
        return _ours_sgg_score_fn(ckpt_dir, device=device)
    spe = _sgg_spe()
    epochs = max(1, -(-steps // max(spe, 1)))
    sgg_main([
        "--dataset", "MVRD", "--net", f"res{HP['depth']}", "--bs", "1",
        "--epochs", str(epochs), "--max_steps", str(steps),
        "--vrd_lr", str(SGG_LR), "--decay_spe", str(spe),
        "--num_relations", str(N_REL),
        "--source_gt_rels_path",
        os.path.join(data_root, "MVRD", "source_gt_rels.pkl"),
        "--compute_dtype", "float32", "--disp_interval", "50",
        "--s", session, "--max_pairs", "12",
        # a checkpoint a pair-bearing epoch, each ~1.7 GB (fc6 and its
        # momentum): keep the newest only
        "--keep_ckpts", "1",
        "--save_dir", out_dir, "--load_name", det_ckpt, "--device", device,
        "--cfg"] + CFG_OVERRIDES + ["RNG_SEED", str(_run_seed(seed)),
                                    "TRAIN.MAX_NUM_GT_BOXES", "4"])
    return _ours_sgg_score_fn(ckpt_dir, device=device)


def sgg_scorer(model, device, raw=False):
    """The per-frame predicate scorer of an ``SGGModel`` with a trunk:
    ``score_fn(index, im, scale, boxes, pairs)`` -> (P, N_REL) softmax
    scores as numpy (with ``raw``, the cosine logits before the softmax, as
    ``stage_b_rescore`` transforms them on the host), computed at the fixed
    shapes of the JAX scorer (8 boxes, 56 pairs; the rest padded)."""
    from i2vsgg_tpu_torch.utils.device import resolve_device
    GB, PB = 8, 56
    device = resolve_device(device)
    prd = torch.as_tensor(_prd_vecs(), device=device)
    model.to(device).eval()

    def score_fn(index, im, scale, boxes, pairs):
        n, p = len(boxes), len(pairs)
        if n > GB or p > PB:
            raise ValueError(f"{index}: {n} boxes, {p} pairs; the scorer "
                             f"takes at most {GB} and {PB}")
        bx = np.zeros((GB, 4), np.float32)
        bx[:n] = boxes
        ix1 = np.zeros((PB,), np.int64)
        ix2 = np.zeros((PB,), np.int64)
        ix1[:p] = [q[0] for q in pairs]
        ix2[:p] = [q[1] for q in pairs]
        h, w = im.shape[:2]

        def t(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=device)
        out = model(t(im[None], torch.float32),
                    t([float(h), float(w), 1.0], torch.float32), t(bx),
                    t(np.zeros((GB,), np.int64)), t(ix1), t(ix2),
                    t(np.arange(PB) < p), prd)
        s = out["scores"] if raw else torch.softmax(out["scores"], -1)
        return s.cpu().numpy()[:p]

    return score_fn


def _ours_sgg_score_fn(ckpt_dir, device="cuda", raw=False):
    """The scorer of the newest checkpoint in ``ckpt_dir``: an ``SGGModel``
    with an f32 trunk at ``HP["depth"]`` and the default head, restored
    with ``restore_intersection``; ``raw`` as ``sgg_scorer`` takes it."""
    from i2vsgg_tpu_torch.models.backbones import ResNetTrunk
    from i2vsgg_tpu_torch.models.layers import init_weights
    from i2vsgg_tpu_torch.models.sgg import SGGModel, VRDHead
    from i2vsgg_tpu_torch.train.checkpoint import (latest_step,
                                                   restore_intersection)
    model = SGGModel(VRDHead(), trunk=ResNetTrunk(depth=HP["depth"],
                                                  dtype=torch.float32))
    init_weights(model, torch.Generator().manual_seed(0))
    restore_intersection(ckpt_dir, latest_step(ckpt_dir), model)
    return sgg_scorer(model, device, raw)


def eval_video_rel(score_fn, data_root, split="test"):
    """The trained relation-detection pipeline on the held-out videos: GT
    boxes as each frame's detections (the reference's own eval setting,
    ``faster_rcnn_SGG_emb.py:583-587``) -> predicate scores from
    ``score_fn`` -> per-frame top-100 tuples (``detection_output``) ->
    ``association`` -> ``evaluate`` at vIoU 0.5. Returns rel mAP, R@50,
    R@100, tagging P@1/5/10 and the GT count."""
    from i2vsgg_tpu_torch.data.image_io import imread_bgr
    from i2vsgg_tpu_torch.data.pipeline import prep_image
    from i2vsgg_tpu_torch.data.roidb import combined_roidb
    from i2vsgg_tpu_torch.video.association import association
    from i2vsgg_tpu_torch.video.metrics import detection_output, evaluate
    cfg = _our_cfg()
    _, roidb, _, _ = combined_roidb(f"MVidVRD_{split}", use_flipped=False)
    frame_detections = {}
    for e in roidb:
        index = os.path.splitext(os.path.basename(e["image"]))[0]
        vid, fno = index.rsplit("_", 1)
        boxes0 = e["boxes"].astype(np.float64)
        classes = e["gt_classes"]
        n = len(boxes0)
        pairs = [(s, o) for s in range(n) for o in range(n) if s != o]
        tuples = []
        if n >= 2:
            im, scale = prep_image(imread_bgr(e["image"]), 240,
                                   cfg.PIXEL_MEANS)
            probs = score_fn(index, im, scale, boxes0 * scale, pairs)
            out = detection_output(
                probs, boxes0, classes, np.ones((n,), np.float32),
                np.asarray([p[0] for p in pairs]),
                np.asarray([p[1] for p in pairs]), top_k=100)
            if out is not None:
                rlp, tconfs, sboxes, oboxes, _ = out
                for t in range(len(tconfs)):
                    tuples.append([float(tconfs[t]),
                                   [int(c) for c in rlp[t]],
                                   [sboxes[t].tolist(), oboxes[t].tolist()],
                                   t])
        frame_detections.setdefault(vid, []).append([int(fno), tuples])
    vr = association(frame_detections)
    with open(os.path.join(os.environ["I2VSGG_DATA_ROOT"], "MVidVRD",
                           f"video_annotations_{split}.json")) as f:
        gt = json.load(f)
    mean_ap, rec_at_n, mprec_at_n = evaluate(vr, gt, verbose=False)
    return {"rel_mAP": mean_ap,
            "R@50": rec_at_n.get(50, 0.0), "R@100": rec_at_n.get(100, 0.0),
            "P@1": mprec_at_n.get(1, 0.0), "P@5": mprec_at_n.get(5, 0.0),
            "P@10": mprec_at_n.get(10, 0.0),
            "n_gt": int(sum(len(v) for v in gt.values()))}


def eval_sgg(score_fn):
    """Predicate top-1 accuracy and per-predicate AP over the test split's
    GT pairs."""
    data = _stage_b_data("test")
    correct = total = 0
    scores_all, labels_all = [], []
    for index, im, scale, boxes, classes, pairs, labels in data:
        s = score_fn(index, im, scale, boxes, pairs)
        for ii, lab in enumerate(labels):
            total += 1
            if lab[int(np.argmax(s[ii]))] > 0:
                correct += 1
            scores_all.append(s[ii])
            labels_all.append(lab)
    scores_all = np.stack(scores_all)
    labels_all = np.stack(labels_all)
    aps = []
    for r in range(N_REL):
        lab = labels_all[:, r]
        if lab.sum() == 0:
            continue
        order = np.argsort(-scores_all[:, r])
        tp = lab[order]
        rec = np.cumsum(tp) / lab.sum()
        prec = np.cumsum(tp) / (np.arange(len(tp)) + 1)
        aps.append(float(np.sum((rec[1:] - rec[:-1]) * prec[1:])
                         + rec[0] * prec[0]))
    return {"top1_acc": correct / max(total, 1),
            "pred_mAP": float(np.mean(aps)) if aps else 0.0,
            "n_pairs": total}
