"""Stage B's predicate-mAP calibration study — the port's counterpart of the
JAX package's ``tools/stage_b_rescore.py``, ours arm only, with its flags
plus ``--depth`` and ``--device``.

A trained Stage B head is scored over the test split's GT pairs (the
traversal of ``parity_run.eval_sgg``) under five host-side transforms of
its raw cosine logits ``s``, each giving predicate top-1 and pred mAP
(``metrics``, ``eval_sgg``'s arithmetic):

  protocol_softmax  softmax(s)          the parity protocol
  raw_cosine        s                   per-predicate ranking by the cosine
  sharp_T0.25       softmax(4 s)
  flat_T4           softmax(s / 4)
  soprior_fused     softmax(s) + log(0.5 (prior[sub - 1, obj - 1] + 1/R))
                                        the reference's recognition-path
                                        fusion, with the corpus's so-prior

A per-pair monotone transform leaves top-1 as it is; only the cross-pair
rankings that AP measures move.

``main`` trains the head first, as the JAX tool does
(``parity_run.train_ours_sgg``, session ``951 + seed``; an existing
checkpoint at ``--steps`` or later is reused), then scores it with
``rescore``, which takes any trained session and retrains nothing. The
results accumulate across invocations in ``<out>/stage_b_rescore.json``
under ``ours_s<seed>``.

The reference arm is not ported: it retrains the reference's head through
``parity/refshim.py``, which needs the reference's sources
(``/root/reference``); ``--arms`` with ``ref`` raises ``ValueError``
before anything runs. The default ``--arms`` is ``ours`` (JAX's:
``ours,ref``).

Usage:
  python -m i2vsgg_tpu_torch.tools.stage_b_rescore --out runs/torch_stage_b \\
      --data runs/torch_gate_arm/data --depth 101 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

from i2vsgg_tpu_torch.tools.stage_c_hard import REF_REFUSED


def _softmax(x, t=1.0):
    z = x * t
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def collect(raw_fn):
    """(raw_scores, labels, sub_cls, obj_cls) over the test split's GT
    pairs — the same traversal as parity_run.eval_sgg."""
    from i2vsgg_tpu_torch.tools import parity_run as pr
    rows = []
    for index, im, scale, boxes, classes, pairs, labels in \
            pr._stage_b_data("test"):
        s = raw_fn(index, im, scale, boxes, pairs)
        for ii, lab in enumerate(labels):
            si, oi = pairs[ii]
            rows.append((np.asarray(s[ii], np.float64),
                         np.asarray(lab, np.float64),
                         int(classes[si]), int(classes[oi])))
    return rows


def metrics(scores_all, labels_all):
    """Top-1 accuracy + per-predicate AP, identical arithmetic to
    parity_run.eval_sgg."""
    from i2vsgg_tpu_torch.tools.parity_run import N_REL
    correct = sum(1 for s, lab in zip(scores_all, labels_all)
                  if lab[int(np.argmax(s))] > 0)
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
    return {"top1_acc": correct / max(len(labels_all), 1),
            "pred_mAP": float(np.mean(aps)) if aps else 0.0}


def variants(rows, prior):
    """The five transforms' metrics of ``collect``'s rows; ``prior`` the
    (15, 15, R) so-prior."""
    raws = [r[0] for r in rows]
    labs = [r[1] for r in rows]
    fused = [_softmax(s[None])[0]
             + np.log(0.5 * (prior[sc - 1, oc - 1] + 1.0 / len(s)))
             for s, _, sc, oc in rows]
    return {
        "protocol_softmax": metrics([_softmax(s[None])[0] for s in raws],
                                    labs),
        "raw_cosine": metrics(raws, labs),
        "sharp_T0.25": metrics([_softmax(s[None], 4.0)[0] for s in raws],
                               labs),
        "flat_T4": metrics([_softmax(s[None], 0.25)[0] for s in raws], labs),
        "soprior_fused": metrics(fused, labs),
    }


def so_prior(data: str) -> np.ndarray:
    with open(os.path.join(data, "MVidVRD", "source_so_prior.pkl"),
              "rb") as f:
        return np.asarray(pickle.load(f))          # (15, 15, R)


def rescore(ckpt_dir: str, data: str, device: str = "cuda") -> dict:
    """The five variants of the newest checkpoint of a trained Stage B
    session ``ckpt_dir`` on the corpus ``data`` (``I2VSGG_DATA_ROOT`` set to
    it for the scoring, then restored): the raw cosine scorer
    (``parity_run._ours_sgg_score_fn(raw=True)``), nothing retrained."""
    from i2vsgg_tpu_torch.tools import parity_run as pr
    saved = os.environ.get("I2VSGG_DATA_ROOT")
    os.environ["I2VSGG_DATA_ROOT"] = data
    try:
        rows = collect(pr._ours_sgg_score_fn(ckpt_dir, device=device,
                                             raw=True))
    finally:
        if saved is None:
            os.environ.pop("I2VSGG_DATA_ROOT", None)
        else:
            os.environ["I2VSGG_DATA_ROOT"] = saved
    return variants(rows, so_prior(data))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/stage_b_r5")
    ap.add_argument("--data", default="runs/parity_r5/data",
                    help="parity corpus root (regenerated bit-identically "
                         "when absent)")
    ap.add_argument("--steps", type=int, default=672)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--arms", default="ours")
    ap.add_argument("--depth", type=int, default=None,
                    help="the trunk depth (parity_run.HP's, 50, by default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from i2vsgg_tpu_torch.tools import parity_run as pr
    from i2vsgg_tpu_torch.tools.train_gate_arm import ensure_parity_data
    from i2vsgg_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    arms = args.arms.split(",")
    if any(arm != "ours" for arm in arms):     # JAX's every other arm: ref
        raise ValueError(REF_REFUSED)
    device = resolve_device(args.device)
    if args.depth is not None:
        pr.HP["depth"] = args.depth
    ensure_parity_data(args.data)
    os.environ["I2VSGG_DATA_ROOT"] = args.data

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "stage_b_rescore.json")
    results = {}
    if os.path.exists(path):            # accumulate across invocations
        with open(path) as f:
            results = json.load(f)
    for seed in (int(s) for s in args.seeds.split(",")):
        for arm in arms:
            print(f"=== {arm} seed {seed} ===", flush=True)
            pr.train_ours_sgg(args.data, args.out, args.steps, seed=seed,
                              device=device)
            ckpt_dir = os.path.join(args.out, f"res{pr.HP['depth']}",
                                    "MVRD_SGG", f"session_{951 + seed}")
            results[f"{arm}_s{seed}"] = rescore(ckpt_dir, args.data, device)
            with open(path, "w") as f:
                json.dump(results, f, indent=1)
            for k, v in results[f"{arm}_s{seed}"].items():
                print(f"  {k}: top1 {v['top1_acc']:.3f} "
                      f"mAP {v['pred_mAP']:.3f}", flush=True)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
