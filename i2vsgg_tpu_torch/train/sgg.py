"""Stage B: the relation (SGG) head's training step — counterpart of
``i2vsgg_tpu/train/sgg.py`` (the intended flow of
``trainval_net_SGG_emb.py:48-323``).

Per image, the ground-truth object pairs are scored by the ``vrd`` head
against the predicate embeddings and trained with multi-label BCE. The
detector's trunk is frozen: it runs without grad and its map is detached
(``SGGModel.frozen_map`` / ``train_head``), so the RoI kernels run forward
only. Pairs are padded to a static ``max_pairs`` with a validity mask.

``sgg_optimizer`` is ``ReferenceSGD`` with everything under ``trunk``
frozen: the vrd weights at ``vrd_lr`` with ``WEIGHT_DECAY``, the vrd
biases at twice the lr (DOUBLE_BIAS) without decay, no clip.
``train_step`` is the whole step: forward, loss, backward and the update.

The dropout masks come from one ``torch.Generator`` seeded from (seed,
step) (``det_da.step_generator``), and every image of a batch draws the
same masks: JAX applies one key to the whole ``vmap`` over images
(``i2vsgg_tpu/train/sgg.py:92-98``), a quirk kept here. In a process group
every rank keeps that unfolded generator (Stage A's folds the rank in), so
that every image of the global batch draws JAX's one set of masks.

In a process group (``parallel/mesh.py``) the loss is the global batch's:
each image weighted by its valid pairs over the ``global_sum`` of the
batch's valid pairs, and the head's gradients summed over the ranks before
the update.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from i2vsgg_tpu_torch.models.sgg import bce_multilabel_loss
from i2vsgg_tpu_torch.parallel.mesh import all_reduce_grads, global_sum
from i2vsgg_tpu_torch.train.det_da import (TrainState, global_metrics,
                                           step_generator)
from i2vsgg_tpu_torch.train.optim import ReferenceSGD

SGG_FROZEN_PREFIXES = ("trunk",)


def sgg_optimizer(model, vrd_lr: float | Callable[[int], float],
                  cfg) -> ReferenceSGD:
    """SGD with momentum over the vrd head only; the trunk frozen.
    [trainval_net_SGG_emb.py:129-148]"""
    return ReferenceSGD(model, vrd_lr, cfg,
                        frozen_prefixes=SGG_FROZEN_PREFIXES)


def sgg_loss(model, batch: Dict[str, torch.Tensor], prd_vecs: torch.Tensor,
             generator_fn: Callable[[], torch.Generator]):
    """The batch's multi-label BCE over its valid GT pairs: each image's
    mean weighted by its count of valid pairs (an image without one adds 0
    to both sums), the weights' sum that of the global batch in a process
    group. Returns (loss, {"loss", "n_pairs"}), this rank's parts.

    batch: ``image`` (B, H, W, 3), ``im_info`` (B, 3), ``obj_boxes`` (B, G,
    4) input-scale GT boxes (zero-padded), ``ix1``/``ix2`` (B, P) pair
    indices, ``pair_valid`` (B, P) bool, ``rel_labels`` (B, P, R).
    ``generator_fn()`` gives each image's dropout generator."""
    maps = model.frozen_map(batch["image"])
    losses, npairs = [], []
    for b in range(maps.shape[0]):
        pv = batch["pair_valid"][b]
        out = model.train_head(maps[b:b + 1], batch["im_info"][b],
                               batch["obj_boxes"][b], batch["ix1"][b],
                               batch["ix2"][b], pv, prd_vecs,
                               generator_fn())
        losses.append(bce_multilabel_loss(out["scores"],
                                          batch["rel_labels"][b], pv))
        npairs.append(pv.sum())
    losses, npairs = torch.stack(losses), torch.stack(npairs)
    w = npairs.to(losses.dtype)
    loss = (losses * w).sum() / torch.clamp_min(global_sum(w.sum()), 1.0)
    return loss, {"loss": loss, "n_pairs": npairs.sum()}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               prd_vecs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One step in place on ``state``: the loss with dropout, backward, the
    head's gradients summed over the ranks (in a process group), SGD at the
    lr of ``state.step``; the step count then advances. Returns the global
    batch's metrics, detached."""
    model = state.model
    dev = prd_vecs.device
    state.optimizer.zero_grad()
    loss, metrics = sgg_loss(
        model, batch, prd_vecs,
        lambda: step_generator(dev, state.seed, state.step))
    loss.backward()
    all_reduce_grads(state.optimizer.params())
    state.optimizer.step(state.step)
    state.step += 1
    return global_metrics(metrics)


def build_pair_batch(gt_rels: Sequence[Sequence[int]], n_boxes: int,
                     max_pairs: int, n_rel: int):
    """Host side: one image's (subject, predicate, object) triples as a
    padded multi-label row. Duplicate (s, o) pairs merge into one row,
    triples out of range (a box index >= ``n_boxes``, a predicate >=
    ``n_rel``) are dropped, and pairs past ``max_pairs`` are dropped.
    Returns (ix1, ix2, labels, valid) numpy arrays of ``max_pairs`` rows.
    [faster_rcnn_SGG_emb.py:186-237]"""
    pair_to_slot: Dict[tuple, int] = {}
    ix1 = np.zeros((max_pairs,), np.int32)
    ix2 = np.zeros((max_pairs,), np.int32)
    labels = np.zeros((max_pairs, n_rel), np.float32)
    valid = np.zeros((max_pairs,), bool)
    for s, p, o in gt_rels:
        if s >= n_boxes or o >= n_boxes or p >= n_rel:
            continue
        key = (int(s), int(o))
        if key not in pair_to_slot:
            if len(pair_to_slot) >= max_pairs:
                continue
            slot = len(pair_to_slot)
            pair_to_slot[key] = slot
            ix1[slot], ix2[slot] = key
            valid[slot] = True
        labels[pair_to_slot[key], int(p)] = 1.0
    return ix1, ix2, labels, valid
