"""Stage A: the adversarial domain-adaptive detector's training step —
counterpart of ``i2vsgg_tpu/train/det_da.py``
(``trainval_net_instance_styleD_bilinear.py:256-341``)::

    loss = rpn_cls + rpn_box + rcnn_cls + rcnn_box            (source)
         + 0.5*mean(D_inst_s^2) + 0.5*mean((1-D_inst_t)^2)    (LSGAN instance)
         + style_lambda * (0.5*mean(D_sty_s^2)
                           + 0.5*mean((1-D_sty_t)^2))         (LSGAN style)
         [+ the consistency terms with ``cr``]

with the GRL inside the discriminators turning their gradients around into
the trunk. ``train_step`` is the whole step: the source and target passes,
the loss, one backward, the clip and the SGD update. The metrics carry
JAX's names.

Random draws (anchor and roi sampling, VGG16's dropout) come from one
``torch.Generator`` on the step's device, seeded from ``(seed, step)``, so a
resumed run draws what an uninterrupted one would; in a process group the
rank is folded in too, so that each rank's images draw their own samples, as
each image of JAX's global batch has its own key
(``i2vsgg_tpu/models/faster_rcnn.py:197, 218``).

In a process group (``parallel/mesh.py``, one rank a card) the step is that
of the global batch: every loss term is its local sum over the global count
(``FasterRCNN_DA.train_source``; the LSGAN and consistency means here), the
gradients are summed over the ranks (``all_reduce_grads``) between the
backward and the clip, and the metrics are the global batch's, the same on
every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from i2vsgg_tpu_torch.models.discriminators import (lsgan_source_loss,
                                                    lsgan_target_loss)
from i2vsgg_tpu_torch.parallel.mesh import (all_reduce_grads, global_sum,
                                            process_index)
from i2vsgg_tpu_torch.train.optim import ReferenceSGD


@dataclass
class TrainState:
    model: nn.Module
    optimizer: ReferenceSGD
    step: int = 0
    seed: int = 0


def step_generator(device, seed: int, step: int,
                   rank: int = 0) -> torch.Generator:
    """The step's generator: a function of (seed, step) (JAX folds the step
    into its key the same way) and of ``rank``, which rank 0 leaves out, so
    that one process draws what rank 0 of a group does."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step + (rank << 32)) % (2 ** 63))


def det_da_loss(model, batch_s: Dict, batch_t: Dict, generator, *,
                eta: float, eta_style: float, style_lambda: float,
                cr: bool):
    """The step's loss and its metrics (0-d tensors), each the local part of
    the global batch's (divided by global counts; see the module
    docstring). The padded target rois take part in the instance loss, as in
    the reference (it pools the zero-padded rois too)."""
    out_s = model.train_source(batch_s["image"], batch_s["im_info"],
                               batch_s["gt_boxes"], eta, eta_style,
                               generator)
    out_t = model.target_pass(batch_t["image"], batch_t["im_info"], eta,
                              eta_style)
    loss_det = (out_s["rpn_loss_cls"] + out_s["rpn_loss_box"]
                + out_s["rcnn_loss_cls"] + out_s["rcnn_loss_bbox"])
    # the means' global counts: the discriminators' outputs, and the rois
    # of each pass (the consistency terms)
    d = (out_s["d_instance"], out_s["d_style"], out_t["d_instance"],
         out_t["d_style"])
    n = global_sum(torch.tensor(
        [float(x.numel()) for x in d]
        + [float(out_s["d_instance"].shape[0]),
           float(out_t["d_instance"].shape[0])],
        device=out_s["d_instance"].device))
    dloss_s_p = lsgan_source_loss(d[0], n[0])
    dloss_s_style = lsgan_source_loss(d[1], n[1])
    dloss_t_p = lsgan_target_loss(d[2], n[2])
    dloss_t_style = lsgan_target_loss(d[3], n[3])
    loss = (loss_det + dloss_s_p + dloss_t_p
            + style_lambda * (dloss_s_style + dloss_t_style))
    metrics = {
        "loss_rpn_cls": out_s["rpn_loss_cls"],
        "loss_rpn_box": out_s["rpn_loss_box"],
        "loss_rcnn_cls": out_s["rcnn_loss_cls"],
        "loss_rcnn_box": out_s["rcnn_loss_bbox"],
        "dloss_s_p": dloss_s_p, "dloss_t_p": dloss_t_p,
        "dloss_s_style": dloss_s_style, "dloss_t_style": dloss_t_style,
        "fg_cnt": out_s["fg_cnt"],
    }
    if cr:
        # the consistency regularizer [trainval...:299-312]: each roi's mean
        # instance probability against its image's detached style
        # probability
        def cst(d_inst, d_style, count):
            per_roi = d_inst.mean(dim=(1, 2, 3))
            n_rep = per_roi.shape[0] // d_style.shape[0]
            prob = d_style.reshape(-1).repeat_interleave(n_rep)
            return ((per_roi - prob.detach()) ** 2).sum() / count
        cst_s = cst(out_s["d_instance"], out_s["d_style"], n[4])
        cst_t = cst(out_t["d_instance"], out_t["d_style"], n[5])
        loss = loss + cst_s + cst_t
        metrics["loss_s_cst"] = cst_s
        metrics["loss_t_cst"] = cst_t
    metrics["loss"] = loss
    return loss, metrics


def train_step(state: TrainState, batch_s: Dict, batch_t: Dict, *,
               eta: float, eta_style: float, style_lambda: float,
               cr: bool) -> Dict[str, torch.Tensor]:
    """One step in place on ``state``: forward both passes, backward, the
    gradients summed over the ranks (in a process group), clip, SGD at the
    lr of ``state.step``; the step count then advances. Returns the global
    batch's metrics, detached."""
    model = state.model
    dev = next(model.parameters()).device
    gen = step_generator(dev, state.seed, state.step, process_index())
    state.optimizer.zero_grad()
    loss, metrics = det_da_loss(model, batch_s, batch_t, gen, eta=eta,
                                eta_style=eta_style,
                                style_lambda=style_lambda, cr=cr)
    loss.backward()
    all_reduce_grads(state.optimizer.params())
    state.optimizer.step(state.step)
    state.step += 1
    return global_metrics(metrics)


def global_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Each rank's part of the metrics (local sums over global counts, or
    counts) summed over the ranks in one collective: the global batch's
    values, the same on every rank. Detached."""
    keys = list(metrics)
    total = global_sum(torch.stack([metrics[k].detach().float()
                                    for k in keys]))
    return {k: total[i].to(metrics[k].dtype) for i, k in enumerate(keys)}
