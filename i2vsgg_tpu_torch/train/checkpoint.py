"""Checkpoints in the port's own format — counterpart of
``i2vsgg_tpu/train/checkpoint.py`` (orbax does not exist on the card's
machine), with the reference's restoration filters.

Layout, as the JAX package lays out its directories::

    <ckpt_dir>/step_%08d/model.pt        torch.save of a state dict
    <ckpt_dir>/step_%08d/train_state.pt  {"optimizer": SGD state, "step"}
    <ckpt_dir>/step_%08d/metadata.json   e.g. {"pooling_mode": "align"}
    <ckpt_dir>/best.json                 {"step", "metric", "higher_better"}

``train_state.pt`` (the momentum buffers and the step) exists in training
checkpoints only. A JAX checkpoint becomes one with
``tools/jax_to_torch_checkpoint.py``. The state dict holds the port's names
(the flax module names, see ``utils/weights.py``); it is loaded with
``mmap=True, weights_only=True``. The three restorations of the reference
(SURVEY.md §5): ``restore_detector_init`` (a detector without its
discriminator and classification/regression heads), ``restore_full`` (the
resume of a run) and ``restore_intersection`` (test time); and Stage B's
``restore_sgg_init`` (the trunk of a Stage A checkpoint). In a process
group the training drivers write through ``save_on_rank0``: rank 0 writes and
garbage-collects, then every rank meets at a barrier before it goes on.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from i2vsgg_tpu_torch.parallel.mesh import process_index, sync_global_devices

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"
METADATA_FILE = "metadata.json"

# Names excluded by the detector init: the reference's list
# (trainval_net_instance_styleD_bilinear.py:154: netD_pixel, RPN_cls_score,
# RPN_bbox_pred, RCNN_cls_score, RCNN_bbox_pred). Each matches whole
# "."-separated segments anywhere in a name, so "cls_score" excludes both
# ``cls_score.*`` and ``rpn.cls_score.*``; ``rpn.conv`` and ``netD_style``
# load, as in the reference.
DETECTOR_INIT_EXCLUDE = ("netD_pixel", "cls_score", "bbox_pred")


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _is_step_dir(name: str) -> bool:
    """Exactly ``step_<digits>``: stray entries such as ``step_7.bak`` are
    not steps."""
    parts = name.split("_")
    return len(parts) == 2 and parts[0] == "step" and parts[1].isdigit()


def save_checkpoint(ckpt_dir: str, state_dict: Mapping[str, torch.Tensor],
                    step: int, metadata: Optional[Dict[str, Any]] = None,
                    metric: Optional[float] = None,
                    higher_better: bool = True,
                    optimizer_state: Optional[Dict[str, Any]] = None,
                    keep_last: Optional[int] = None) -> str:
    """Write ``state_dict`` (tensors moved to the CPU) and ``metadata`` as
    step ``step`` of ``ckpt_dir``; with ``metric``, ``best.json`` points
    here when it beats the stored best. ``optimizer_state`` (a training
    checkpoint) is written with the step to ``train_state.pt``.
    ``keep_last`` then removes all but the newest ``keep_last`` steps and
    the best one (``gc_checkpoints``). Returns the step directory."""
    path = _ckpt_path(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save(sd, os.path.join(path, MODEL_FILE))
    if optimizer_state is not None:
        torch.save({"optimizer": optimizer_state, "step": int(step)},
                   os.path.join(path, TRAIN_STATE_FILE))
    with open(os.path.join(path, METADATA_FILE), "w") as f:
        json.dump(metadata or {}, f)
    if metric is not None:
        prev = best_checkpoint(ckpt_dir)
        better = (prev is None or
                  (metric > prev["metric"] if higher_better
                   else metric < prev["metric"]))
        if better:
            with open(os.path.join(os.path.abspath(ckpt_dir),
                                   "best.json"), "w") as f:
                json.dump({"step": step, "metric": float(metric),
                           "higher_better": higher_better}, f)
    if keep_last is not None:
        gc_checkpoints(ckpt_dir, keep_last)
    return path


def save_on_rank0(ckpt_dir: str, state_dict: Mapping[str, torch.Tensor],
                  step: int, **kw) -> Optional[str]:
    """``save_checkpoint`` on rank 0 only (the directory is shared), then a
    barrier of every rank (``sync_global_devices(f"ckpt_{step}")``, as the
    JAX driver does), so that no rank reads the directory before it is
    written. Returns the step directory on rank 0, None elsewhere; outside a
    process group it is ``save_checkpoint``."""
    path = None
    if process_index() == 0:
        path = save_checkpoint(ckpt_dir, state_dict, step, **kw)
    sync_global_devices(f"ckpt_{step}")
    return path


def gc_checkpoints(ckpt_dir: str, keep_last: int) -> None:
    """Delete all but the newest ``keep_last`` step checkpoints; the
    best-metric one is always kept."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if _is_step_dir(d))
    keep = set(steps[-keep_last:]) if keep_last > 0 else set()
    best = best_checkpoint(ckpt_dir)
    if best is not None:
        keep.add(int(best["step"]))
    for s in steps:
        if s not in keep:
            shutil.rmtree(_ckpt_path(ckpt_dir, s), ignore_errors=True)


def best_checkpoint(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """{"step", "metric", ...} of the best-metric checkpoint, or None."""
    p = os.path.join(os.path.abspath(ckpt_dir), "best.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if _is_step_dir(d)]
    return max(steps) if steps else None


def load_metadata(ckpt_dir: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(_ckpt_path(ckpt_dir, step), METADATA_FILE)) as f:
        return json.load(f)


def load_state_dict(ckpt_dir: str, step: int) -> Dict[str, torch.Tensor]:
    """The checkpoint's state dict, memory-mapped on the CPU."""
    return torch.load(os.path.join(_ckpt_path(ckpt_dir, step), MODEL_FILE),
                      map_location="cpu", mmap=True, weights_only=True)


@torch.no_grad()
def _merge_filtered(module: nn.Module, ckpt: Mapping[str, torch.Tensor],
                    skip: Sequence[str] = (),
                    keep_only_roots: Optional[Sequence[str]] = None
                    ) -> Dict[str, int]:
    """Copy into ``module`` every checkpoint tensor whose name and shape
    match one of its parameters or buffers, except names with a ``skip``
    segment or (with ``keep_only_roots``) another first segment. A
    name-matched tensor of another shape keeps its init. Returns {"copied",
    "named", "total"} (JAX's ``_merge_filtered``)."""
    target = module.state_dict(keep_vars=True)
    named = copied = 0
    for name, dst in target.items():
        src = ckpt.get(name)
        joined = "." + name + "."
        if (src is None or any(f".{s}." in joined for s in skip)
                or (keep_only_roots is not None
                    and name.split(".")[0] not in keep_only_roots)):
            continue
        named += 1
        if tuple(src.shape) == tuple(dst.shape):
            dst.copy_(src)
            copied += 1
    return {"copied": copied, "named": named, "total": len(target)}


def restore_detector_init(ckpt_dir: str, step: int,
                          module: nn.Module) -> Dict[str, int]:
    """Mode 1, detector init: load a detector but leave the discriminator
    and the classification/regression heads (``DETECTOR_INIT_EXCLUDE``) at
    their init, for a new class set or DA run. [trainval_…:153-183]"""
    return _merge_filtered(module, load_state_dict(ckpt_dir, step),
                           skip=DETECTOR_INIT_EXCLUDE)


def restore_sgg_init(det_ckpt_dir: str, step: int,
                     module: nn.Module) -> Dict[str, int]:
    """Mode 3, Stage B init: copy only the trunk (``trunk.*``, its
    FrozenBatchNorm buffers included) of a Stage A checkpoint into an
    ``SGGModel``; the relation head keeps its init. Returns JAX's stats
    {"copied", "named", "total"}. [trainval_net_SGG_emb.py:155-173]"""
    return _merge_filtered(module, load_state_dict(det_ckpt_dir, step),
                           keep_only_roots=("trunk",))


def restore_full(ckpt_dir: str, step: int, module: nn.Module,
                 optimizer) -> int:
    """Mode 2, full resume: the module's state (strict), the optimizer's
    state (``state_dict``/``load_state_dict``) and the step, which is
    returned. [trainval_…:186-196]"""
    module.load_state_dict(load_state_dict(ckpt_dir, step))
    st = torch.load(os.path.join(_ckpt_path(ckpt_dir, step),
                                 TRAIN_STATE_FILE),
                    map_location="cpu", weights_only=True)
    optimizer.load_state_dict(st["optimizer"])
    return int(st["step"])


def restore_intersection(ckpt_dir: str, step: int, module: nn.Module,
                         min_match: float = 0.9) -> Dict[str, int]:
    """Test-time load into ``module``, in place: copy every checkpoint
    tensor whose name and shape match a parameter or buffer of the module.
    [test_net_instance_styleD_bilinear.py:76-79]

    As in the JAX package, a name-matched tensor whose shape differs stays
    at its init (e.g. a new class count), while a low share of module names
    found in the checkpoint raises ``ValueError``: a mostly random-init
    model (the wrong ``--net`` for a checkpoint) would otherwise evaluate
    to a degenerate result that reads like a real one. ``min_match=0``
    allows a deliberately partial load. Names the module lacks (a training
    checkpoint's ``netD_pixel.conv3`` in a fused detector) are not read.
    Returns {"copied", "named", "total"}."""
    stats = _merge_filtered(module, load_state_dict(ckpt_dir, step))
    frac = stats["named"] / max(stats["total"], 1)
    if frac < min_match:
        raise ValueError(
            f"checkpoint {ckpt_dir}@{step} names only {stats['named']}/"
            f"{stats['total']} tensors ({frac:.0%}) of the model — wrong "
            "--net / architecture for this checkpoint?")
    return stats
