"""Checkpoints in the port's own format — the load half of
``i2vsgg_tpu/train/checkpoint.py`` (orbax does not exist on the card's
machine).

Layout, as the JAX package lays out its directories::

    <ckpt_dir>/step_%08d/model.pt        torch.save of a state dict
    <ckpt_dir>/step_%08d/metadata.json   e.g. {"vrd_pooling": "pool"}
    <ckpt_dir>/best.json                 {"step", "metric", "higher_better"}

A JAX checkpoint becomes one with ``tools/jax_to_torch_checkpoint.py``. The
state dict holds the port's names (the flax module names, see
``utils/weights.py``); it is loaded with ``mmap=True, weights_only=True``.
The training half (``restore_full``, ``restore_detector_init``,
``restore_sgg_init``, garbage collection) comes with the training slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

MODEL_FILE = "model.pt"
METADATA_FILE = "metadata.json"


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
                    higher_better: bool = True) -> str:
    """Write ``state_dict`` (tensors moved to the CPU) and ``metadata`` as
    step ``step`` of ``ckpt_dir``; with ``metric``, ``best.json`` points
    here when it beats the stored best. Returns the step directory."""
    path = _ckpt_path(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save(sd, os.path.join(path, MODEL_FILE))
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
    return path


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
    allows a deliberately partial load. Returns {"copied", "named",
    "total"}."""
    ckpt = load_state_dict(ckpt_dir, step)
    target = module.state_dict(keep_vars=True)
    named = copied = 0
    for name, dst in target.items():
        src = ckpt.get(name)
        if src is None:
            continue
        named += 1
        if tuple(src.shape) == tuple(dst.shape):
            dst.copy_(src)
            copied += 1
    stats = {"copied": copied, "named": named, "total": len(target)}
    frac = named / max(len(target), 1)
    if frac < min_match:
        raise ValueError(
            f"checkpoint {ckpt_dir}@{step} names only {named}/{len(target)} "
            f"tensors ({frac:.0%}) of the model — wrong --net / architecture "
            "for this checkpoint?")
    return stats
