"""SGD with the reference's parameter groups — counterpart of
``i2vsgg_tpu/train/optim.py`` (``trainval_net_instance_styleD_bilinear.py:
134-148``):

* SGD with momentum 0.9, as torch's (``buf = mu * buf + g``, no dampening:
  optax's ``trace``);
* weight decay on weights only (``BIAS_DECAY=False``);
* biases at twice the learning rate (``DOUBLE_BIAS``);
* the frozen params (``trunk/conv1``, ``trunk/bn1``) get no update;
* an optional global-norm clip over the non-frozen gradients only
  (``clip_gradient``, net_utils.py:88-99: frozen layers have no grad there).

Labels are given by JAX's rules on JAX's path names: a port parameter
``trunk.layer1.block0.conv1.weight`` is the flax leaf
``trunk/layer1/block0/conv1/kernel``, and the frozen prefixes match the
joined path as a string prefix, as JAX's ``make_label_fn`` matches them (so
``trunk/conv1`` also freezes VGG16's ``conv10``-``conv12``, as in JAX). The
FrozenBatchNorm affines, which JAX keeps as params labelled frozen, are
buffers in the port and stay out of the optimizer altogether. Frozen params
get ``requires_grad_(False)``: autograd computes no gradient for them, which
is what JAX's zeroed frozen gradients amount to.

The learning rate is set on every step from the step count
(``step_decay_schedule``), as optax's ``scale_by_schedule`` reads its
update count.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
from torch import nn

FROZEN_PREFIXES = ("trunk/conv1", "trunk/bn1")


def jax_path(name: str) -> str:
    """A port parameter's name as its flax path (``weight`` -> ``kernel``)."""
    segs = name.split(".")
    if segs[-1] == "weight":
        segs[-1] = "kernel"
    return "/".join(segs)


def param_label(name: str,
                frozen_prefixes: Sequence[str] = FROZEN_PREFIXES) -> str:
    """'frozen' | 'bias' | 'weight' for a port parameter, by JAX's
    ``make_label_fn`` on its flax path."""
    s = jax_path(name)
    if any(s.startswith(p) for p in frozen_prefixes):
        return "frozen"
    segs = s.split("/")
    if any(seg.startswith("bn") or seg.endswith("_bn") for seg in segs[:-1]):
        return "frozen"
    return "bias" if segs[-1] == "bias" else "weight"


def step_decay_schedule(base_lr: float, decay_step_epochs: int,
                        gamma: float, steps_per_epoch: int) -> Callable:
    """lr *= gamma every ``decay_step_epochs`` epochs (reference
    ``:232-234``)."""
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * gamma ** float(epoch // decay_step_epochs)
    return schedule


class ReferenceSGD:
    """The reference's SGD over ``model``'s parameters.

    ``groups``: {"weight": [...], "bias": [...]} of (name, param); frozen
    params are in neither and get ``requires_grad_(False)``. ``step(i)``
    clips, sets each group's lr from ``lr_schedule(i)`` and updates; a
    param whose grad is None is updated as with a zero gradient (its decay
    and momentum still act, as in optax)."""

    def __init__(self, model: nn.Module, lr_schedule: Callable | float, cfg,
                 frozen_prefixes: Sequence[str] = FROZEN_PREFIXES,
                 clip_norm: float = 0.0):
        t = cfg.TRAIN
        if not callable(lr_schedule):
            base = float(lr_schedule)
            lr_schedule = lambda step: base  # noqa: E731
        self.lr_schedule = lr_schedule
        self.clip_norm = float(clip_norm)
        self.groups: Dict[str, list] = {"weight": [], "bias": []}
        for name, p in model.named_parameters():
            label = param_label(name, frozen_prefixes)
            if label == "frozen":
                p.requires_grad_(False)
            else:
                self.groups[label].append((name, p))
        self.mult = {"weight": 1.0,
                     "bias": 2.0 if t.DOUBLE_BIAS else 1.0}
        decay = {"weight": t.WEIGHT_DECAY,
                 "bias": t.WEIGHT_DECAY if t.BIAS_DECAY else 0.0}
        self.opt = torch.optim.SGD(
            [{"params": [p for _, p in self.groups[g]], "name": g,
              "weight_decay": decay[g]} for g in ("weight", "bias")],
            lr=lr_schedule(0), momentum=t.MOMENTUM, dampening=0.0,
            nesterov=False)

    def params(self):
        return [p for g in ("weight", "bias") for _, p in self.groups[g]]

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def clip(self) -> torch.Tensor | None:
        """optax's ``clip_by_global_norm`` over the non-frozen gradients:
        ``g / norm * clip`` where the norm exceeds the clip. Returns the
        norm (None without a clip)."""
        if self.clip_norm <= 0:
            return None
        grads = [p.grad for p in self.params()]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if norm >= self.clip_norm:
            for g in grads:
                g.copy_(g / norm * self.clip_norm)
        return norm

    def step(self, step: int):
        for p in self.params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.clip()
        lr = float(self.lr_schedule(step))
        for group in self.opt.param_groups:
            group["lr"] = lr * self.mult[group["name"]]
        self.opt.step()

    def momentum(self) -> Dict[str, torch.Tensor]:
        """{param name: momentum buffer} (empty before the first step)."""
        return {name: self.opt.state[p]["momentum_buffer"]
                for g in ("weight", "bias") for name, p in self.groups[g]
                if "momentum_buffer" in self.opt.state.get(p, {})}

    @torch.no_grad()
    def load_momentum(self, buffers: Dict[str, torch.Tensor]):
        """Set the momentum buffers by parameter name (e.g. a JAX
        ``TrainState``'s optax traces through ``utils/weights.py::
        params_from_jax``); every non-frozen param must be named."""
        for g in ("weight", "bias"):
            for name, p in self.groups[g]:
                self.opt.state[p]["momentum_buffer"] = buffers[name].to(
                    p.device, p.dtype).clone()

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, sd):
        self.opt.load_state_dict(sd)
