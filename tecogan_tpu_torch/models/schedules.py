"""Learning-rate schedules and the optimizer (port of
``tecogan_tpu/models/schedules.py``).

The schedules are host functions step -> lr: FixedLR, MultiStepLR and
CosineAnnealingRestartLR (BasicSR-style). The reference steps its
schedulers once per iteration, so "epoch" == step, and update k (counting
from 0, as optax's count does) uses ``schedule(k)``: the training step sets
the optimizer's lr to it before each update, which costs no device sync.
"""

from __future__ import annotations

import bisect
import itertools
import math

import torch

__all__ = ["define_lr_schedule", "make_adam", "multistep_lr",
           "cosine_annealing_restart_lr"]


def multistep_lr(base_lr: float, milestones, gamma: float):
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** bisect.bisect_right(ms, step)

    return schedule


def cosine_annealing_restart_lr(base_lr, periods, restart_weights, eta_min):
    """Cosine annealing with warm restarts; each cycle i spans
    ``periods[i]`` steps and restarts scaled by ``restart_weights[i]``."""
    cum = list(itertools.accumulate(periods))
    starts = [0] + cum[:-1]

    def schedule(step: int) -> float:
        # the cycle containing `step` (right-closest, like the reference)
        idx = min(bisect.bisect_left(cum, step), len(periods) - 1)
        # past the last cycle the lr parks at eta_min: the reference
        # (BasicSR) raises there, and letting cos(pi*frac) wrap would
        # raise the lr back toward base_lr mid-training
        frac = min(max((step - starts[idx]) / periods[idx], 0.0), 1.0)
        return eta_min + restart_weights[idx] * 0.5 * (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * frac))

    return schedule


def define_lr_schedule(schedule_opt, base_lr: float):
    """YAML lr_schedule block -> step -> lr callable."""
    if schedule_opt is None or schedule_opt["type"] == "FixedLR":
        return lambda step: float(base_lr)
    stype = schedule_opt["type"]
    if stype == "MultiStepLR":
        return multistep_lr(
            base_lr, schedule_opt["milestones"], schedule_opt["gamma"])
    if stype == "CosineAnnealingRestartLR":
        return cosine_annealing_restart_lr(
            base_lr,
            schedule_opt["periods"],
            schedule_opt.get("restart_weights",
                             [1.0] * len(schedule_opt["periods"])),
            schedule_opt.get("eta_min", 0.0),
        )
    raise ValueError(f"Unrecognized lr schedule: {stype}")


def make_adam(train_opt: dict, params):
    """YAML train.{generator|discriminator} block + parameters ->
    (torch.optim.Adam, schedule).

    torch's Adam is the JAX package's chain: its ``weight_decay`` adds the
    L2 term to the gradient before the moment updates (optax
    ``add_decayed_weights`` before ``scale_by_adam``), and eps sits outside
    the square root of the bias-corrected second moment.
    """
    base_lr = train_opt["lr"]
    betas = tuple(train_opt.get("betas", (0.9, 0.999)))
    wd = train_opt.get("weight_decay", 0)
    schedule = define_lr_schedule(train_opt.get("lr_schedule"), base_lr)
    opt = torch.optim.Adam(params, lr=schedule(0), betas=betas, eps=1e-8,
                           weight_decay=wd)
    return opt, schedule
