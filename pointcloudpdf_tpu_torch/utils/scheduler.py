"""LR schedules as pure step->lr callables (counterpart of
``pointcloudpdf_tpu/utils/scheduler.py``, same signatures and curves).

Each registered schedule receives ``total_steps`` (injected by the trainer)
plus its own knobs and returns ``schedule(step) -> lr`` scaled from the
optimizer's base lr; the trainer sets each parameter group's ``lr`` from
it before every optimizer step.
"""

from __future__ import annotations

import inspect
import math

from .logger import get_root_logger
from .registry import Registry

SCHEDULERS = Registry("schedulers")


@SCHEDULERS.register_module()
class MultiStepLR:
    def __init__(self, total_steps, milestones, gamma=0.1, base_lr=1.0):
        self.milestones = sorted(rate * total_steps for rate in milestones)
        self.gamma = gamma
        self.base_lr = base_lr

    def __call__(self, step):
        factor = 1.0
        for m in self.milestones:
            factor = factor * (self.gamma ** (step >= m))
        return self.base_lr * factor


@SCHEDULERS.register_module()
class MultiStepWithWarmupLR:
    def __init__(self, total_steps, milestones, gamma=0.1, warmup_rate=0.05,
                 warmup_scale=1e-6, base_lr=1.0):
        self.total_steps = total_steps
        self.milestones = sorted(rate * total_steps for rate in milestones)
        self.gamma = gamma
        self.warmup_rate = warmup_rate
        self.warmup_scale = warmup_scale
        self.base_lr = base_lr

    def __call__(self, step):
        factor = 1.0
        for m in self.milestones:
            factor = factor * (self.gamma ** (step >= m))
        warmup_steps = self.warmup_rate * self.total_steps
        ratio = step / max(warmup_steps, 1e-12)
        warmup = 1 - (1 - ratio) * (1 - self.warmup_scale)
        coef = warmup * (step <= warmup_steps) + 1.0 * (step > warmup_steps)
        return self.base_lr * factor * coef


@SCHEDULERS.register_module()
class PolyLR:
    def __init__(self, total_steps, power=0.9, base_lr=1.0):
        self.total_steps = total_steps
        self.power = power
        self.base_lr = base_lr

    def __call__(self, step):
        return self.base_lr * (1 - step / (self.total_steps + 1)) ** self.power


@SCHEDULERS.register_module()
class ExpLR:
    def __init__(self, total_steps, gamma=0.9, base_lr=1.0):
        self.total_steps = total_steps
        self.gamma = gamma
        self.base_lr = base_lr

    def __call__(self, step):
        return self.base_lr * self.gamma ** (step / self.total_steps)


@SCHEDULERS.register_module()
class CosineAnnealingLR:
    def __init__(self, total_steps, eta_min=0.0, base_lr=1.0):
        self.total_steps = total_steps
        self.eta_min = eta_min
        self.base_lr = base_lr

    def __call__(self, step):
        cos = (1 + math.cos(math.pi * step / self.total_steps)) / 2
        return self.eta_min + (self.base_lr - self.eta_min) * cos


@SCHEDULERS.register_module()
class OneCycleLR:
    """Cosine one-cycle lr (warmup to max_lr then anneal to ~0).

    The torch version also cycles momentum (scheduler.py OneCycleLR);
    momentum cycling is omitted, as in the JAX package.
    """

    def __init__(self, total_steps, max_lr, pct_start=0.3,
                 anneal_strategy="cos", div_factor=25.0,
                 final_div_factor=1e4, base_lr=None, **_ignored):
        self.total_steps = total_steps
        self.max_lr = max_lr if not isinstance(max_lr, (list, tuple)) else max_lr[0]
        self.pct_start = pct_start
        self.initial_lr = self.max_lr / div_factor
        self.min_lr = self.initial_lr / final_div_factor

    def __call__(self, step):
        # torch OneCycleLR phase boundaries: the warm phase spans
        # ``pct_start * total_steps - 1`` scheduler steps and the anneal
        # the remainder
        up_steps = float(self.pct_start * self.total_steps) - 1.0
        down_steps = float(self.total_steps - up_steps - 1.0)
        if step < up_steps:
            pct = min(max(step / max(up_steps, 1e-12), 0.0), 1.0)
            return self.initial_lr + (self.max_lr - self.initial_lr) * (
                1 - math.cos(math.pi * pct)) / 2
        pct = min(max((step - up_steps) / max(down_steps, 1e-12), 0.0), 1.0)
        return self.min_lr + (self.max_lr - self.min_lr) * (
            1 + math.cos(math.pi * pct)) / 2


def build_scheduler(cfg, base_lr: float, total_steps: int):
    """Build a step->lr schedule; cfg follows the reference's dicts.  A key
    the schedule does not take is dropped with a warning: a derived
    config's schedule dict merges over its base's and keeps the base's keys
    (the S3DIS SpUNet configs' ``PolyLR`` holds the PT-v1 base's
    ``MultiStepLR`` ``milestones`` and ``gamma``)."""
    cfg = dict(cfg)
    cfg.setdefault("total_steps", total_steps)
    cfg.setdefault("base_lr", base_lr)
    if cfg.get("type") == "OneCycleLR":
        cfg.pop("base_lr", None)
    accepted = inspect.signature(SCHEDULERS.get(cfg["type"])).parameters
    ignored = sorted(k for k in cfg if k != "type" and k not in accepted)
    if ignored:
        get_root_logger().warning(f"schedule {cfg['type']} takes no {ignored}: ignored")
        cfg = {k: v for k, v in cfg.items() if k not in ignored}
    return SCHEDULERS.build(cfg)
