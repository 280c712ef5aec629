"""Optimizers on ``torch.optim`` (counterpart of
``pointcloudpdf_tpu/utils/optimizer.py``).

SGD and Adam couple weight decay into the gradient (L2), AdamW decouples
it, as the JAX package's optax chains do; its SGD is weight decay ->
momentum trace -> lr, which is ``torch.optim.SGD``'s order.  Parameter
groups are keyword matches over ``named_parameters`` (the reference's
``param_dicts``); a group's own ``lr`` is kept as ``lr_scale`` = lr /
base lr, the factor the trainer applies to the schedule each step.  A
config key the optimizer does not take (``momentum`` left in an AdamW
dict by a base config's SGD) is dropped with a warning.
"""

from __future__ import annotations

import inspect
from typing import Iterable, List, Optional, Tuple

import torch

from .logger import get_root_logger
from .registry import Registry

OPTIMIZERS = Registry("optimizers")
OPTIMIZERS.register_module("SGD", module=torch.optim.SGD)
OPTIMIZERS.register_module("Adam", module=torch.optim.Adam)
OPTIMIZERS.register_module("AdamW", module=torch.optim.AdamW)


def build_optimizer(cfg, named_parameters: Iterable[Tuple[str, torch.Tensor]],
                    param_dicts: Optional[List[dict]] = None):
    """Build the optimizer from a reference-style config.

    ``named_parameters``: (name, parameter) pairs.  Each ``param_dicts``
    entry ``{keyword, lr?, ...}`` takes the parameters whose name holds
    the keyword (first match wins) into a group of its own."""
    cfg = dict(cfg)
    accepted = inspect.signature(OPTIMIZERS.get(cfg["type"]).__init__).parameters
    ignored = sorted(k for k in cfg if k != "type" and k not in accepted)
    if ignored:
        get_root_logger().warning(
            f"optimizer {cfg['type']} takes no {ignored}: ignored")
        cfg = {k: v for k, v in cfg.items() if k not in ignored}
    base_lr = cfg["lr"]
    named = list(named_parameters)
    groups = [dict(params=[], lr_scale=1.0)]
    for group in param_dicts or []:
        overrides = {k: v for k, v in group.items() if k != "keyword"}
        lr = overrides.pop("lr", None)
        groups.append(dict(params=[], lr_scale=1.0 if lr is None else lr / base_lr,
                           **overrides))
    for name, param in named:
        for i, group in enumerate(param_dicts or []):
            if group["keyword"] in name:
                groups[i + 1]["params"].append(param)
                break
        else:
            groups[0]["params"].append(param)
    for group in groups:
        group["lr"] = base_lr * group["lr_scale"]
    if param_dicts:
        get_root_logger().info(
            "optimizer param groups: " + ", ".join(
                f"group{i}<-'{g['keyword']}'" for i, g in enumerate(param_dicts)))
    cfg["params"] = groups
    return OPTIMIZERS.build(cfg)
