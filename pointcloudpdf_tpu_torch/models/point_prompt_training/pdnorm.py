"""Prompt-driven normalization (PDNorm), the counterpart of
``pointcloudpdf_tpu/models/point_prompt_training/pdnorm.py`` (reference
``prompt_driven_normalization.py``): one masked BatchNorm a dataset
condition (``norm.{i}``, the JAX module's ``norm{i}``; one bank when not
decoupled), selected by the forward's ``condition``, and an optional
context-adaptive scale and shift (``modulation.1``, a Linear over SiLU of
the context).  An unknown condition takes bank 0, as in the JAX module.
No shipped backbone builds it: SpUNet-v1m3, PT-v2m3 and PT-v3 carry their
own PD norms (``models/norm.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..norm import MaskedBatchNorm, _modulate


class PDNorm(nn.Module):
    def __init__(self, num_features: int,
                 conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D"),
                 context_channels: int = 256, decouple: bool = True,
                 adaptive: bool = False, momentum: float = 0.01, eps: float = 1e-3):
        super().__init__()
        self.conditions = tuple(conditions)
        self.decouple = decouple
        self.adaptive = adaptive
        self.norm = nn.ModuleList(
            MaskedBatchNorm(num_features, eps=eps, momentum=momentum)
            for _ in range(len(self.conditions) if decouple else 1))
        if adaptive:
            self.modulation = nn.Sequential(
                nn.SiLU(), nn.Linear(context_channels, 2 * num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                condition: Optional[str] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        bank = (self.conditions.index(condition)
                if self.decouple and condition in self.conditions else 0)
        y = self.norm[bank](x, mask)
        if self.adaptive:
            y = _modulate(self.modulation, y, context)
        return y
