"""Masked BatchNorm for padded point batches.

Counterpart of ``pointcloudpdf_tpu/models/norm.py`` ``MaskedBatchNorm``:
statistics over valid points only.  The state follows torch's BatchNorm
names (``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``), so reference checkpoints load as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all leading dims of x (..., C) with a validity mask
    broadcastable to x.shape[:-1].  ``momentum`` follows torch:
    running = (1 - m) * running + m * batch; the running variance is
    unbiased, the normalisation biased."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if self.training:
            # statistics in f32 (a bfloat16 input under autocast too)
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            if mask is None:
                w = torch.ones(x.shape[:-1], dtype=xf.dtype, device=x.device)
            else:
                w = mask.expand(x.shape[:-1]).to(xf.dtype)
            cnt = torch.clamp(w.sum(), min=1.0)
            mean = (xf * w[..., None]).sum(dim=dims) / cnt
            var = (xf * xf * w[..., None]).sum(dim=dims) / cnt - mean * mean
            var = torch.clamp(var, min=0.0)
            self._update_running(mean, var, cnt)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * inv + self.bias).to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var, cnt):
        # unbiased running variance, biased normalisation (torch)
        unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean)
        self.running_var.mul_(1 - m).add_(m * unbiased)
        self.num_batches_tracked.add_(1)

    def train_affine(self, mean, var, cnt):
        """Training-mode BN folded into ``(scale, shift)`` over batch
        statistics the caller computed (the fused attention's stats pass).
        ``mean``/``var`` are the masked biased statistics over ``cnt``
        entries; the running statistics update exactly as ``forward``
        would.  Differentiable through mean and var."""
        var = torch.clamp(var, min=0.0)
        self._update_running(mean, var, cnt)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return scale, self.bias - mean * scale

    def affine(self):
        """Eval-mode BN folded into ``(scale, shift)``: y = x*scale + shift."""
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return scale, self.bias - self.running_mean * scale
