"""Segmentation losses (counterpart of
``pointcloudpdf_tpu/models/losses/misc.py``; ``CrossEntropyLoss`` so far).

Every loss honours ``ignore_index``, so padded points contribute nothing:
the static-shape replacement for the reference's boolean indexing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .builder import LOSSES


def masked_mean(values, weights, eps=1e-12):
    return (values * weights).sum() / torch.clamp(weights.sum(), min=eps)


@LOSSES.register_module()
class CrossEntropyLoss:
    def __init__(
        self,
        weight: Optional[Sequence[float]] = None,
        size_average=None,
        reduce=None,
        reduction: str = "mean",
        label_smoothing: float = 0.0,
        loss_weight: float = 1.0,
        ignore_index: int = -1,
    ):
        self.weight = (torch.as_tensor(weight, dtype=torch.float32)
                       if weight is not None else None)
        self.reduction = reduction
        self.label_smoothing = label_smoothing
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target):
        pred = pred.reshape(-1, pred.shape[-1])
        target = target.reshape(-1).long()
        num_classes = pred.shape[-1]
        valid = (target != self.ignore_index).float()
        safe_t = target.clamp(0, num_classes - 1)
        logp = torch.log_softmax(pred.float(), dim=-1)
        nll = -logp.gather(-1, safe_t[:, None])[:, 0]
        if self.label_smoothing > 0:
            smooth = -logp.mean(dim=-1)
            nll = (1 - self.label_smoothing) * nll + self.label_smoothing * smooth
        w = valid
        if self.weight is not None:
            w = w * self.weight.to(pred.device)[safe_t]
        if self.reduction == "sum":
            loss = (nll * w).sum()
        else:  # mean: torch divides by the sum of sample weights
            loss = masked_mean(nll, w)
        return loss * self.loss_weight
