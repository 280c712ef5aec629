"""Segmentation losses (counterpart of
``pointcloudpdf_tpu/models/losses/misc.py``): ``CrossEntropyLoss``,
``SmoothCELoss``, ``BinaryFocalLoss``, ``FocalLoss`` and ``DiceLoss``.

Every loss honours ``ignore_index``, so padded points contribute nothing:
the static-shape replacement for the reference's boolean indexing.  Over
several ranks a mean over points divides by the weight count of the
global batch, so the ranks' losses (and gradients) sum to the one-process
loss of that batch, as the JAX package's loss under GSPMD.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.nn import functional as F

from ...utils import comm
from .builder import LOSSES


def _flatten(pred, target):
    return pred.reshape(-1, pred.shape[-1]), target.reshape(-1).long()


def masked_mean(values, weights, eps=1e-12):
    """This rank's part of the global batch's weighted mean."""
    return (values * weights).sum() / torch.clamp(
        comm.sum_over_ranks(weights.sum()), min=eps)


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
        pred, target = _flatten(pred, target)
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


@LOSSES.register_module()
class SmoothCELoss:
    def __init__(self, smoothing_ratio: float = 0.1):
        self.smoothing_ratio = smoothing_ratio

    def __call__(self, pred, target):
        pred, target = _flatten(pred, target)
        eps = self.smoothing_ratio
        n_class = pred.shape[1]
        valid = (target >= 0).float()
        one_hot = F.one_hot(target.clamp(0, n_class - 1), n_class).float()
        one_hot = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
        logp = torch.log_softmax(pred.float(), dim=1)
        return masked_mean(-(one_hot * logp).sum(dim=1), valid)


def _bce_with_logits(pred, target):
    """Binary cross-entropy of logits, the stable form
    max(x, 0) - x t + log(1 + exp(-|x|))."""
    return torch.clamp(pred, min=0) - pred * target + torch.log1p(
        torch.exp(-pred.abs()))


@LOSSES.register_module()
class BinaryFocalLoss:
    def __init__(self, gamma=2.0, alpha=0.5, logits=True, reduce=True,
                 loss_weight=1.0):
        assert 0 < alpha < 1
        self.gamma = gamma
        self.alpha = alpha
        self.logits = logits
        self.reduce = reduce
        self.loss_weight = loss_weight

    def __call__(self, pred, target, **kwargs):
        """pred (N,) raw logits or probabilities; target (N,) in [0, 1]."""
        pred = pred.reshape(-1).float()
        target = target.reshape(-1).float()
        if self.logits:
            bce = _bce_with_logits(pred, target)
        else:
            bce = -(target * torch.log(pred.clamp(1e-12, 1.0))
                    + (1 - target) * torch.log((1 - pred).clamp(1e-12, 1.0)))
        pt = torch.exp(-bce)
        alpha = self.alpha * target + (1 - self.alpha) * (1 - target)
        focal = alpha * (1 - pt) ** self.gamma * bce
        if self.reduce:
            focal = (focal.sum() / comm.sum_over_ranks(
                focal.new_tensor(float(focal.numel())))
                if comm.is_distributed() else focal.mean())
        return focal * self.loss_weight


@LOSSES.register_module()
class FocalLoss:
    def __init__(self, gamma=2.0, alpha=0.5, reduction="mean", loss_weight=1.0,
                 ignore_index=-1):
        assert reduction in ("mean", "sum")
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, **kwargs):
        pred, target = _flatten(pred, target)
        pred = pred.float()
        num_classes = pred.shape[1]
        valid = (target != self.ignore_index).float()[:, None]
        one_hot = F.one_hot(target.clamp(0, num_classes - 1), num_classes).float()
        alpha = self.alpha
        if isinstance(alpha, (list, tuple)):
            alpha = torch.as_tensor(alpha, dtype=torch.float32, device=pred.device)
        p = torch.sigmoid(pred)
        one_minus_pt = (1 - p) * one_hot + p * (1 - one_hot)
        focal_weight = (alpha * one_hot + (1 - alpha) * (1 - one_hot)) * (
            one_minus_pt ** self.gamma)
        loss = _bce_with_logits(pred, one_hot) * focal_weight * valid
        if self.reduction == "mean":
            loss = loss.sum() / torch.clamp(
                comm.sum_over_ranks(valid.sum()) * num_classes, min=1e-12)
        else:
            loss = loss.sum()
        return self.loss_weight * loss


@LOSSES.register_module()
class DiceLoss:
    def __init__(self, smooth=1, exponent=2, loss_weight=1.0, ignore_index=-1):
        self.smooth = smooth
        self.exponent = exponent
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, **kwargs):
        pred, target = _flatten(pred, target)
        num_classes = pred.shape[1]
        valid = (target != self.ignore_index).float()[:, None]
        prob = torch.softmax(pred.float(), dim=1) * valid
        one_hot = F.one_hot(target.clamp(0, num_classes - 1),
                            num_classes).float() * valid
        # the per-class sums of the global batch; each rank holds the whole
        # loss, and counts for its share
        num = comm.sum_over_ranks((prob * one_hot).sum(dim=0)) * 2 + self.smooth
        den = comm.sum_over_ranks(
            (prob ** self.exponent + one_hot ** self.exponent).sum(dim=0)
        ) + self.smooth
        return comm.rank_share(self.loss_weight * (1 - num / den).mean())
