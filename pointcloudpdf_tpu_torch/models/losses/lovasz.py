"""Lovasz-Softmax loss over padded batches (counterpart of
``pointcloudpdf_tpu/models/losses/lovasz.py``).

The reference's multiclass path (Pointcept ``losses/lovasz.py``) with
static shapes: ignored entries get error 0, so they sort to the tail and
add nothing to the dot product of errors and the Lovasz gradient; classes
absent from the labels leave the mean.  The errors are sorted descending
by ``argsort(-errors, stable=True)``, the JAX package's stable order, ties
included: the loss does not depend on how ties are ordered, its gradient
does.  Plain PyTorch, as the JAX function is plain jnp.

Over several ranks each rank sorts its own batch's errors, as in the
reference's DDP, and its loss counts for its share (the mean over ranks):
the JAX package's Lovasz under GSPMD is the global batch's.  The errors are
not all-gathered for it.
"""

from __future__ import annotations

import torch

from ...utils import comm
from .builder import LOSSES


def _lovasz_grad_sorted(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to the sorted errors,
    one row a class: (K, P) -> (K, P)."""
    gts = fg_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(dim=-1)
    union = gts + (1.0 - fg_sorted).cumsum(dim=-1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    return torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=-1)


def lovasz_softmax_flat(probs: torch.Tensor, labels: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """probs (P, C) softmax outputs, labels (P,) ints, valid (P,) bool."""
    num_classes = probs.shape[1]
    classes = torch.arange(num_classes, device=probs.device)
    fg = ((labels[None, :] == classes[:, None]) & valid[None, :]).float()  # (C, P)
    errors = (fg - probs.t()).abs() * valid[None, :].float()
    order = torch.argsort(-errors, dim=-1, stable=True)
    errors_sorted = errors.gather(-1, order)
    grad = _lovasz_grad_sorted(fg.gather(-1, order))
    losses = (errors_sorted * grad).sum(dim=-1)
    present = (fg.sum(dim=-1) > 0).float()
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)


@LOSSES.register_module()
class LovaszLoss:
    def __init__(self, mode: str = "multiclass", class_seen=None, per_image=False,
                 ignore_index=-1, loss_weight: float = 1.0):
        assert mode == "multiclass", "only multiclass mode is implemented"
        self.ignore_index = ignore_index
        self.per_image = per_image
        self.class_seen = class_seen
        self.loss_weight = loss_weight

    def __call__(self, pred, target):
        # float32 under autocast too, as the JAX function casts
        pred = pred.reshape(-1, pred.shape[-1]).float()
        target = target.reshape(-1).long()
        probs = torch.softmax(pred, dim=1)
        if self.class_seen is not None:
            probs = probs[:, :self.class_seen]
        valid = target != self.ignore_index
        safe_t = target.clamp(0, probs.shape[1] - 1)
        return comm.rank_share(
            lovasz_softmax_flat(probs, safe_t, valid) * self.loss_weight)
