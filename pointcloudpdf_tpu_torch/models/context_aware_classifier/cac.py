"""Context-Aware Classifier segmentor (CAC-v1m1).

Counterpart of ``pointcloudpdf_tpu/models/context_aware_classifier/cac.py``
(reference Pointcept ``context_aware_classifier_v1m1_base.py``): a cosine
prototype classifier over a backbone's features with two context
branches:

- *post refinement*: per-sample soft class prototypes (softmax-weighted
  means of the valid points' features) joined to the learned prototypes
  and projected, then the features scored against them;
- *adaptive perspective* (training only): the ground-truth class means of
  the batch replace the learned prototypes where a class is present;
- a class-balanced, entropy-weighted distillation from the second branch
  into the first.

Submodules carry the reference's names (``backbone``, ``seg_head`` whose
weight doubles as the prototypes, ``proj``, ``apd_proj``,
``feat_proj_layer``).  In training, with ``segment`` in the batch, the
forward returns its own ``loss`` and the four parts the trainer logs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..builder import MODELS, build_model
from ..default import takes_generator
from ..losses import build_criteria
from ...utils import comm
from ..norm import MaskedBatchNorm


def _l2norm(x, dim=-1):
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-8)


def _proj(c):
    """Linear(2c, 2c, no bias) -> ReLU -> Linear(2c, c)."""
    return nn.Sequential(nn.Linear(2 * c, 2 * c, bias=False), nn.ReLU(inplace=True),
                         nn.Linear(2 * c, c))


@MODELS.register_module("CAC-v1m1")
class CACSegmentor(nn.Module):
    def __init__(self, num_classes: int, backbone_out_channels: int,
                 backbone: Optional[Dict] = None, criteria: Optional[Any] = None,
                 cos_temp: float = 15.0, main_weight: float = 1.0,
                 pre_weight: float = 1.0, pre_self_weight: float = 1.0,
                 kl_weight: float = 1.0, conf_thresh: float = 0.0,
                 detach_pre_logits: bool = False):
        super().__init__()
        c = backbone_out_channels
        self.num_classes = num_classes
        self.cos_temp = cos_temp
        self.main_weight = main_weight
        self.pre_weight = pre_weight
        self.pre_self_weight = pre_self_weight
        self.kl_weight = kl_weight
        self.conf_thresh = conf_thresh
        self.detach_pre_logits = detach_pre_logits
        self.backbone = build_model(dict(backbone))
        self._takes_generator = takes_generator(self.backbone)
        self.seg_head = nn.Linear(c, num_classes)
        self.proj = _proj(c)
        self.apd_proj = _proj(c)
        self.feat_proj_layer = nn.Sequential(
            nn.Linear(c, c, bias=False), MaskedBatchNorm(c), nn.ReLU(inplace=True),
            nn.Linear(c, c))
        self.criteria = build_criteria(criteria)

    def _feat_proj(self, x, mask):
        lin1, bn, _, lin2 = self.feat_proj_layer
        return lin2(F.relu(bn(lin1(x), mask)))

    def _refine(self, feat, pred, mask):
        """Per-sample soft-prototype refinement (reference :103-149)."""
        if self.detach_pre_logits:
            pred = pred.detach()
        w = torch.softmax(pred, dim=-1).transpose(1, 2)          # (B, cls, N)
        w = w * mask[:, None, :].to(w.dtype)
        if self.conf_thresh > 0:
            keep = (w.amax(dim=1) >= self.conf_thresh).to(w.dtype)
            w = w * keep[:, None, :]
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-7)
        pred_proto = w @ feat                                     # (B, cls, c)
        proto = self.seg_head.weight
        pred_proto = self.proj(torch.cat(
            [pred_proto, proto[None].expand(feat.shape[0], -1, -1)], dim=-1))
        x = self._feat_proj(feat, mask)
        return torch.einsum("bnc,bkc->bnk", _l2norm(x), _l2norm(pred_proto))

    def _adaptive(self, feat, target, mask):
        """Ground-truth class means in place of the prototypes where a class
        is present (reference :73-101), over the whole batch (over ranks,
        the global batch's)."""
        c = feat.shape[-1]
        flat = feat.reshape(-1, c)
        tgt = target.reshape(-1).long()
        m = (mask.reshape(-1) & (tgt != -1)).to(flat.dtype)
        safe = tgt.clamp(0, self.num_classes - 1)
        sums = comm.sum_over_ranks(flat.new_zeros((self.num_classes, c)).index_add(
            0, safe, flat * m[:, None]))
        counts = comm.sum_over_ranks(
            flat.new_zeros((self.num_classes,)).index_add(0, safe, m))
        class_mean = sums / torch.clamp(counts[:, None], min=1e-4)
        proto = self.seg_head.weight
        new_proto = torch.where((counts > 0)[:, None], class_mean, proto.detach())
        new_proto = self.apd_proj(torch.cat([new_proto, proto], dim=-1))
        x = self._feat_proj(feat, mask)
        return torch.einsum("...nc,kc->...nk", _l2norm(x), _l2norm(new_proto))

    def _distill_loss(self, pred, soft, target, mask, smoothness=0.5):
        """Class-balanced, entropy-weighted distillation (reference
        :152-200), its class sums the global batch's over ranks."""
        soft = soft.detach()
        k = pred.shape[-1]
        sm = torch.softmax(soft, dim=-1)
        target = target.long()
        valid = mask & (target != -1)
        onehot = F.one_hot(target.clamp(0, k - 1), k).to(pred.dtype)
        onehot = onehot * valid[..., None]
        smoothed = smoothness * sm + (1 - smoothness) * onehot
        loss = -(torch.log_softmax(pred, dim=-1) * smoothed).sum(-1)
        entropy = -(sm * torch.log(sm + 1e-4)).sum(-1) * valid.to(sm.dtype)
        flat_t = target.reshape(-1).clamp(0, k - 1)
        flat_l = loss.reshape(-1)
        flat_e = entropy.reshape(-1) * valid.reshape(-1)
        num = comm.sum_over_ranks(
            flat_l.new_zeros((k,)).index_add(0, flat_t, flat_l * flat_e))
        den = comm.sum_over_ranks(
            flat_l.new_zeros((k,)).index_add(0, flat_t, flat_e))
        has = den > 1e-4
        per_class = torch.where(has, num / torch.clamp(den, min=1e-4),
                                torch.zeros_like(num))
        return comm.rank_share(
            per_class.sum() / torch.clamp(has.sum().to(num.dtype), min=1e-4))

    def forward(self, input_dict: Dict, generator=None) -> Dict:
        mask = input_dict["mask"].to(torch.bool)
        if self._takes_generator:
            out = self.backbone(input_dict, generator=generator)
        else:
            out = self.backbone(input_dict)
        feat = out[0] if isinstance(out, tuple) else out
        seg_logits = self.seg_head(feat)
        refine = self._refine(feat, seg_logits, mask) * self.cos_temp
        result = dict(seg_logits=torch.where(mask[..., None], refine,
                                             torch.zeros_like(refine)))
        if self.training and "segment" in input_dict:
            target = input_dict["segment"]
            cac_pred = self._adaptive(feat, target, mask) * self.cos_temp
            seg_loss = self.criteria(refine, target) * self.main_weight
            pre_loss = self.criteria(cac_pred, target) * self.pre_weight
            pre_self_loss = self.criteria(seg_logits, target) * self.pre_self_weight
            kl_loss = self._distill_loss(refine, cac_pred, target, mask) * self.kl_weight
            result.update(loss=seg_loss + pre_loss + pre_self_loss + kl_loss,
                          seg_loss=seg_loss, pre_loss=pre_loss,
                          pre_self_loss=pre_self_loss, kl_loss=kl_loss)
        return result

    def loss(self, seg_logits, target):
        return self.criteria(seg_logits, target)
