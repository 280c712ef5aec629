"""Incremental learner: distil an open-set teacher into an extended student.

Counterpart of ``pointcloudpdf_tpu/incr_learners/pointpdf_incr.py``
(reference pointcept/incrLearners/ours/pointpdf_incr_v1m1_base.py:13-87).
The student is an ``nn.Module`` built from the learner's ``backbone`` (base
plus new class logits); the trainer owns the frozen teacher and runs its
forward under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.builder import build_model
from ..models.losses import build_criteria
from ..utils import comm
from .builder import INCREMENTALLEARNER


def incr_distill_kl_loss(pred, target, segment_incr, mask,
                         pred_temp: float = 1.0, target_temp: float = 1.0,
                         loss_weight: float = 1.0) -> torch.Tensor:
    """KL(q || softmax(pred)): ``pred`` (B, N, K_new) student logits,
    ``target`` (B, N, K_base) teacher logits, ``segment_incr`` (B, N) new-class
    labels (-1 elsewhere), ``mask`` (B, N) valid points.  q is the teacher's
    softmax zero-padded to K_new, one-hot at the labelled new-class points;
    the mean runs over valid points (the reference's ``batchmean`` over
    packed points; the global batch's over several ranks).  In float32."""
    k_new, k_base = pred.shape[-1], target.shape[-1]
    log_p = torch.log_softmax(pred.float() / pred_temp, dim=-1)
    soft = F.pad(torch.softmax(target.float() / target_temp, dim=-1),
                 (0, k_new - k_base))
    labeled = segment_incr != -1
    one_hot = F.one_hot(segment_incr.clamp(0, k_new - 1).long(),
                        k_new).to(soft.dtype)
    q = torch.where(labeled[..., None], one_hot, soft)
    # q log q with 0 log 0 = 0
    log_q = torch.where(q > 0, torch.log(q.clamp_min(1e-30)),
                        torch.zeros_like(q))
    kl = (q * (log_q - log_p)).sum(dim=-1)
    valid = mask.to(kl.dtype)
    return loss_weight * (kl * valid).sum() / comm.sum_over_ranks(
        valid.sum()).clamp_min(1.0)


@INCREMENTALLEARNER.register_module("PointPdf-incr-v1m1")
class PointPdfIncrV1:
    need_teacher_model = True

    def __init__(self, backbone=None, eval_criteria=None,
                 pred_temp: float = 1.0, target_temp: float = 1.0,
                 loss_weight: float = 1.0):
        self.model = build_model(dict(backbone))  # the student
        self.eval_criteria = build_criteria(eval_criteria)
        self.pred_temp = pred_temp
        self.target_temp = target_temp
        self.loss_weight = loss_weight

    def distill_loss(self, student_logits, teacher_logits, segment_incr, mask):
        return incr_distill_kl_loss(
            student_logits, teacher_logits.detach(), segment_incr, mask,
            self.pred_temp, self.target_temp, self.loss_weight)

    def eval_loss(self, student_logits, segment_incr_remap):
        return self.eval_criteria(student_logits, segment_incr_remap)
