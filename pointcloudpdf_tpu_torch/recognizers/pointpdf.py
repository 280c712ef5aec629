"""PointPdf-v1m1: the PDF probability-driven open-set recognizer.

Counterpart of ``pointcloudpdf_tpu/recognizers/pointpdf.py`` ``PointPdfV1``
(reference: pointcept/recognizers/ours/pointpdf_v1m1_base.py:28-398), in
three parts:

- a U-decoder module (``self.model``, e.g. PointTransformer-Recognizer)
  trained jointly with the backbone after ``start_epoch`` (the trainer
  keeps its parameters out of the step while the loss weight is zero);
- the score and loss functions (CE over ``[seg_logits | score]`` against
  the pseudo-labelled segment, softmax K+1 score);
- the host-side pseudo-labelling pipeline (:mod:`.pseudo_label`), fed by a
  device pass that produces two score sheets per point.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.builder import build_model
from ..models.losses import build_criteria
from .builder import RECOGNIZER
from .pseudo_label import pseudo_labeling_batch


@RECOGNIZER.register_module("PointPdf-v1m1")
class PointPdfV1:
    has_params = True
    has_pseudo_labeling = True

    def __init__(
        self,
        recognizer,
        criteria,
        loss_weight,
        step_loss_weight: bool,
        num_classes: int,
        start_epoch: int,
        kp_ball_radius: float,
        kp_max_neighbor: int,
        condition_from: str = "msp",
        beta: float = 1.5,
        seed_from: str = "ml",
        seed_range: float = 0.01,
        num_seed: int = 20,
        slide_window: bool = False,
        adaptive_radius: bool = False,
        softmax_score: bool = True,
        use_existing_nn: bool = False,
        pseudo_jobs: int = 4,
    ):
        self.model = build_model(dict(recognizer))  # the U-decoder
        self.criteria = build_criteria(criteria)
        self.alpha = float(loss_weight)
        self.step_loss_weight = step_loss_weight
        self.num_classes = num_classes
        self.start_epoch = start_epoch
        self.kp_ball_radius = kp_ball_radius
        self.kp_max_neighbor = kp_max_neighbor
        self.condition_from = condition_from
        self.beta = beta
        self.seed_from = seed_from
        self.seed_range = seed_range
        self.num_seed = num_seed
        self.slide_window = slide_window
        self.adaptive_radius = adaptive_radius
        self.softmax_score = softmax_score
        self.pseudo_jobs = pseudo_jobs
        self.epoch = 0

    # -- epoch schedule ------------------------------------------------------
    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def loss_weight(self, epoch: int) -> float:
        """0 before start_epoch (recognizer frozen), then alpha with the
        one-shot x0.1 decay (reference trigger_operation :384-398)."""
        if epoch < self.start_epoch:
            return 0.0
        if self.step_loss_weight and epoch > self.start_epoch + 1:
            return self.alpha * 0.1
        return self.alpha

    def needs_pseudo(self, epoch: int) -> bool:
        return epoch >= self.start_epoch

    # -- device pieces --------------------------------------------------------
    def score(self, seg_logits: torch.Tensor, rec_raw: torch.Tensor
              ) -> torch.Tensor:
        """(B,N,K) logits + (B,N,1) confidence -> (B,N) unknown-ness."""
        if self.softmax_score:
            open_logits = torch.cat([seg_logits, rec_raw], dim=-1)
            return torch.softmax(open_logits, dim=-1)[..., -1]
        return rec_raw[..., 0]

    def rec_loss(self, seg_logits: torch.Tensor, rec_raw: torch.Tensor,
                 segment_pseudo: torch.Tensor) -> torch.Tensor:
        """CE over K+1 open logits vs pseudo-extended labels (:100-108).
        The caller scales by loss_weight(epoch)."""
        open_logits = torch.cat([seg_logits, rec_raw], dim=-1)
        return self.criteria(open_logits, segment_pseudo)

    def pseudo_scores(self, seg_logits: torch.Tensor, mask: torch.Tensor):
        """(B,N,K) logits -> ((B,N) msp, (B,N) per-sample-normalized max
        logit) — the ONLY per-point values the host graph stage consumes
        (reference pointpdf_v1m1_base.py:211-218).  Computing them on
        device shrinks the host fetch from (N, K) logits to 2 floats per
        point; min/max are masked per sample like the reference's
        per-scene normalization."""
        seg_logits = seg_logits.float()
        msp = torch.softmax(seg_logits, dim=-1).amax(dim=-1)
        ml = seg_logits.amax(dim=-1)
        big = torch.full_like(ml, 1e30)
        ml_min = torch.where(mask, ml, big).amin(dim=1, keepdim=True)
        ml_max = torch.where(mask, ml, -big).amax(dim=1, keepdim=True)
        ml = (ml - ml_min) / (ml_max - ml_min + 1e-6)
        return msp, ml

    # -- host pseudo-labeling ------------------------------------------------
    def pseudo_masks_from_scores(
        self,
        coord: np.ndarray,       # (B, N, 3) host copy (no fetch needed)
        msp: np.ndarray,         # (B, N) device-computed
        ml: np.ndarray,          # (B, N) device-computed, normalized
        count: np.ndarray,
        seed=0,                  # int, or (B,) seeds (pseudo_labeling_batch)
        neighbors: np.ndarray = None,
        ball_radius: float = None,
    ) -> np.ndarray:
        """Scores-only variant: the neighbor table is built host-side
        (scipy cKDTree) from the coords the trainer already holds, so the
        device->host payload is just the two (B, N) score sheets."""
        return pseudo_labeling_batch(
            coord, None, neighbors, count,
            seed=seed,
            n_jobs=self.pseudo_jobs,
            scores=(msp, ml),
            ball_radius=(self.kp_ball_radius if ball_radius is None
                         else ball_radius),
            ball_k=self.kp_max_neighbor,
            condition_from=self.condition_from,
            beta=self.beta,
            seed_from=self.seed_from,
            seed_range=self.seed_range,
            num_seed=self.num_seed,
            slide_window=self.slide_window,
        )
