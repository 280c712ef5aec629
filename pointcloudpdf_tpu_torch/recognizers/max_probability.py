"""MSP / MaxLogit open-set baselines (counterpart of
``pointcloudpdf_tpu/recognizers/max_probability.py``).

Reference: pointcept/recognizers/max_probability/max_probability_v1m1_base.py:8-32
— score = -max log-softmax (msp) or -max logit (ml) of the backbone
seg_logits.  Stateless: no module, no parameters, no extra forward.
"""

from __future__ import annotations

import torch

from .builder import RECOGNIZER


@RECOGNIZER.register_module()
class MaxProbability:
    """Plain-object recognizer; higher score = more likely unknown."""

    # protocol flags consumed by OpenSegTrainer
    has_params = False
    has_pseudo_labeling = False
    softmax_score = False

    def __init__(self, method="msp"):
        if method not in ("msp", "max_logits", "ml"):
            raise ValueError(f"Unknown MaxProbability method {method}")
        self.method = method
        self.epoch = 0

    def score(self, seg_logits: torch.Tensor, rec_raw=None) -> torch.Tensor:
        """(..., K) logits -> (...,) unknown-ness score."""
        if self.method == "msp":
            return -torch.log_softmax(seg_logits, dim=-1).amax(dim=-1)
        return -seg_logits.amax(dim=-1)

    def loss_weight(self, epoch: int) -> float:
        return 0.0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
