"""Default segmentor wrapper (counterpart of
``pointcloudpdf_tpu/models/default.py`` ``DefaultSegmentor``).

The module owns the backbone (as ``backbone``, the reference's attribute
name) and returns ``{seg_logits, intermediates}``; ``loss`` applies the configured criteria.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from torch import nn

from .builder import MODELS, build_model
from .losses import build_criteria


@MODELS.register_module()
class DefaultSegmentor(nn.Module):
    def __init__(self, backbone: Optional[Dict] = None,
                 criteria: Optional[Any] = None):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.criteria = build_criteria(criteria)

    def forward(self, input_dict: Dict) -> Dict:
        out = self.backbone(input_dict)
        # backbones without intermediates (PT-v2) return the logits alone
        seg_logits, intermediates = out if isinstance(out, tuple) else (out, {})
        return dict(seg_logits=seg_logits, intermediates=intermediates)

    def loss(self, seg_logits, target):
        return self.criteria(seg_logits, target)
