"""Default segmentor wrappers (counterparts of
``pointcloudpdf_tpu/models/default.py`` ``DefaultSegmentor`` and
``DefaultSegmentorV2``).

The module owns the backbone (as ``backbone``, the reference's attribute
name) and returns ``{seg_logits, intermediates}``; ``loss`` applies the configured criteria.
A ``generator`` handed to ``forward`` goes on to a backbone whose own
``forward`` takes one (the Stratified Transformer's and PT-v3's drop paths
draw from it).  ``DefaultSegmentorV2`` puts a Linear ``seg_head`` over the
backbone's features when ``num_classes`` > 0 (PT-v3).
"""

from __future__ import annotations

import inspect
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
        self._takes_generator = takes_generator(self.backbone)

    def forward(self, input_dict: Dict, generator=None) -> Dict:
        if self._takes_generator:
            out = self.backbone(input_dict, generator=generator)
        else:
            out = self.backbone(input_dict)
        # backbones without intermediates (PT-v2) return the logits alone
        seg_logits, intermediates = out if isinstance(out, tuple) else (out, {})
        return dict(seg_logits=seg_logits, intermediates=intermediates)

    def loss(self, seg_logits, target):
        return self.criteria(seg_logits, target)


@MODELS.register_module()
class DefaultSegmentorV2(DefaultSegmentor):
    def __init__(self, num_classes: int = 0, backbone_out_channels: int = 0,
                 backbone: Optional[Dict] = None, criteria: Optional[Any] = None):
        super().__init__(backbone, criteria)
        if num_classes > 0 and backbone_out_channels <= 0:
            raise ValueError("DefaultSegmentorV2: a seg_head of num_classes > 0 needs "
                             "backbone_out_channels, the backbone's feature width")
        self.seg_head = (nn.Linear(backbone_out_channels, num_classes)
                         if num_classes > 0 else None)

    def forward(self, input_dict: Dict, generator=None) -> Dict:
        out = super().forward(input_dict, generator)
        if self.seg_head is not None:
            out["seg_logits"] = self.seg_head(out["seg_logits"])
        return out


def takes_generator(module: nn.Module) -> bool:
    """Whether ``module.forward`` takes a ``generator`` argument."""
    return "generator" in inspect.signature(module.forward).parameters
