"""Default segmentor wrapper (counterpart of
``pointcloudpdf_tpu/models/default.py`` ``DefaultSegmentor``).

The module owns the backbone (as ``backbone``, the reference's attribute
name) and returns ``{seg_logits, intermediates}``; ``loss`` applies the configured criteria.
A ``generator`` handed to ``forward`` goes on to a backbone whose own
``forward`` takes one (the Stratified Transformer's drop path draws from it).
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


def takes_generator(module: nn.Module) -> bool:
    """Whether ``module.forward`` takes a ``generator`` argument."""
    return "generator" in inspect.signature(module.forward).parameters
