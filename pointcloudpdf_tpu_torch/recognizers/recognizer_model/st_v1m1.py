"""Stratified Transformer uncertainty decoder of the PDF recognizer.

Counterpart of ``pointcloudpdf_tpu/recognizers/recognizer_model/
st_v1m1.py`` ``STRecognizer``: a second upsample ladder that starts from
the backbone's bottleneck (``enc{num_layers-1}``) and, at each step, blends
the main decoder's output at the finer level (``up{step}``) with a 3-NN
interpolation of its own running features, ending in a 1-channel
confidence MLP.  Submodules: ``upsamples.{step}`` (the backbone's
``Upsample``) and ``classifier`` = Sequential(Linear, MaskedBatchNorm,
ReLU, Linear).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ...models.builder import MODELS
from ...models.norm import MaskedBatchNorm
from ...models.stratified_transformer.st import Upsample
from ...models.utils.structure import Points, where_valid


@MODELS.register_module("ST-v1m1-Recognizer")
class STRecognizer(nn.Module):
    """intermediates (enc{L-1}, up0..up{L-2} Points) -> confidence (B,N,1)."""

    def __init__(self, up_k: int, channels: Sequence[int], num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        self.upsamples = nn.ModuleList([
            Upsample(up_k, channels[i], channels[i - 1])
            for i in range(num_layers - 1, 0, -1)])
        self.classifier = nn.Sequential(
            nn.Linear(channels[0], channels[0]), MaskedBatchNorm(channels[0]),
            nn.ReLU(inplace=True), nn.Linear(channels[0], 1))

    def forward(self, intermediates: Dict[str, Points]) -> torch.Tensor:
        pts = intermediates[f"enc{self.num_layers - 1}"]
        for step, up in enumerate(self.upsamples):
            pts = up(pts, intermediates[f"up{step}"])
        lin1, bn, relu, lin2 = self.classifier
        conf = lin2(relu(bn(lin1(pts.feat), pts.mask)))
        return where_valid(pts.mask, conf)
