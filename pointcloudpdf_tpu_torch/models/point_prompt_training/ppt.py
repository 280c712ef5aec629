"""Point Prompt Training (PPT): one backbone trained on several datasets,
conditioned by the dataset.

Counterpart of ``pointcloudpdf_tpu/models/point_prompt_training/ppt.py``
(reference ``point_prompt_training_v1m1_language_guided.py`` and
``point_prompt_training_v1m2_decoupled.py``).  ``forward(input_dict,
generator=None, condition=None)``: the condition (the call's, else the
batch's ``condition_name``) picks a row of ``embedding_table``, which goes
to the backbone as the batch's ``context`` (its adaptive PD norms read it),
and the backbone is called with ``condition=`` where its forward takes one
(its PD norms' banks) and with the trainer's ``generator`` where it takes
one (drop path).

- ``PPT-v1m1``: the backbone's features through ``proj_head``, normalised,
  against the normalised rows of ``class_embedding`` that the condition's
  dataset labels (``valid_index``), times ``exp(logit_scale)``.  The class
  table is a trainable parameter, as in the JAX package: the normalised
  ``.npy`` at ``class_embedding_path``, else truncated normal at 0.02
  (the reference's frozen CLIP text features need CLIP, which neither
  package carries; ``template`` and ``clip_model`` are accepted and unused).
- ``PPT-v1m2``: a Linear head a condition (``seg_heads.{i}``); only the
  condition's head runs.  The idle heads take a zero gradient from the
  trainer (``Trainer.reduce_gradients``), as the JAX step hands them one.

With ``backbone_mode`` the forward returns the backbone's features.  With
``segment`` in the batch the output holds the criteria's ``loss`` (the
model-computed loss contract, ``Trainer.compute_loss``).  Parameter names
follow the reference: ``backbone.*``, ``embedding_table.weight``,
``proj_head``, ``class_embedding``, ``logit_scale``, ``seg_heads.{i}``.
"""

from __future__ import annotations

import inspect
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..builder import MODELS, build_model
from ..default import takes_generator
from ..losses import build_criteria

DEFAULT_CLASS_NAMES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "bookcase", "picture", "counter", "desk",
    "shelves", "curtain", "dresser", "pillow", "mirror", "ceiling",
    "refrigerator", "television", "shower curtain", "nightstand", "toilet",
    "sink", "lamp", "bathtub", "garbagebin", "board", "beam", "column",
    "clutter", "otherstructure", "otherfurniture", "otherprop",
)
DEFAULT_VALID_INDEX = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 23,
     25, 26, 33, 34, 35),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 15, 20, 22, 24, 25, 27, 34),
    (0, 1, 4, 5, 6, 7, 8, 10, 19, 29, 30, 31, 32),
)


class _PromptedBackbone(nn.Module):
    """What PPT-v1m1 and -v1m2 share: the backbone, the condition's
    context and the model-computed loss."""

    def __init__(self, backbone: Dict, criteria, context_channels: int,
                 conditions: Sequence[str], backbone_mode: bool):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.criteria = build_criteria(criteria)
        self.conditions = tuple(conditions)
        self.backbone_mode = backbone_mode
        self.embedding_table = nn.Embedding(len(self.conditions), context_channels)
        params = inspect.signature(self.backbone.forward).parameters
        self._takes_condition = "condition" in params
        self._takes_generator = takes_generator(self.backbone)

    def condition_index(self, input_dict: Dict, condition: Optional[str]) -> int:
        condition = condition or input_dict.get("condition_name")
        if condition not in self.conditions:
            raise ValueError(f"PPT: condition {condition!r} not in {self.conditions}")
        return self.conditions.index(condition)

    def features(self, input_dict: Dict, ci: int, generator=None) -> torch.Tensor:
        """The backbone's features under condition ``ci``."""
        data = dict(input_dict, context=self.embedding_table.weight[ci:ci + 1])
        kwargs = {}
        if self._takes_condition:
            kwargs["condition"] = self.conditions[ci]
        if self._takes_generator:
            kwargs["generator"] = generator
        out = self.backbone(data, **kwargs)
        return out[0] if isinstance(out, tuple) else out

    def result(self, seg_logits: torch.Tensor, input_dict: Dict) -> Dict:
        result = dict(seg_logits=seg_logits)
        if "segment" in input_dict:
            result["loss"] = self.loss(seg_logits, input_dict["segment"])
        return result

    def loss(self, seg_logits, target):
        return self.criteria(seg_logits, target)


@MODELS.register_module("PPT-v1m1")
class PointPromptTraining(_PromptedBackbone):
    def __init__(self, backbone: Optional[Dict] = None, criteria=None,
                 backbone_out_channels: int = 96, context_channels: int = 256,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
                 template: str = "[x]", clip_model: str = "ViT-B/16",
                 class_name: Sequence[str] = DEFAULT_CLASS_NAMES,
                 valid_index: Sequence[Sequence[int]] = DEFAULT_VALID_INDEX,
                 backbone_mode: bool = False,
                 class_embedding_path: Optional[str] = None,
                 embed_channels: int = 512):
        super().__init__(backbone, criteria, context_channels, conditions, backbone_mode)
        for i, rows in enumerate(valid_index):
            self.register_buffer(f"valid_index_{i}", torch.as_tensor(rows, dtype=torch.long),
                                 persistent=False)
        if backbone_mode:
            return
        if class_embedding_path:
            table = np.load(class_embedding_path).astype(np.float32)
            table = torch.from_numpy(table / np.linalg.norm(table, axis=-1, keepdims=True))
        else:
            table = nn.init.trunc_normal_(torch.empty(len(class_name), embed_channels),
                                          std=0.02, a=-0.04, b=0.04)
        self.class_embedding = nn.Parameter(table)
        self.proj_head = nn.Linear(backbone_out_channels, table.shape[-1])
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, input_dict: Dict, generator=None,
                condition: Optional[str] = None):
        ci = self.condition_index(input_dict, condition)
        feat = self.features(input_dict, ci, generator)
        if self.backbone_mode:
            return feat
        feat = self.proj_head(feat)
        feat = feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + 1e-8)
        emb = self.class_embedding
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)
        emb = emb.index_select(0, getattr(self, f"valid_index_{ci}"))
        seg_logits = torch.exp(self.logit_scale) * torch.matmul(feat, emb.t())
        return self.result(seg_logits, input_dict)


@MODELS.register_module("PPT-v1m2")
class PointPromptTrainingV2(_PromptedBackbone):
    def __init__(self, backbone: Optional[Dict] = None, criteria=None,
                 backbone_out_channels: int = 96, context_channels: int = 256,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
                 num_classes: Sequence[int] = (25, 20, 13),
                 backbone_mode: bool = False):
        if len(conditions) != len(num_classes):
            raise ValueError("PPT-v1m2: one num_classes entry a condition")
        super().__init__(backbone, criteria, context_channels, conditions, backbone_mode)
        if not backbone_mode:
            self.seg_heads = nn.ModuleList(nn.Linear(backbone_out_channels, n)
                                           for n in num_classes)

    def forward(self, input_dict: Dict, generator=None,
                condition: Optional[str] = None):
        ci = self.condition_index(input_dict, condition)
        feat = self.features(input_dict, ci, generator)
        if self.backbone_mode:
            return feat
        return self.result(self.seg_heads[ci](feat), input_dict)
