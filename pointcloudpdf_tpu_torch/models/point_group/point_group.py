"""PointGroup-v1m1: semantic logits and per-point centroid shifts over a
backbone's features, grouped into instance proposals on the host.

Counterpart of ``pointcloudpdf_tpu/models/point_group/point_group.py``
(reference Pointcept ``point_group_v1m1_base.py``).  The device computes
``seg_logits`` and ``bias_pred`` (both zero on padded rows) and, when the
batch holds ``instance_centroid``, the loss: a cross-entropy written as the
JAX package writes it, ``log(clip(softmax, 1e-12, 1))`` (not
``log_softmax``: the clip differs at very negative logits), the L1 of the
shift against ``centroid - coord`` and the negative cosine between them,
both over the points of an instance.  ``propose`` (host numpy) clusters
the shifted points of each predicted class (``ops.cluster.bfs_cluster``)
into scored instance masks, for ``InsSegEvaluator``.

Submodules carry the reference's names (``backbone``, ``bias_head.0`` /
``.1`` / ``.3``, ``seg_head``); ``bridge.py`` maps them onto the JAX
module's ``backbone_module``, ``bias_fc1`` / ``bias_bn`` / ``bias_fc2`` and
``seg_head``.  The bias head's BatchNorm is masked, at momentum 0.01 and
epsilon 1e-3.  A backbone whose forward takes a ``generator`` (drop path)
gets the trainer's; a PPT backbone in ``backbone_mode`` reads the batch's
``condition_name``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...ops.cluster import bfs_cluster
from ..builder import MODELS, build_model
from ..default import takes_generator
from ..norm import MaskedBatchNorm
from ..utils.structure import where_valid


@MODELS.register_module("PG-v1m1")
class PointGroup(nn.Module):
    def __init__(self, backbone: Optional[Dict] = None, backbone_out_channels: int = 64,
                 semantic_num_classes: int = 20, semantic_ignore_index: int = -1,
                 segment_ignore_index: Sequence[int] = (-1, 0, 1),
                 instance_ignore_index: int = -1, cluster_thresh: float = 1.5,
                 cluster_closed_points: int = 300, cluster_propose_points: int = 100,
                 cluster_min_points: int = 50, voxel_size: float = 0.02):
        super().__init__()
        self.semantic_num_classes = semantic_num_classes
        self.semantic_ignore_index = semantic_ignore_index
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.cluster_thresh = cluster_thresh
        self.cluster_closed_points = cluster_closed_points
        self.cluster_propose_points = cluster_propose_points
        self.cluster_min_points = cluster_min_points
        self.voxel_size = voxel_size
        self.backbone = build_model(dict(backbone))
        c = backbone_out_channels
        self.bias_head = nn.Sequential(
            nn.Linear(c, c), MaskedBatchNorm(c, momentum=0.01, eps=1e-3), nn.ReLU(),
            nn.Linear(c, 3))
        self.seg_head = nn.Linear(c, semantic_num_classes)
        self._takes_generator = takes_generator(self.backbone)

    def forward(self, input_dict: Dict, generator=None) -> Dict:
        kwargs = {"generator": generator} if self._takes_generator else {}
        out = self.backbone(input_dict, **kwargs)
        feat = out[0] if isinstance(out, tuple) else out
        mask = input_dict["mask"].to(torch.bool)
        fc1, bn, _, fc2 = self.bias_head
        bias_pred = fc2(F.relu(bn(fc1(feat), mask)))
        result = dict(seg_logits=where_valid(mask, self.seg_head(feat)),
                      bias_pred=where_valid(mask, bias_pred))
        if "instance_centroid" in input_dict:
            result.update(self.loss(input_dict, result))
        return result

    def loss(self, input_dict: Dict, out: Dict) -> Dict:
        """Semantic CE + the shift's masked L1 + its negative cosine
        (reference :71-89), in f32."""
        coord = input_dict["coord"].float()
        segment = input_dict["segment"]
        instance = input_dict["instance"]
        centroid = input_dict["instance_centroid"].float()
        mask = input_dict["mask"].to(torch.bool)
        seg_logits, bias_pred = out["seg_logits"].float(), out["bias_pred"].float()

        valid = (segment != self.semantic_ignore_index) & mask
        shifted = torch.exp(seg_logits - seg_logits.amax(-1, keepdim=True))
        probs = shifted / shifted.sum(-1, keepdim=True)
        target = segment.clamp(0, self.semantic_num_classes - 1)
        logp = torch.log(probs.clamp(1e-12, 1.0)).gather(-1, target[..., None])[..., 0]
        w = valid.float()
        seg_loss = -(logp * w).sum() / w.sum().clamp(min=1.0)

        inst_mask = ((instance != self.instance_ignore_index) & mask).float()
        count = inst_mask.sum().clamp(min=1e-8)
        bias_gt = centroid - coord
        bias_l1_loss = ((bias_pred - bias_gt).abs().sum(-1) * inst_mask).sum() / count
        pn = bias_pred / (torch.linalg.vector_norm(bias_pred, dim=-1, keepdim=True) + 1e-8)
        gn = bias_gt / (torch.linalg.vector_norm(bias_gt, dim=-1, keepdim=True) + 1e-8)
        bias_cosine_loss = (-(pn * gn).sum(-1) * inst_mask).sum() / count
        return dict(loss=seg_loss + bias_l1_loss + bias_cosine_loss, seg_loss=seg_loss,
                    bias_l1_loss=bias_l1_loss, bias_cosine_loss=bias_cosine_loss)

    def propose(self, coord, seg_logits, bias_pred, mask):
        """Host-side proposals of one scene (numpy in, numpy out): the
        masks (P, n) bool, classes (P,) and scores (P,) of the clusters of
        more than ``cluster_propose_points`` points, in the clustering's
        order.  A cluster's class is its first point's, its score the mean
        probability of that class over its points."""
        probs = np.exp(seg_logits - seg_logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        segment_pred = probs.argmax(-1)
        keep = mask & ~np.isin(segment_pred, list(self.segment_ignore_index))
        idx = np.where(keep)[0]
        empty = (np.zeros((0, len(coord)), bool), np.zeros(0, np.int64),
                 np.zeros(0, np.float32))
        if idx.size == 0:
            return empty
        center = (coord[idx] + bias_pred[idx]) / self.voxel_size
        clusters = bfs_cluster(center, segment_pred[idx], self.cluster_thresh,
                               self.cluster_closed_points, self.cluster_min_points)
        masks, classes, scores = [], [], []
        for members in clusters:
            rows = idx[members]
            if len(rows) <= self.cluster_propose_points:
                continue
            m = np.zeros(len(coord), bool)
            m[rows] = True
            cls = segment_pred[rows[0]]
            masks.append(m)
            classes.append(cls)
            scores.append(float(probs[rows, cls].mean()))
        if not masks:
            return empty
        return (np.stack(masks), np.asarray(classes, np.int64),
                np.asarray(scores, np.float32))
