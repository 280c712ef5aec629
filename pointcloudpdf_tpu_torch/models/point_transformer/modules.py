"""Point Transformer v1 building blocks over padded batches.

Counterpart of ``pointcloudpdf_tpu/models/point_transformer/modules.py``.
Submodules carry the reference's (Pointcept) names and nesting, so a
reference state_dict loads as it is and ``bridge.py`` maps the JAX tree
onto them: the reference's ``LayerNorm1d`` (a BatchNorm over points) is
``MaskedBatchNorm`` here, and ``nn.Sequential`` keeps the reference's
indices (``linear_p.0``, ``linear_w.5``, ...) while the forward calls
each member with the mask it needs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.geometry import grouping, interpolation, knn
from ...ops.sampling import blocked_farthest_point_sampling
from ...ops.vector_attention import (attention_train_affines,
                                      layer_attention, layer_weights,
                                      vector_attention_train)
from ..norm import MaskedBatchNorm
from ..utils.structure import (Points, masked_max, masked_mean,
                               masked_softmax, where_valid)


class PointTransformerLayer(nn.Module):
    """Vector self-attention over kNN neighbourhoods (reference
    point_transformer_seg.py:19-78; mid_planes == out_planes).

    Eval runs the fused inference op (kernel K3 on the card) with the
    BatchNorms folded from their running statistics, its parameters packed
    once a layer.  Training on the
    card folds them from the batch's masked statistics (a plain PyTorch
    pass) and runs the fused op with its backward (kernels K3 and K4);
    on the CPU it runs the unfused modules, which the tests hold the
    fused route against."""

    def __init__(self, in_planes: int, out_planes: int, share_planes: int = 8,
                 nsample: int = 16):
        super().__init__()
        self.mid_planes = mid = out_planes
        self.out_planes = out_planes
        self.share_planes = share_planes
        self.nsample = nsample
        groups = out_planes // share_planes
        self.linear_q = nn.Linear(in_planes, mid)
        self.linear_k = nn.Linear(in_planes, mid)
        self.linear_v = nn.Linear(in_planes, out_planes)
        self.linear_p = nn.Sequential(
            nn.Linear(3, 3), MaskedBatchNorm(3), nn.ReLU(inplace=True),
            nn.Linear(3, out_planes))
        self.linear_w = nn.Sequential(
            MaskedBatchNorm(mid), nn.ReLU(inplace=True),
            nn.Linear(mid, groups), MaskedBatchNorm(groups),
            nn.ReLU(inplace=True), nn.Linear(groups, groups))

    def forward(self, pts: Points, nbr=None) -> torch.Tensor:
        coord, x, mask = pts
        x_q, x_k, x_v = self.linear_q(x), self.linear_k(x), self.linear_v(x)
        if nbr is None:
            idx, dist2 = knn(coord, coord, self.nsample, ref_mask=mask)
            nmask = torch.isfinite(dist2) & mask[..., None]
        else:
            # the stage computes the table once for all its blocks
            idx, nmask = nbr
        if self.training and x.device.type == "cpu":
            out = self._unfused(coord, x_q, x_k, x_v, idx, nmask)
        elif self.training:
            out = self._fused_train(coord, x_q, x_k, x_v, idx, nmask)
        else:
            out = layer_attention(x_q, x_k, x_v, coord, idx, nmask,
                                  self.linear_p, self.linear_w,
                                  share_planes=self.share_planes)
        return where_valid(mask, out)

    def _fused_train(self, coord, x_q, x_k, x_v, idx, nmask):
        """Batch-statistic affines, then the fused op with its backward."""
        weights = layer_weights(self.linear_p, self.linear_w)
        affines = attention_train_affines(
            x_q, x_k, coord, idx, nmask, *weights[:6],
            self.linear_p[1], self.linear_w[0], self.linear_w[3])
        return vector_attention_train(
            x_q, x_k, x_v, coord, idx, nmask, *weights, *affines,
            share_planes=self.share_planes)

    def _unfused(self, coord, x_q, x_k, x_v, idx, nmask):
        k_g = grouping(x_k, idx, coord, coord, with_coord=True)
        v_g = grouping(x_v, idx)
        p_r, k_g = k_g[..., :3], k_g[..., 3:]
        p1, bn_p, relu, p2 = self.linear_p
        p_r = p2(relu(bn_p(p1(p_r), nmask)))
        r = k_g - x_q[:, :, None, :] + p_r
        bn_w1, relu1, w1, bn_w2, relu2, w2 = self.linear_w
        w = w2(relu2(bn_w2(w1(relu1(bn_w1(r, nmask))), nmask)))
        w = masked_softmax(w, nmask[..., None], dim=2)
        B, N, K, C = v_g.shape
        groups = C // self.share_planes
        v_pe = (v_g + p_r).reshape(B, N, K, self.share_planes, groups)
        out = torch.einsum("bnksg,bnkg->bnsg", v_pe, w)
        return out.reshape(B, N, C)


class TransitionDown(nn.Module):
    """Strided downsampling: blocked FPS + kNN grouping + max-pool
    (reference point_transformer_seg.py:81-119); stride 1 is a pointwise
    Linear-BN-ReLU."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 nsample: int = 16, fps_group_steps: int = 64):
        super().__init__()
        self.stride = stride
        self.nsample = nsample
        self.fps_group_steps = fps_group_steps
        c_in = in_planes if stride == 1 else 3 + in_planes
        self.linear = nn.Linear(c_in, out_planes, bias=False)
        self.bn = MaskedBatchNorm(out_planes)

    def forward(self, pts: Points) -> Points:
        coord, x, mask = pts
        if self.stride == 1:
            y = torch.relu(self.bn(self.linear(x), mask))
            return Points(coord, where_valid(mask, y), mask)
        m = coord.shape[1] // self.stride
        idx, new_mask = blocked_farthest_point_sampling(
            coord, m, mask, max_group_steps=self.fps_group_steps)
        new_coord = coord.gather(1, idx[..., None].expand(-1, -1, 3))
        nidx, ndist2 = knn(new_coord, coord, self.nsample, ref_mask=mask)
        nmask = torch.isfinite(ndist2) & new_mask[..., None]
        grouped = grouping(x, nidx, coord, new_coord, with_coord=True)
        y = torch.relu(self.bn(self.linear(grouped), nmask))
        y = masked_max(y, nmask, dim=-2)
        return Points(new_coord, where_valid(new_mask, y), new_mask)


class TransitionUp(nn.Module):
    """Decoder upsampling (reference point_transformer_seg.py:122-168).

    Head mode (``out_planes=None``): concat the per-sample global context.
    Fusion mode: skip projection + 3-NN inverse-distance interpolation of
    the coarser level."""

    def __init__(self, in_planes: int, out_planes: Optional[int] = None):
        super().__init__()
        if out_planes is None:
            self.linear1 = nn.Sequential(
                nn.Linear(2 * in_planes, in_planes),
                MaskedBatchNorm(in_planes), nn.ReLU(inplace=True))
            self.linear2 = nn.Sequential(
                nn.Linear(in_planes, in_planes), nn.ReLU(inplace=True))
        else:
            self.linear1 = nn.Sequential(
                nn.Linear(out_planes, out_planes),
                MaskedBatchNorm(out_planes), nn.ReLU(inplace=True))
            self.linear2 = nn.Sequential(
                nn.Linear(in_planes, out_planes),
                MaskedBatchNorm(out_planes), nn.ReLU(inplace=True))
        self.head = out_planes is None

    def forward(self, pts: Points, coarse: Optional[Points] = None
                ) -> torch.Tensor:
        coord, x, mask = pts
        lin1, bn1, relu1 = self.linear1
        if self.head:
            lin2, relu2 = self.linear2
            ctx = relu2(lin2(masked_mean(x, mask, dim=1)))        # (B, C)
            y = torch.cat([x, ctx[:, None, :].expand_as(x)], dim=-1)
            y = relu1(bn1(lin1(y), mask))
            return where_valid(mask, y)
        c_coord, c_x, c_mask = coarse
        lin2, bn2, relu2 = self.linear2
        skip = relu1(bn1(lin1(x), mask))
        up = relu2(bn2(lin2(c_x), c_mask))
        up = interpolation(c_coord, coord, up, k=3, src_mask=c_mask,
                           dst_mask=mask)
        return where_valid(mask, skip + up)


class Bottleneck(nn.Module):
    """Residual PT block (reference point_transformer_seg.py:171-192)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, share_planes: int = 8,
                 nsample: int = 16):
        super().__init__()
        self.linear1 = nn.Linear(in_planes, planes, bias=False)
        self.bn1 = MaskedBatchNorm(planes)
        self.transformer = PointTransformerLayer(planes, planes, share_planes,
                                                 nsample)
        self.bn2 = MaskedBatchNorm(planes)
        self.linear3 = nn.Linear(planes, planes * self.expansion, bias=False)
        self.bn3 = MaskedBatchNorm(planes * self.expansion)

    def forward(self, pts: Points, nbr=None) -> Points:
        coord, x, mask = pts
        identity = x
        y = torch.relu(self.bn1(self.linear1(x), mask))
        y = self.transformer(Points(coord, y, mask), nbr)
        y = torch.relu(self.bn2(y, mask))
        y = self.bn3(self.linear3(y), mask)
        y = torch.relu(y + identity)
        return Points(coord, where_valid(mask, y), mask)
