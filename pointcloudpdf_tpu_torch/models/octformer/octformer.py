"""OctFormer-v1m1: dilated octree patch attention with an FPN decoder, over
padded voxel sets.

Counterpart of ``pointcloudpdf_tpu/models/octformer/octformer.py``
(reference Pointcept ``octformer_v1m1_base.py``).  An octree's non-empty
nodes at a depth are the unique voxels of the grid at that stride, so its
operations run on the stride-2 voxel levels (``unique_parents``):

- the octree convs are submanifold convs over each level's exact rulebook,
  the stride-2 conv adds each child into its parent and the deconv reads
  the map back (SpUNet's ``SparseDownConv`` / ``SparseInverseConv``); the
  CPE is a depthwise 3^3 conv (``ops.voxel.depthwise_conv``) and BatchNorm;
- a level's voxels sort along the z-order curve, valid first; a block of
  ``K D`` consecutive voxels becomes D patches of K taking every D-th one
  (even blocks D = 1, odd blocks the config's dilation), with masked
  multi-head attention and a learned per-axis relative-position bias
  (``OctreeRPE``: pos_bnd = int(0.8 K sqrt(D)), looked up in the table of
  every offset triple, one ``index_select`` a pair);
- the decoder is the FPN: each stage's 1x1 to ``fpn_channels``, a running
  sum upsampled to the next finer stage, a 3^3 conv a stage, then
  ``head_up`` deconvs back to the input's level and the seg head.

Levels past the input hold the largest valid count of the batch rounded up
to a block of ``K D`` (``compact_levels``), where the JAX module keeps every
level at the input's padded length: valid rows compute the same patches,
BatchNorm statistics and convolutions.

Submodules carry the reference's names (``patch_embed.convs.{i}`` /
``downsamples.{i}`` / ``proj``, ``layers.{s}.blocks.{i}`` with ``cpe``,
``norm1``, ``attention.qkv`` / ``proj`` / ``rpe.rpe_table``, ``norm2``,
``mlp.fc1`` / ``fc2``; ``downsamples.{s}``, ``decoder.conv1x1.{i}`` /
``conv3x3.{i}`` / ``up_conv.{i}``, ``seg_head.0/1/3``), which ``bridge.py``
maps onto the JAX tree.  What the JAX module computes is kept: LayerNorms
at Flax's epsilon 1e-6, BatchNorms at momentum 0.01 and epsilon 1e-3, the
tanh GELU, no bias on the strided convs.  ``nempty`` and the ``octree_*``
keys are accepted and read by neither package.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.serialization import _INVALID, morton_encode
from ...ops.voxel import (Rulebook, check_grid_bound, depthwise_conv, flatten_neighbor_rows,
                          flatten_slot_map, map_rulebooks, neighbor_table, table_rulebook,
                          unique_parents)
from ..builder import MODELS
from ..norm import _bn_factory
from ..point_transformer_v3.ptv3 import LN_EPS, MLP, RPE, DropPath, _linear, offset_index
from ..sparse_unet.spconv_unet import (OFFSETS3, SparseDownConv, SparseInverseConv, SubMConv,
                                       _conv_weight)
from ..utils.structure import where_valid


def octree_rpe_bound(patch_size: int, dilation: int) -> int:
    """The RPE's clip of a per-axis offset: int(0.8 K sqrt(D)), 20 at K = 26,
    D = 1 and 41 at D = 4."""
    return int(0.8 * patch_size * dilation ** 0.5)


class OctreeLevel:
    """A level: grid (B, n, 3), mask (B, n), its 3^3 rulebook, its z-order
    sort as flat rows into and out of the order, and the RPE index of each
    dilation, made on first use."""

    def __init__(self, grid: torch.Tensor, mask: torch.Tensor, patch_size: int):
        b, n = mask.shape
        self.grid, self.mask, self.patch_size = grid, mask, patch_size
        self.flat_mask = mask.reshape(-1)
        self.rules = table_rulebook(flatten_neighbor_rows(neighbor_table(grid, mask, OFFSETS3)))
        code = torch.where(mask, morton_encode(grid), torch.full_like(mask, _INVALID,
                                                                        dtype=torch.int64))
        self.order = torch.argsort(code, dim=-1, stable=True)
        rows = torch.arange(n, device=grid.device).expand_as(self.order)
        inverse = torch.empty_like(self.order).scatter_(1, self.order, rows)
        base = (torch.arange(b, device=grid.device) * n)[:, None]
        self.order_rows = (self.order + base).reshape(-1)
        self.inverse_rows = (inverse + base).reshape(-1)
        self._rpe: Dict[int, torch.Tensor] = {}

    def patches(self, x: torch.Tensor, dilation: int) -> torch.Tensor:
        """Sorted rows (B, n, ...) padded to a block of K D and cut into
        patches: a block of K D consecutive rows becomes D patches of K
        taking every D-th row -> (B, P, K, ...)."""
        b, n = x.shape[:2]
        k, block = self.patch_size, self.patch_size * dilation
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, -n % block))
        x = x.reshape((b, -1, k, dilation) + x.shape[2:]).transpose(2, 3)
        return x.reshape((b, -1, k) + x.shape[4:])

    def rpe_index(self, dilation: int) -> torch.Tensor:
        """(B, P, K, K) rows of the offset-triple table of ``OctreeRPE`` at
        ``dilation``: shared by the level's blocks of that dilation."""
        if dilation not in self._rpe:
            g = self.patches(self.grid.gather(1, self.order[..., None].expand(-1, -1, 3)),
                             dilation)
            valid = self.patches(self.mask.gather(1, self.order), dilation)
            self._rpe[dilation] = offset_index(g.to(torch.int32), valid,
                                               octree_rpe_bound(self.patch_size, dilation))
        return self._rpe[dilation]


class OctreeAttention(nn.Module):
    """Dilated z-order patch attention (reference OctreeAttention): qkv, a
    gather into the order, patches, masked softmax (logits in f32, also
    under autocast; masked keys at -1e9) with the RPE bias, the patches
    back, a gather back, ``proj``, zeros at padded rows."""

    def __init__(self, dim: int, patch_size: int, num_heads: int, dilation: int = 1,
                 qkv_bias: bool = True, use_rpe: bool = True):
        super().__init__()
        self.dim, self.num_heads, self.dilation = dim, num_heads, dilation
        self.qkv = _linear(dim, 3 * dim, qkv_bias)
        self.proj = _linear(dim, dim)
        self.rpe = (RPE(octree_rpe_bound(patch_size, dilation), num_heads)
                    if use_rpe else None)

    def forward(self, feat: torch.Tensor, level: OctreeLevel) -> torch.Tensor:
        b, n = level.mask.shape
        c, h, d = self.dim, self.num_heads, self.dilation
        k = level.patch_size
        qkv = self.qkv(feat).reshape(b * n, 3 * c).index_select(0, level.order_rows)
        qkv = level.patches(qkv.reshape(b, n, 3 * c), d)
        keys = level.patches(level.mask.gather(1, level.order), d)
        q, kk, v = qkv.reshape(b, -1, k, 3, h, c // h).permute(3, 0, 1, 4, 2, 5)
        with torch.autocast(feat.device.type, enabled=False):
            logits = (q.float() * (c // h) ** -0.5) @ kk.float().transpose(-1, -2)
            if self.rpe is not None:
                logits = logits + self.rpe(level.rpe_index(d))
        logits = logits.masked_fill(~keys[:, :, None, None, :], -1e9)
        out = torch.softmax(logits, dim=-1).to(v.dtype) @ v      # (B, P, H, K, hd)
        out = out.permute(0, 1, 3, 2, 4).reshape(b, -1, d, k, c).transpose(2, 3)
        out = out.reshape(b, -1, c)[:, :n].reshape(b * n, c)
        out = out.index_select(0, level.inverse_rows)
        return where_valid(level.mask, self.proj(out.reshape(b, n, c)))


class DepthwiseConv(nn.Module):
    """A depthwise submanifold conv's weight, (K, C)."""

    def __init__(self, num_offsets: int, channels: int):
        super().__init__()
        self.weight = _conv_weight(num_offsets, channels)

    def forward(self, feat: torch.Tensor, rules: Rulebook) -> torch.Tensor:
        return depthwise_conv(feat, rules, self.weight)


class OctreeDWConvBn(nn.Module):
    """The CPE: depthwise 3^3 conv and BatchNorm (reference OctreeDWConvBn)."""

    def __init__(self, channels: int, norm_fn):
        super().__init__()
        self.conv = DepthwiseConv(len(OFFSETS3), channels)
        self.bn = norm_fn(channels)

    def forward(self, feat, level: OctreeLevel):
        return where_valid(level.flat_mask, self.bn(self.conv(feat, level.rules),
                                                    level.flat_mask))


class OctFormerBlock(nn.Module):
    """CPE, attention and MLP, each a pre-norm residual (the attention's and
    the MLP's through drop path; reference OctFormerBlock)."""

    def __init__(self, dim: int, num_heads: int, patch_size: int, dilation: int,
                 mlp_ratio: float, drop_path: float, norm_fn, use_rpe: bool = True):
        super().__init__()
        self.cpe = OctreeDWConvBn(dim, norm_fn)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attention = OctreeAttention(dim, patch_size, num_heads, dilation,
                                         use_rpe=use_rpe)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLP(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, feat: torch.Tensor, level: OctreeLevel, generator=None) -> torch.Tensor:
        b, n, c = feat.shape
        feat = feat + self.cpe(feat.reshape(b * n, c), level).reshape(b, n, c)
        feat = feat + self.drop_path(self.attention(self.norm1(feat), level), generator)
        feat = feat + self.drop_path(self.mlp(self.norm2(feat)), generator)
        return where_valid(level.mask, feat)


class ConvBnRelu(nn.Module):
    """A conv over a rulebook, BatchNorm and ReLU (reference
    OctreeConvBnRelu / OctreeDeconvBnRelu; ``deconv`` names the conv of the
    latter)."""

    def __init__(self, conv: nn.Module, channels: int, norm_fn, relu: bool = True,
                 conv_name: str = "conv"):
        super().__init__()
        self.conv_name, self.relu = conv_name, relu
        self.add_module(conv_name, conv)
        self.bn = norm_fn(channels)

    def forward(self, feat, rules, mask):
        y = self.bn(getattr(self, self.conv_name)(feat, rules), mask)
        return where_valid(mask, F.relu(y) if self.relu else y)


class Downsample(nn.Module):
    """A stage's stride-2 conv and BatchNorm, no ReLU (reference Downsample)."""

    def __init__(self, in_channels: int, out_channels: int, norm_fn):
        super().__init__()
        self.conv = SparseDownConv(in_channels, out_channels)
        self.norm = norm_fn(out_channels)

    def forward(self, feat, rules, mask):
        return where_valid(mask, self.norm(self.conv(feat, rules), mask))


@MODELS.register_module("OctFormer-v1m1")
class OctFormer(nn.Module):
    """``forward(input_dict, generator=None)`` -> logits (B, N, classes)
    (the FPN's features with ``num_classes`` 0), padded rows 0.  The batch
    holds ``grid_coord`` (B, N, 3), ``feat`` and ``mask``; ``generator``
    feeds the drop-path draws in training."""

    compact_levels = True  # levels past the input at their valid length (tests: False)

    def __init__(self, in_channels: int, num_classes: int, fpn_channels: int = 168,
                 channels: Sequence[int] = (96, 192, 384, 384),
                 num_blocks: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (6, 12, 24, 24), patch_size: int = 26,
                 stem_down: int = 2, head_up: int = 2, dilation: int = 4,
                 drop_path: float = 0.5, mlp_ratio: float = 4.0, nempty: bool = True,
                 use_rpe: bool = True, octree_scale_factor: float = 10.24,
                 octree_depth: int = 11, octree_full_depth: int = 2):
        super().__init__()
        if head_up != stem_down:
            raise ValueError(f"OctFormer: head_up {head_up} must equal stem_down "
                             f"{stem_down}, to bring the features back to the input's level")
        norm_fn = _bn_factory()
        num_stages = len(num_blocks)
        self.stem_down = stem_down
        self.patch_size, self.dilation = patch_size, dilation
        stem_ch = [int(channels[0] * 2 ** i) for i in range(-stem_down, 1)]

        def conv3(c_in, c_out):
            return ConvBnRelu(SubMConv(c_in, c_out, len(OFFSETS3)), c_out, norm_fn)

        self.patch_embed = nn.Module()
        self.patch_embed.convs = nn.ModuleList(
            conv3(in_channels if i == 0 else stem_ch[i], stem_ch[i]) for i in range(stem_down))
        self.patch_embed.downsamples = nn.ModuleList(
            ConvBnRelu(SparseDownConv(stem_ch[i], stem_ch[i + 1]), stem_ch[i + 1], norm_fn)
            for i in range(stem_down))
        self.patch_embed.proj = conv3(stem_ch[-1], channels[0])
        total = sum(num_blocks)
        dpr = [drop_path * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        for s in range(num_stages):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                OctFormerBlock(channels[s], num_heads[s], patch_size,
                               1 if i % 2 == 0 else dilation, mlp_ratio,
                               dpr[sum(num_blocks[:s]) + i], norm_fn, use_rpe)
                for i in range(num_blocks[s]))
            self.layers.append(stage)
        self.downsamples = nn.ModuleList(
            Downsample(channels[s], channels[s + 1], norm_fn) for s in range(num_stages - 1))
        self.decoder = nn.Module()
        self.decoder.conv1x1 = nn.ModuleList(
            _linear(channels[s], fpn_channels) for s in reversed(range(num_stages)))
        self.decoder.conv3x3 = nn.ModuleList(
            conv3(fpn_channels, fpn_channels) for _ in range(num_stages))
        self.decoder.up_conv = nn.ModuleList(
            ConvBnRelu(SparseInverseConv(fpn_channels, fpn_channels), fpn_channels, norm_fn,
                       conv_name="deconv") for _ in range(head_up))
        self.seg_head = (nn.Sequential(OrderedDict([
            ("0", _linear(fpn_channels, fpn_channels)), ("1", norm_fn(fpn_channels)),
            ("2", nn.ReLU()), ("3", _linear(fpn_channels, num_classes))]))
            if num_classes > 0 else None)

    def index_maps(self, grid: torch.Tensor, mask: torch.Tensor) -> Dict[str, List]:
        """The voxel levels of a forward, the input first: each level's
        ``grid`` and ``mask`` and each stride's child -> parent map ``c2p``
        (``stem_down`` + stages - 1 strides), a level past the input at the
        batch's largest voxel count rounded up to a block of K D (or its
        child level's length)."""
        maps = dict(grid=[grid.to(torch.int32)], mask=[mask], c2p=[])
        block = self.patch_size * self.dilation
        for _ in range(self.stem_down + len(self.layers) - 1):
            n = maps["mask"][-1].shape[1]
            p_grid, p_mask, c2p = unique_parents(maps["grid"][-1], maps["mask"][-1], 2)
            if self.compact_levels:
                cap = min(n, -(-max(int(p_mask.sum(dim=1).max()), 1) // block) * block)
                p_grid, p_mask = p_grid[:, :cap].contiguous(), p_mask[:, :cap].contiguous()
            maps["grid"].append(p_grid)
            maps["mask"].append(p_mask)
            maps["c2p"].append(c2p)
        return maps

    def forward(self, input_dict: Dict, generator=None) -> torch.Tensor:
        grid = input_dict["grid_coord"]
        mask = input_dict["mask"].to(torch.bool)
        b, n = mask.shape
        check_grid_bound(grid, mask)
        maps = self.index_maps(grid, mask)
        grids, masks = maps["grid"], maps["mask"]
        num_stages, base = len(self.layers), self.stem_down
        levels = [OctreeLevel(g, m, self.patch_size) for g, m in zip(grids, masks)]
        flat_masks = [m.reshape(-1) for m in masks]
        # each stride's (down, up) rulebooks; a child's position in its
        # parent's 2^3 cube picks the weight
        strides = []
        for i, c2p in enumerate(maps["c2p"]):
            g = grids[i]
            pos = ((g[..., 0] % 2) * 4 + (g[..., 1] % 2) * 2 + g[..., 2] % 2).reshape(-1)
            cap = masks[i + 1].shape[1]
            strides.append(map_rulebooks(flatten_slot_map(c2p, cap), pos, b * cap))

        x = input_dict["feat"].float().reshape(b * n, -1)
        for i in range(base):
            x = self.patch_embed.convs[i](x, levels[i].rules, flat_masks[i])
            x = self.patch_embed.downsamples[i](x, strides[i][0], flat_masks[i + 1])
        x = self.patch_embed.proj(x, levels[base].rules, flat_masks[base])

        feats = {}
        for s, stage in enumerate(self.layers):
            level = levels[base + s]
            x = x.reshape(b, level.mask.shape[1], -1)
            for block in stage.blocks:
                x = block(x, level, generator)
            feats[base + s] = x.reshape(-1, x.shape[-1])
            if s < num_stages - 1:
                x = self.downsamples[s](feats[base + s], strides[base + s][0],
                                        flat_masks[base + s + 1])

        def upsample(y, level):
            """Nearest upsampling ``level`` -> ``level - 1``: a child reads
            its parent (absent children rows of their own, zeroed)."""
            c2p = maps["c2p"][level - 1]
            flat = flatten_slot_map(c2p, masks[level].shape[1])
            valid = flat >= 0
            spread = torch.arange(flat.numel(), device=flat.device) % y.shape[0]
            up = y.index_select(0, torch.where(valid, flat.long(), spread))
            return torch.where(valid[:, None], up, torch.zeros_like(up))

        deepest = base + num_stages - 1
        conv1x1, conv3x3 = self.decoder.conv1x1, self.decoder.conv3x3
        feature = conv1x1[0](feats[deepest])
        out = conv3x3[0](feature, levels[deepest].rules, flat_masks[deepest])
        level = deepest
        for i in range(1, num_stages):
            level = deepest - i
            feature = upsample(feature, level + 1) + conv1x1[i](feats[level])
            feature = where_valid(flat_masks[level], feature)
            out = upsample(out, level + 1) + conv3x3[i](feature, levels[level].rules,
                                                        flat_masks[level])
        for up_conv in self.decoder.up_conv:
            level -= 1
            out = up_conv(out, strides[level][1], flat_masks[level])
        if self.seg_head is not None:
            fc1, bn, _, fc2 = self.seg_head
            out = fc2(F.relu(bn(fc1(out), flat_masks[0])))
        return where_valid(flat_masks[0], out).reshape(b, n, -1)
