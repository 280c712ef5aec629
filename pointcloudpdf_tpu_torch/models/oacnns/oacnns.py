"""OA-CNNs (OACNNs / OACNNs-v1m1): omni-adaptive sparse CNNs over padded
voxel sets.

Counterpart of ``pointcloudpdf_tpu/models/oacnns/oacnns.py`` (reference
Pointcept ``oacnns_v1m1_base.py``):

- a stem of three 3^3 submanifold convs at the input's level, then a stage
  a stride: a 2x strided conv into the parents (``unique_parents``) and
  ``enc_depth`` adaptive blocks;
- an adaptive block clusters the level's voxels at each of the stage's
  ``point_grid_size`` grids (the parents of the level at that stride) and,
  a scale at a time, aggregates each cluster by a softmax of per-voxel,
  per-channel weights (masked segment means and sums); a per-voxel softmax
  over the scales mixes them, a fuse MLP adds the result to the input, and
  two 3^3 submanifold convs follow with a second residual;
- a decoder stage a stride: the inverse conv back to the finer level, the
  skip concatenated, a two-layer fuse MLP added to the upsampled features;
  one fuse a stage, as the JAX module has;
- ``final``, a Linear to the classes.

The adaptive softmax subtracts one maximum over the whole level (every row
and channel, padded rows too) and adds 1e-6 to its denominator, so its
result depends on which rows enter that maximum.  The JAX module holds
every level at the input's padded length N, where each padded row has zero
features and cluster 0, so all of them carry one vector.  Levels past the
input are held here at the batch's largest valid count (``compact_levels``),
with one padded row more wherever that leaves none and the JAX level would
hold one (fewer than B N valid rows): the maximum then runs over the same
values, and the level computes the JAX module's function on its valid rows.

Submodules carry the reference's names (``stem.{0,3,6}`` convs and
``stem.{1,4,7}`` BatchNorms, ``enc.{s}.down.0/1``, ``enc.{s}.blocks.{b}``
with ``l_w.{i}.0/1``, ``weight.{i}``, ``proj.{i}.0/1`` (``proj.{S}``, S the
stage's scale count, the block's last projection), ``adaptive``,
``fuse.0/1``, ``voxel_block.{0,1,3,4}``; ``dec.{s}.up.0/1``,
``dec.{s}.fuse.{0,1,3,4}``; ``final``), which ``bridge.py`` maps onto the
JAX tree.  Every BatchNorm runs at momentum 0.01 and epsilon 1e-3.  The
keys ``enc_num_ref``, ``groups``, ``down_ratio`` and ``dec_depth`` are
accepted and read by neither package.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.voxel import (check_grid_bound, flatten_neighbor_rows, flatten_slot_map,
                          map_rulebooks, neighbor_table, table_rulebook, unique_parents)
from ..builder import MODELS
from ..norm import _bn_factory
from ..sparse_unet.spconv_unet import OFFSETS3, SparseDownConv, SparseInverseConv, SubMConv
from ..utils.structure import where_valid


def segment_mean(x: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """Per-segment means of the valid rows of ``x`` (M, C) over ``capacity``
    segments (``seg`` (M,) their ids), summed in f32 at least; an empty
    segment 0."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w = valid.to(acc)
    s = x.new_zeros((capacity, x.shape[-1]), dtype=acc).index_add_(0, seg, x.to(acc) * w[:, None])
    c = w.new_zeros(capacity).index_add_(0, seg, w)
    return (s / c[:, None].clamp(min=1e-6)).to(x.dtype)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """Per-segment sums of the valid rows of ``x`` (M, C), in f32 at least,
    returned in ``x``'s dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    out = x.new_zeros((capacity, x.shape[-1]), dtype=acc)
    return out.index_add_(0, seg, x.to(acc) * valid.to(acc)[:, None]).to(x.dtype)


def _mlp(channels_in: int, channels: int, norm_fn) -> nn.Sequential:
    """Linear (no bias), BatchNorm, ReLU: the reference's ``Sequential``."""
    return nn.Sequential(nn.Linear(channels_in, channels, bias=False), norm_fn(channels),
                         nn.ReLU())


def _run_mlp(mlp: nn.Sequential, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    fc, bn, _ = mlp
    return F.relu(bn(fc(x), mask))


class Level:
    """A voxel level of the flattened batch (grid (B, n, 3), mask (B, n)):
    its flat mask, 3^3 rulebook and, past the input, its clusters at each
    grid size as (segment ids (B n,), valid (B n,))."""

    def __init__(self, grid: torch.Tensor, mask: torch.Tensor):
        self.flat_mask = mask.reshape(-1)
        self.rules = table_rulebook(flatten_neighbor_rows(neighbor_table(grid, mask, OFFSETS3)))
        self.clusters: List = []


class AdaptiveBlock(nn.Module):
    """The reference's ``BasicBlock``: multi-scale adaptive aggregation and
    two 3^3 submanifold convs, each with a residual."""

    def __init__(self, channels: int, num_scales: int, norm_fn):
        super().__init__()
        self.l_w = nn.ModuleList(_mlp(channels, channels, norm_fn) for _ in range(num_scales))
        self.weight = nn.ModuleList(nn.Linear(channels, channels, bias=False)
                                    for _ in range(num_scales))
        self.proj = nn.ModuleList(_mlp(channels, channels, norm_fn)
                                  for _ in range(num_scales + 1))
        self.adaptive = nn.Linear(channels, num_scales, bias=False)
        self.fuse = _mlp(2 * channels, channels, norm_fn)
        self.voxel_block = nn.Sequential(OrderedDict([
            ("0", SubMConv(channels, channels, len(OFFSETS3))), ("1", norm_fn(channels)),
            ("2", nn.ReLU()),
            ("3", SubMConv(channels, channels, len(OFFSETS3))), ("4", norm_fn(channels))]))

    def forward(self, feat: torch.Tensor, level: Level) -> torch.Tensor:
        mask, n = level.flat_mask, feat.shape[0]
        scale_feats = []
        for i, (seg, valid) in enumerate(level.clusters):
            # each row reads its cluster's reductions by index_select: its
            # backward is a scatter-add, where advanced indexing's sorts
            pw = _run_mlp(self.l_w[i], feat, mask)
            pw = pw - segment_mean(pw, seg, valid, n).index_select(0, seg)
            pw = self.weight[i](pw)
            pw = torch.exp(pw - pw.max().detach())
            pw = pw / (segment_sum(pw, seg, valid, n).index_select(0, seg) + 1e-6)
            pfeat = _run_mlp(self.proj[i], feat, mask) * pw
            pfeat = segment_sum(pfeat, seg, valid, n).index_select(0, seg)
            scale_feats.append(where_valid(valid, pfeat))
        adp = torch.softmax(self.adaptive(feat), dim=-1)
        agg = torch.einsum("ns,nsc->nc", adp, torch.stack(scale_feats, dim=1))
        base = _run_mlp(self.proj[-1], feat, mask)
        feat = _run_mlp(self.fuse, torch.cat([base, agg], dim=-1), mask) + feat
        conv1, bn1, _, conv2, bn2 = self.voxel_block
        y = F.relu(bn1(conv1(feat, level.rules), mask))
        y = bn2(conv2(y, level.rules), mask)
        return where_valid(mask, F.relu(y + feat))


@MODELS.register_module("OACNNs")
@MODELS.register_module("OACNNs-v1m1")
class OACNNs(nn.Module):
    """``forward(input_dict)`` -> logits (B, N, classes), padded rows 0.
    The batch holds ``grid_coord`` (B, N, 3), ``feat`` and ``mask``."""

    compact_levels = True  # levels past the input at their valid length (tests: False)

    def __init__(self, in_channels: int, num_classes: int, embed_channels: int = 64,
                 enc_num_ref: Sequence[int] = (16, 16, 16, 16),
                 enc_channels: Sequence[int] = (64, 64, 128, 256),
                 groups: Sequence[int] = (2, 4, 8, 16),
                 enc_depth: Sequence[int] = (2, 3, 6, 4),
                 down_ratio: Sequence[int] = (2, 2, 2, 2),
                 dec_channels: Sequence[int] = (96, 96, 128, 256),
                 point_grid_size: Sequence[Sequence[int]] = (
                     (16, 32, 64), (8, 16, 24), (4, 8, 12), (2, 4, 6)),
                 dec_depth: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        norm_fn = _bn_factory()
        self.num_stages = len(enc_channels)
        self.point_grid_size = [tuple(g) for g in point_grid_size]
        stem = OrderedDict()
        for i in range(3):
            stem[str(3 * i)] = SubMConv(in_channels if i == 0 else embed_channels,
                                        embed_channels, len(OFFSETS3))
            stem[str(3 * i + 1)] = norm_fn(embed_channels)
            stem[str(3 * i + 2)] = nn.ReLU()
        self.stem = nn.Sequential(stem)
        self.enc, self.dec = nn.ModuleList(), nn.ModuleList()
        for s in range(self.num_stages):
            stage = nn.Module()
            c_in = embed_channels if s == 0 else enc_channels[s - 1]
            stage.down = nn.Sequential(SparseDownConv(c_in, enc_channels[s]),
                                       norm_fn(enc_channels[s]), nn.ReLU())
            stage.blocks = nn.ModuleList(
                AdaptiveBlock(enc_channels[s], len(self.point_grid_size[s]), norm_fn)
                for _ in range(enc_depth[s]))
            self.enc.append(stage)
            # dec[s] lifts the level of stage s into the level below it
            stage = nn.Module()
            c_up = enc_channels[-1] if s == self.num_stages - 1 else dec_channels[s + 1]
            c = dec_channels[s]
            stage.up = nn.Sequential(SparseInverseConv(c_up, c), norm_fn(c), nn.ReLU())
            stage.fuse = nn.Sequential(OrderedDict([
                ("0", nn.Linear(c + c_in, c)), ("1", norm_fn(c)), ("2", nn.ReLU()),
                ("3", nn.Linear(c, c)), ("4", norm_fn(c)), ("5", nn.ReLU())]))
            self.dec.append(stage)
        self.final = nn.Linear(dec_channels[0], num_classes)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                nn.init.trunc_normal_(module.weight, std=0.02, a=-0.04, b=0.04)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)

    def index_maps(self, grid: torch.Tensor, mask: torch.Tensor) -> Dict[str, List]:
        """The voxel levels of a forward, the input first: each level's
        ``grid`` and ``mask``, each stride's child -> parent map ``c2p`` and,
        past the input, each grid size's cluster map ``clusters`` (B, n)
        (the cluster's slot, -1 on padded rows).  A level past the input
        holds the batch's largest voxel count, one row more where that
        leaves no padded row and the JAX level (N rows a sample) has one."""
        b, n = mask.shape
        maps = dict(grid=[grid.to(torch.int32)], mask=[mask], c2p=[], clusters=[])
        for s in range(self.num_stages):
            p_grid, p_mask, c2p = unique_parents(maps["grid"][-1], maps["mask"][-1], 2)
            if self.compact_levels:
                counts = p_mask.sum(dim=1)
                cap = int(counts.max())
                if int(counts.sum()) < b * n and int(counts.min()) == cap:
                    cap += 1
                p_grid, p_mask = p_grid[:, :cap].contiguous(), p_mask[:, :cap].contiguous()
            maps["grid"].append(p_grid)
            maps["mask"].append(p_mask)
            maps["c2p"].append(c2p)
            maps["clusters"].append([unique_parents(p_grid, p_mask, size)[2]
                                     for size in self.point_grid_size[s]])
        return maps

    def forward(self, input_dict: Dict) -> torch.Tensor:
        grid = input_dict["grid_coord"]
        mask = input_dict["mask"].to(torch.bool)
        b, n = mask.shape
        check_grid_bound(grid, mask)
        maps = self.index_maps(grid, mask)
        levels = [Level(g, m) for g, m in zip(maps["grid"], maps["mask"])]
        strides = []
        for s, c2p in enumerate(maps["c2p"]):
            g = maps["grid"][s]
            pos = ((g[..., 0] % 2) * 4 + (g[..., 1] % 2) * 2 + g[..., 2] % 2).reshape(-1)
            cap = maps["mask"][s + 1].shape[1]
            strides.append(map_rulebooks(flatten_slot_map(c2p, cap), pos, b * cap))
            levels[s + 1].clusters = [
                (flatten_slot_map(cc).clamp(min=0).long(), cc.reshape(-1) >= 0)
                for cc in maps["clusters"][s]]

        y = input_dict["feat"].reshape(b * n, -1)
        level = levels[0]
        for i in range(3):
            conv, bn = self.stem[3 * i], self.stem[3 * i + 1]
            y = F.relu(bn(conv(y, level.rules), level.flat_mask))
        y = where_valid(level.flat_mask, y)
        skips = [y]
        for s, stage in enumerate(self.enc):
            level = levels[s + 1]
            conv, bn, _ = stage.down
            y = where_valid(level.flat_mask,
                            F.relu(bn(conv(y, strides[s][0]), level.flat_mask)))
            for block in stage.blocks:
                y = block(y, level)
            skips.append(y)
        y = skips.pop()
        for s in reversed(range(self.num_stages)):
            skip, mask_s = skips.pop(), levels[s].flat_mask
            conv, bn, _ = self.dec[s].up
            y = F.relu(bn(conv(y, strides[s][1]), mask_s))
            fc1, bn1, _, fc2, bn2, _ = self.dec[s].fuse
            h = F.relu(bn1(fc1(torch.cat([y, skip], dim=-1)), mask_s))
            y = F.relu(bn2(fc2(h), mask_s)) + y
        return where_valid(levels[0].flat_mask, self.final(y)).reshape(b, n, -1)
