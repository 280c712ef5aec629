"""SpUNet (SpUNet-v1m1 / v1m2 / v1m3) and the MinkUNet presets: a sparse
voxel-conv U-Net as gather-GEMM-scatter over exact voxel rulebooks.

Counterpart of ``pointcloudpdf_tpu/models/sparse_unet/spconv_unet.py``
(reference Pointcept ``spconv_unet_v1m1_base.py``):

- a level's voxels are a padded list per sample at a fixed capacity; the
  stem's 5^3 and the blocks' 3^3 submanifold convs read the level's
  neighbour table (``ops.voxel.neighbor_table``, exact), compacted into a
  ``Rulebook`` once a level and shared by its convs;
- the 2x strided conv adds each child into its parent (``unique_parents``)
  with the weight of the child's position in the parent's 2^3 cube, and the
  inverse conv reads that map backwards, both through ``map_rulebooks``;
- the whole batch flattens to (B N, C) rows; a level's capacity shrinks by
  ``level_capacity_factor`` a stride, and children whose parent did not fit
  are counted (``ops.voxel.capacity_dropped_points``).

Submodules carry the reference's names (``conv_input.0/1``, ``down.{s}.0/1``,
``enc.{s}.block{i}``, ``up.{s}.0/1``, ``dec.{s}.block{i}``, ``final``; in a
block ``conv1``, ``bn1``, ..., ``proj.0/1``), which ``bridge.py`` maps onto
the JAX tree.  A conv's ``weight`` is (K, C_in, C_out), the JAX layout; the
1x1 projections and ``final`` are ``nn.Linear``.  Every BatchNorm runs at
momentum 0.01 and epsilon 1e-3 (``norm._bn_factory``); SpUNet-v1m3 swaps
them for ``PDMaskedBatchNorm`` banks selected by ``forward``'s
``condition`` (or the batch's ``condition_name``).

The JAX module's dense-extent path (``dense_extent``, ``conv_window``,
``conv_coverage_check``: TPU sorted-window convs) is not ported; the
constructor rejects those options.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...ops.voxel import (check_grid_bound, count_dropped, flatten_neighbor_rows,
                          flatten_slot_map, gather_conv, kernel_offsets,
                          map_rulebooks, neighbor_table, table_rulebook,
                          unique_parents)
from ..builder import MODELS
from ..norm import PDMaskedBatchNorm, _bn_factory
from ..utils.structure import masked_mean, where_valid

__all__ = ["SubMConv", "SparseDownConv", "SparseInverseConv", "BasicBlock",
           "BottleneckBlock", "SpUNet", "_bn_factory"]

OFFSETS5 = kernel_offsets(5)
OFFSETS3 = kernel_offsets(3)
# the 3^3 offsets' columns in the 5^3 table: level 0's 3^3 table is a
# slice of the stem's
_SUB3 = [int(np.flatnonzero((OFFSETS5 == o).all(1))[0]) for o in OFFSETS3]


def _conv_weight(*shape):
    return nn.Parameter(nn.init.trunc_normal_(torch.empty(shape), std=0.02,
                                              a=-0.04, b=0.04))


class SubMConv(nn.Module):
    """A sparse conv over a rulebook: ``weight`` (K, C_in, C_out)."""

    def __init__(self, in_channels: int, out_channels: int, num_offsets: int,
                 bias: bool = False):
        super().__init__()
        self.weight = _conv_weight(num_offsets, in_channels, out_channels)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, feat, rules):
        y = gather_conv(feat, rules, self.weight)
        return y if self.bias is None else y + self.bias


class SparseDownConv(SubMConv):
    """2x strided conv: a child adds feat @ W[pos] to its parent, ``pos``
    its place in the parent's 2^3 cube (the down rulebook of
    ``map_rulebooks``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 8)


class SparseInverseConv(SubMConv):
    """2x upsampling: a child reads its parent through W[pos] (the up
    rulebook of ``map_rulebooks``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 8)


def _proj(in_channels, out_channels, norm_fn):
    """The residual's 1x1 projection and its norm, where the widths differ."""
    if in_channels == out_channels:
        return None
    return nn.Sequential(nn.Linear(in_channels, out_channels, bias=False),
                         norm_fn(out_channels))


class BasicBlock(nn.Module):
    """Residual block of two 3^3 submanifold convs (reference BasicBlock)."""

    expansion = 1

    def __init__(self, in_channels: int, embed_channels: int, norm_fn):
        super().__init__()
        self.proj = _proj(in_channels, embed_channels, norm_fn)
        self.conv1 = SubMConv(in_channels, embed_channels, len(OFFSETS3))
        self.bn1 = norm_fn(embed_channels)
        self.conv2 = SubMConv(embed_channels, embed_channels, len(OFFSETS3))
        self.bn2 = norm_fn(embed_channels)

    def forward(self, feat, rules, mask):
        identity = feat if self.proj is None else self.proj[1](self.proj[0](feat), mask)
        y = F.relu(self.bn1(self.conv1(feat, rules), mask))
        y = self.bn2(self.conv2(y, rules), mask)
        return where_valid(mask, F.relu(y + identity))


class BottleneckBlock(nn.Module):
    """1-3-1 residual bottleneck, expansion 4 (MinkowskiNet's, for
    MinkUNet50 / 101)."""

    expansion = 4

    def __init__(self, in_channels: int, embed_channels: int, norm_fn):
        super().__init__()
        out_channels = embed_channels * self.expansion
        self.proj = _proj(in_channels, out_channels, norm_fn)
        self.conv1 = nn.Linear(in_channels, embed_channels, bias=False)
        self.bn1 = norm_fn(embed_channels)
        self.conv2 = SubMConv(embed_channels, embed_channels, len(OFFSETS3))
        self.bn2 = norm_fn(embed_channels)
        self.conv3 = nn.Linear(embed_channels, out_channels, bias=False)
        self.bn3 = norm_fn(out_channels)

    def forward(self, feat, rules, mask):
        identity = feat if self.proj is None else self.proj[1](self.proj[0](feat), mask)
        y = F.relu(self.bn1(self.conv1(feat), mask))
        y = F.relu(self.bn2(self.conv2(y, rules), mask))
        y = self.bn3(self.conv3(y), mask)
        return where_valid(mask, F.relu(y + identity))


def _blocks(block_cls, depth, in_channels, channels, norm_fn):
    blocks = OrderedDict()
    for i in range(depth):
        blocks[f"block{i}"] = block_cls(in_channels, channels, norm_fn)
        in_channels = channels * block_cls.expansion
    return nn.Sequential(blocks)


@MODELS.register_module("SpUNet-v1m1")
class SpUNet(nn.Module):
    """``forward(input_dict, condition=None)`` -> logits (B, N, classes);
    the last stage's features with ``num_classes`` 0; (B, classes), a
    masked mean over the deepest level, with ``cls_mode``.  The batch holds
    ``grid_coord`` (B, N, 3), ``feat`` and ``mask``."""

    def __init__(self, in_channels: int, num_classes: int, base_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 cls_mode: bool = False, block: str = "basic",
                 conditions: Sequence[str] = (), norm_decouple: bool = True,
                 norm_adaptive: bool = False, norm_affine: bool = True,
                 context_channels: int = 256, zero_init: bool = True,
                 level_capacity_factor: float = 1.0, min_level_capacity: int = 128,
                 dense_extent=None, conv_window=None, conv_coverage_check=None):
        super().__init__()
        passed = [name for name, v in (("dense_extent", dense_extent),
                                       ("conv_window", conv_window),
                                       ("conv_coverage_check", conv_coverage_check))
                  if v is not None]
        if passed:
            raise NotImplementedError(
                f"SpUNet: {', '.join(passed)} (the TPU's dense-extent "
                "sorted-window convs) are not ported; the port takes the "
                "exact rulebook path")
        if len(layers) % 2 or len(channels) != len(layers):
            raise ValueError("SpUNet: channels and layers hold an encoder "
                             "and a decoder entry a stage")
        self.num_stages = len(layers) // 2
        self.num_classes = num_classes
        self.cls_mode = cls_mode
        self.conditions = tuple(conditions)
        self.level_capacity_factor = level_capacity_factor
        self.min_level_capacity = min_level_capacity
        norm_fn = _bn_factory(self.conditions, None, norm_decouple, norm_adaptive,
                              norm_affine, context_channels, zero_init)
        block_cls = BottleneckBlock if block == "bottleneck" else BasicBlock
        exp = block_cls.expansion
        stages, nch = self.num_stages, len(channels)

        self.conv_input = nn.Sequential(
            SubMConv(in_channels, base_channels, len(OFFSETS5)), norm_fn(base_channels))
        self.down, self.enc = nn.ModuleList(), nn.ModuleList()
        self.up, self.dec = nn.ModuleList(), nn.ModuleList()
        skip = base_channels
        for s in range(stages):
            self.down.append(nn.Sequential(SparseDownConv(skip, channels[s]),
                                           norm_fn(channels[s])))
            self.enc.append(_blocks(block_cls, layers[s], channels[s], channels[s],
                                    norm_fn))
            if not cls_mode:
                # up[s] lifts the level below s + 1 into level s
                dec = channels[nch - 1 - s]
                self.up.append(nn.Sequential(
                    SparseInverseConv(channels[nch - 2 - s] * exp, dec), norm_fn(dec)))
                self.dec.append(_blocks(block_cls, layers[nch - 1 - s], dec + skip, dec,
                                        norm_fn))
            skip = channels[s] * exp
        final_in = (channels[stages - 1] if cls_mode else channels[-1]) * exp
        self.final = nn.Linear(final_in, num_classes) if num_classes > 0 else None

    def index_maps(self, grid: torch.Tensor, mask: torch.Tensor) -> Dict[str, List]:
        """The voxel maps of a forward: each level's ``grid`` and ``mask``
        (level 0 the input), its 3^3 neighbour table ``nbr3`` (B, n, 27),
        the stem's 5^3 table ``nbr5`` and each stride's child -> parent map
        ``c2p`` (B, n_child), at the JAX module's level capacities; children
        whose parent overflowed a capacity are counted as dropped."""
        nbr5 = neighbor_table(grid, mask, OFFSETS5)
        maps = dict(grid=[grid.to(torch.int32)], mask=[mask], nbr5=nbr5,
                    nbr3=[nbr5[..., _SUB3]], c2p=[])
        level_n = mask.shape[1]
        for _ in range(self.num_stages):
            n_child = level_n
            level_n = max(int(level_n * self.level_capacity_factor),
                          min(self.min_level_capacity, n_child))
            p_grid, p_mask, c2p = unique_parents(maps["grid"][-1], maps["mask"][-1],
                                                 2, capacity=level_n)
            count_dropped((maps["mask"][-1] & (c2p < 0)).sum())
            maps["grid"].append(p_grid)
            maps["mask"].append(p_mask)
            maps["c2p"].append(c2p)
            maps["nbr3"].append(neighbor_table(p_grid, p_mask, OFFSETS3))
        return maps

    def forward(self, input_dict: Dict, condition: Optional[str] = None) -> torch.Tensor:
        grid = input_dict["grid_coord"]
        mask = input_dict["mask"].to(torch.bool)
        b, n = mask.shape
        if self.conditions:
            condition = condition or input_dict.get("condition_name")
            context = input_dict.get("context")
            for norm in self.modules():
                if isinstance(norm, PDMaskedBatchNorm):
                    norm.condition, norm.context = condition, context
        check_grid_bound(grid, mask)
        maps = self.index_maps(grid, mask)
        masks = [m.reshape(-1) for m in maps["mask"]]
        rules = [table_rulebook(flatten_neighbor_rows(t)) for t in maps["nbr3"]]
        strides = []
        for s, c2p in enumerate(maps["c2p"]):
            g = maps["grid"][s]
            pos = ((g[..., 0] % 2) * 4 + (g[..., 1] % 2) * 2 + g[..., 2] % 2).reshape(-1)
            cap = maps["mask"][s + 1].shape[1]
            strides.append(map_rulebooks(flatten_slot_map(c2p, cap), pos, b * cap))

        conv, bn = self.conv_input
        y = conv(input_dict["feat"].reshape(b * n, -1),
                 table_rulebook(flatten_neighbor_rows(maps["nbr5"])))
        y = where_valid(masks[0], F.relu(bn(y, masks[0])))
        skips = [y]
        for s in range(self.num_stages):
            conv, bn = self.down[s]
            y = where_valid(masks[s + 1], F.relu(bn(conv(y, strides[s][0]), masks[s + 1])))
            for block in self.enc[s]:
                y = block(y, rules[s + 1], masks[s + 1])
            skips.append(y)
        level = self.num_stages
        if not self.cls_mode:
            y = skips.pop()
            for s in reversed(range(self.num_stages)):
                conv, bn = self.up[s]
                y = F.relu(bn(conv(y, strides[s][1]), masks[s]))
                y = torch.cat([y, skips.pop()], dim=-1)
                for block in self.dec[s]:
                    y = block(y, rules[s], masks[s])
            level = 0
        if self.final is not None:
            y = self.final(y)
        rows = maps["mask"][level].shape[1]
        if self.cls_mode:
            return masked_mean(y.reshape(b, rows, -1), maps["mask"][level], dim=1)
        return where_valid(masks[level], y).reshape(b, rows, -1)


@MODELS.register_module("SpUNet-v1m2")
def spunet_v1m2(**kwargs):
    """The reference's BatchNorm-momentum variant: the same module (the
    momentum lives in the norms, as in the JAX package)."""
    return SpUNet(**kwargs)


@MODELS.register_module("SpUNet-v1m3")
def spunet_v1m3(**kwargs):
    """PDNorm SpUNet (reference spconv_unet_v1m3_pdnorm.py): every
    BatchNorm a per-dataset ``PDMaskedBatchNorm``, optionally adaptive on
    the batch's ``context``."""
    kwargs.setdefault("conditions", ("ScanNet", "S3DIS", "Structured3D"))
    return SpUNet(**kwargs)


# The MinkUNet family (reference mink_unet.py:365-443) on the same stack
# with MinkowskiNet's depths and widths; 50 / 101 on the bottleneck block.
_MINK_BASE_PLANES = (32, 64, 128, 256, 256, 128, 96, 96)


def _register_mink(name, layers, planes=_MINK_BASE_PLANES, block="basic"):
    def factory(**kwargs):
        kw = dict(layers=layers, channels=planes, block=block)
        kw.update(kwargs)                 # config values win over the preset
        kw.setdefault("base_channels", kw["channels"][0])
        return SpUNet(**kw)

    factory.__name__ = name
    MODELS.register_module(name, module=factory)


_L14 = (1, 1, 1, 1, 1, 1, 1, 1)
_L18 = (2, 2, 2, 2, 2, 2, 2, 2)
_L34 = (2, 3, 4, 6, 2, 2, 2, 2)
_L101 = (2, 3, 4, 23, 2, 2, 2, 2)

_register_mink("MinkUNet14", _L14)
_register_mink("MinkUNet18", _L18)
_register_mink("MinkUNet34", _L34)
_register_mink("MinkUNet50", _L34, block="bottleneck")
_register_mink("MinkUNet101", _L101, block="bottleneck")
# 34C's planes equal the base planes in the reference
_register_mink("MinkUNet14A", _L14, (32, 64, 128, 256, 128, 128, 96, 96))
_register_mink("MinkUNet14B", _L14, (32, 64, 128, 256, 128, 128, 128, 128))
_register_mink("MinkUNet14C", _L14, (32, 64, 128, 256, 192, 192, 128, 128))
_register_mink("MinkUNet14D", _L14, (32, 64, 128, 256, 384, 384, 384, 384))
_register_mink("MinkUNet18A", _L18, (32, 64, 128, 256, 128, 128, 96, 96))
_register_mink("MinkUNet18B", _L18, (32, 64, 128, 256, 128, 128, 128, 128))
_register_mink("MinkUNet18D", _L18, (32, 64, 128, 256, 384, 384, 384, 384))
_register_mink("MinkUNet34A", _L34, (32, 64, 128, 256, 256, 128, 96, 96))
_register_mink("MinkUNet34B", _L34, (32, 64, 128, 256, 256, 128, 64, 32))
_register_mink("MinkUNet34C", _L34, _MINK_BASE_PLANES)
