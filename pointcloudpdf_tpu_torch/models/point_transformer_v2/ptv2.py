"""Point Transformer V2 (PT-v2m2 / PT-v2m1 / PT-v2m3) over padded batches.

Counterpart of ``pointcloudpdf_tpu/models/point_transformer_v2/ptv2.py``:
grouped vector attention blocks over one kNN table per resolution level,
voxel-grid pooling (``ops.voxel.unique_parents`` at a per-level capacity)
and map unpooling with skip projections.  ``forward`` returns the logits.

Submodules carry the reference's (Pointcept
``point_transformer_v2m2_base.py``) names and nesting (``patch_embed``,
``enc_stages.{s}.down`` / ``.blocks.blocks.{i}``, ``dec_stages.{s}.up`` /
``.blocks.blocks.{i}``, ``seg_head``; a BatchNorm under a
``PointBatchNorm`` as ``.norm``), so ``bridge.py`` maps the JAX tree onto
them.  One difference from the reference is the JAX package's and is kept:
its attention applies a second Linear to q and to k ahead of their
BatchNorms (``q_fc1``, ``k_fc1``), which the reference does not have.

The attention core is ``ops.gva`` (kernel K7), inference-only as in the JAX
package: a module in eval mode calls the wrapper, which on the card
launches the kernel (or raises when a gradient is asked of it), and one
that trains takes ``gva_plain`` with batch statistics.

PT-v2m3 (``conditions`` given) swaps every BatchNorm, the attention's
included, for a ``PDMaskedBatchNorm`` from ``norm._bn_factory`` (momentum
0.01, epsilon 1e-3): one bank a dataset condition, named by ``forward``'s
``condition`` or the batch's ``condition_name``, and the adaptive
modulation from the batch's ``context``.  The PD norm takes the place of
the ``PointBatchNorm`` (``norm1.bns.{i}`` where PT-v2m2 has
``norm1.norm``).  As the JAX package turns its fused GVA off under a
PDNorm, PT-v2m3 takes ``gva_plain`` in eval too: it is the one ported
model that does not reach K7 (folding the active bank into K7 is later
work).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.geometry import divide_exact, gather_rows, knn
from ...ops.gva import grouped_vector_attention, gva_plain
from ...ops.voxel import (capacity_dropped_points, count_dropped, flatten_slot_map,
                          scatter_mean_to_parent, unique_parents)
from ..builder import MODELS
from ..norm import MaskedBatchNorm, PDMaskedBatchNorm, _bn_factory
from ..utils.structure import where_valid

class PointBatchNorm(nn.Module):
    """The reference's BatchNorm wrapper: the norm sits under ``.norm``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.norm = MaskedBatchNorm(num_features)

    def forward(self, x, mask=None):
        return self.norm(x, mask)


def _lin_bn_relu(c_in, c_out, bias=True, norm_fn=PointBatchNorm):
    return nn.Sequential(nn.Linear(c_in, c_out, bias=bias), norm_fn(c_out),
                         nn.ReLU(inplace=True))


def _mlp(c_in, c_out, norm_fn=PointBatchNorm):
    """Linear -> BatchNorm -> ReLU -> Linear (``[0]``, ``[1]``, ``[3]``)."""
    return nn.Sequential(nn.Linear(c_in, c_out), norm_fn(c_out),
                         nn.ReLU(inplace=True), nn.Linear(c_out, c_out))


def _apply(seq, x, mask):
    """Linear -> masked BatchNorm -> ReLU of a ``_lin_bn_relu``."""
    return F.relu(seq[1](seq[0](x), mask))


class GroupedVectorAttention(nn.Module):
    def __init__(self, embed_channels: int, groups: int, qkv_bias: bool = True,
                 pe_multiplier: bool = False, pe_bias: bool = True,
                 norm_fn=PointBatchNorm):
        super().__init__()
        c = embed_channels
        self.groups = groups
        self.linear_q = _lin_bn_relu(c, c, qkv_bias, norm_fn)
        self.linear_k = _lin_bn_relu(c, c, qkv_bias, norm_fn)
        # the JAX package's second Linear ahead of the q / k BatchNorms
        self.q_fc1 = nn.Linear(c, c)
        self.k_fc1 = nn.Linear(c, c)
        self.linear_v = nn.Linear(c, c, bias=qkv_bias)
        self.linear_p_multiplier = _mlp(3, c, norm_fn) if pe_multiplier else None
        self.linear_p_bias = _mlp(3, c, norm_fn) if pe_bias else None
        self.weight_encoding = _mlp(c, groups, norm_fn)
        # K7 folds plain BatchNorms' running statistics, no PD bank
        self.kernel_folds_norms = isinstance(self.weight_encoding[1], PointBatchNorm)

    def forward(self, feat, coord, ref_idx, ref_mask, mask):
        lq, lk = self.linear_q, self.linear_k
        q = F.relu(lq[1](self.q_fc1(lq[0](feat)), mask))
        k = F.relu(lk[1](self.k_fc1(lk[0](feat)), mask))
        v = self.linear_v(feat)
        # the kernel is inference-only: a training module takes the plain
        # version, an eval module the wrapper (under a PDNorm, the plain
        # version in eval too)
        core = (grouped_vector_attention
                if self.kernel_folds_norms and not self.training else gva_plain)
        out = core(q, k, v, coord, ref_idx, ref_mask & mask[..., None],
                   self.linear_p_multiplier, self.linear_p_bias,
                   self.weight_encoding, self.groups)
        return where_valid(mask, out.to(feat.dtype))


class Block(nn.Module):
    """Residual GVA block.  Drop path keeps or drops a whole sample; its
    draws come from the generator handed to ``forward`` (torch's global one
    when None)."""

    def __init__(self, embed_channels: int, groups: int, qkv_bias: bool = True,
                 pe_multiplier: bool = False, pe_bias: bool = True,
                 drop_path: float = 0.0, norm_fn=PointBatchNorm):
        super().__init__()
        c = embed_channels
        self.drop_path = drop_path
        self.attn = GroupedVectorAttention(c, groups, qkv_bias, pe_multiplier,
                                           pe_bias, norm_fn)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc3 = nn.Linear(c, c, bias=False)
        self.norm1 = norm_fn(c)
        self.norm2 = norm_fn(c)
        self.norm3 = norm_fn(c)

    def forward(self, feat, coord, ref_idx, ref_mask, mask, generator=None):
        y = F.relu(self.norm1(self.fc1(feat), mask))
        y = self.attn(y, coord, ref_idx, ref_mask, mask)
        y = F.relu(self.norm2(y, mask))
        y = self.norm3(self.fc3(y), mask)
        if self.drop_path > 0 and self.training:
            keep = 1.0 - self.drop_path
            draw = torch.rand((y.shape[0], 1, 1), generator=generator,
                              device=y.device if generator is None
                              else generator.device)
            y = y * (draw.to(y.device) < keep).to(y.dtype) / keep
        return where_valid(mask, F.relu(feat + y))


class BlockSequence(nn.Module):
    """``depth`` blocks over the first ``neighbours`` columns of the level's
    kNN table (distance-ascending, so a prefix is the narrower kNN)."""

    def __init__(self, depth: int, embed_channels: int, groups: int,
                 neighbours: int = 16, qkv_bias: bool = True,
                 pe_multiplier: bool = False, pe_bias: bool = True,
                 drop_path: float = 0.0, norm_fn=PointBatchNorm):
        super().__init__()
        self.neighbours = neighbours
        self.blocks = nn.ModuleList([
            Block(embed_channels, groups, qkv_bias, pe_multiplier, pe_bias,
                  drop_path, norm_fn) for _ in range(depth)])

    def forward(self, feat, coord, mask, nbr, generator=None):
        idx, ref_mask = nbr
        if idx.shape[-1] < self.neighbours:
            raise ValueError(f"kNN table of k={idx.shape[-1]} < neighbours="
                             f"{self.neighbours}")
        idx = idx[..., :self.neighbours]
        ref_mask = ref_mask[..., :self.neighbours]
        for block in self.blocks:
            feat = block(feat, coord, idx, ref_mask, mask, generator)
        return feat


class GridPool(nn.Module):
    """Voxel-partition pooling: fc + BN + ReLU, then the max of each voxel's
    features and the mean of its coordinates (summed in row order,
    ``scatter_mean_to_parent``), into a fixed number of parent slots,
    ``capacity`` (default: the child count).  Returns the child ->
    parent map too; children whose voxel overflows the capacity map to -1
    and are counted (``capacity_dropped_points``)."""

    def __init__(self, in_channels: int, out_channels: int, grid_size: float,
                 norm_fn=PointBatchNorm):
        super().__init__()
        self.grid_size = grid_size
        self.fc = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = norm_fn(out_channels)

    def forward(self, feat, coord, mask, capacity: Optional[int] = None):
        B, n = mask.shape
        cap = n if capacity is None else min(capacity, n)
        y = F.relu(self.norm(self.fc(feat), mask))
        start = torch.where(mask[..., None], coord,
                            torch.full_like(coord, float("inf"))).amin(1, keepdim=True)
        # an empty sample's -inf clamps to 0; its points leave by the mask
        grid = torch.clamp(torch.floor(divide_exact(coord - start, self.grid_size)),
                           min=0).to(torch.int64)
        _, p_mask, c2p = unique_parents(grid, mask, 1, cap)
        valid = c2p >= 0
        count_dropped((mask & ~valid).sum())
        slot = torch.clamp(c2p, min=0).long()
        c = y.shape[-1]
        yf = y.float()
        pooled = yf.new_full((B, cap, c), float("-inf")).scatter_reduce(
            1, slot[..., None].expand(-1, -1, c),
            torch.where(valid[..., None], yf, torch.full_like(yf, float("-inf"))),
            "amax")
        pooled = torch.where(torch.isfinite(pooled), pooled,
                             torch.zeros_like(pooled)).to(y.dtype)
        # the same coordinates in every forward: the next level's kNN reads them
        p_coord = scatter_mean_to_parent(coord.reshape(B * n, 3),
                                         flatten_slot_map(c2p, cap), B * cap)
        return pooled, p_coord.reshape(B, cap, 3), p_mask, c2p


class UnpoolWithSkip(nn.Module):
    """Map unpooling: the projected coarse features read back through the
    child -> parent map, plus the projected skip features."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 norm_fn=PointBatchNorm):
        super().__init__()
        self.proj = _lin_bn_relu(in_channels, out_channels, norm_fn=norm_fn)
        self.proj_skip = _lin_bn_relu(skip_channels, out_channels, norm_fn=norm_fn)

    def forward(self, feat, mask, skip_feat, skip_mask, c2p):
        y = _apply(self.proj, feat, mask)
        up = gather_rows(y, torch.clamp(c2p, min=0)[..., None])[:, :, 0]
        up = torch.where((c2p >= 0)[..., None], up, torch.zeros_like(up))
        out = up + _apply(self.proj_skip, skip_feat, skip_mask)
        return where_valid(skip_mask, out)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, embed_channels: int, groups: int,
                 depth: int, neighbours: int, qkv_bias: bool,
                 pe_multiplier: bool, pe_bias: bool, norm_fn=PointBatchNorm):
        super().__init__()
        self.proj = _lin_bn_relu(in_channels, embed_channels, False, norm_fn)
        self.blocks = BlockSequence(depth, embed_channels, groups, neighbours,
                                    qkv_bias, pe_multiplier, pe_bias,
                                    norm_fn=norm_fn)


class Encoder(nn.Module):
    def __init__(self, down: GridPool, blocks: BlockSequence):
        super().__init__()
        self.down = down
        self.blocks = blocks


class Decoder(nn.Module):
    def __init__(self, up: UnpoolWithSkip, blocks: BlockSequence):
        super().__init__()
        self.up = up
        self.blocks = blocks


def _knn_table(coord, mask, k):
    idx, dist2 = knn(coord, coord, k, ref_mask=mask)
    return idx, torch.isfinite(dist2)


@MODELS.register_module("PT-v2m2")
class PointTransformerV2(nn.Module):
    """``forward(input_dict, generator=None, condition=None)`` -> logits
    (B, N, classes), or the decoder's features with ``num_classes`` 0;
    ``generator`` feeds the drop-path draws in training; ``condition`` picks
    the PDNorm banks (PT-v2m3)."""

    def __init__(self, in_channels: int, num_classes: int,
                 patch_embed_depth: int = 1, patch_embed_channels: int = 48,
                 patch_embed_groups: int = 6, patch_embed_neighbours: int = 8,
                 enc_depths: Sequence[int] = (2, 2, 6, 2),
                 enc_channels: Sequence[int] = (96, 192, 384, 512),
                 enc_groups: Sequence[int] = (12, 24, 48, 64),
                 enc_neighbours: Sequence[int] = (16, 16, 16, 16),
                 dec_depths: Sequence[int] = (1, 1, 1, 1),
                 dec_channels: Sequence[int] = (48, 96, 192, 384),
                 dec_groups: Sequence[int] = (6, 12, 24, 48),
                 dec_neighbours: Sequence[int] = (16, 16, 16, 16),
                 grid_sizes: Sequence[float] = (0.06, 0.12, 0.24, 0.48),
                 attn_qkv_bias: bool = True, pe_multiplier: bool = False,
                 pe_bias: bool = True, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, enable_checkpoint: bool = False,
                 unpool_backend: str = "map",
                 level_capacity_factor: float = 1.0,
                 min_level_capacity: int = 128,
                 conditions: Sequence[str] = (), norm_decouple: bool = True,
                 norm_adaptive: bool = False, norm_affine: bool = True,
                 context_channels: int = 256, zero_init: bool = True):
        super().__init__()
        if unpool_backend != "map":
            raise NotImplementedError(f"unpool_backend={unpool_backend!r}: "
                                      "only the map unpooling is ported")
        # attn_drop_rate and enable_checkpoint are config fields the JAX
        # module holds and never reads
        self.num_classes = num_classes
        self.patch_embed_neighbours = patch_embed_neighbours
        self.enc_neighbours = tuple(enc_neighbours)
        self.dec_neighbours = tuple(dec_neighbours)
        self.level_capacity_factor = level_capacity_factor
        self.min_level_capacity = min_level_capacity
        self.conditions = tuple(conditions)
        norm_fn = (_bn_factory(self.conditions, None, norm_decouple,
                               norm_adaptive, norm_affine, context_channels,
                               zero_init)
                   if self.conditions else PointBatchNorm)
        stages = len(enc_depths)
        total = sum(enc_depths) + sum(dec_depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        attn = dict(qkv_bias=attn_qkv_bias, pe_multiplier=pe_multiplier,
                    pe_bias=pe_bias, norm_fn=norm_fn)
        self.patch_embed = PatchEmbed(
            in_channels, patch_embed_channels, patch_embed_groups,
            patch_embed_depth, patch_embed_neighbours, attn_qkv_bias,
            pe_multiplier, pe_bias, norm_fn)
        self.enc_stages = nn.ModuleList()
        self.dec_stages = nn.ModuleList()
        enc_in = [patch_embed_channels, *enc_channels[:-1]]
        dec_in = [*dec_channels[1:], enc_channels[-1]]
        skip_ch = [patch_embed_channels, *enc_channels[:-1]]
        for s in range(stages):
            self.enc_stages.append(Encoder(
                GridPool(enc_in[s], enc_channels[s], grid_sizes[s], norm_fn),
                BlockSequence(enc_depths[s], enc_channels[s], enc_groups[s],
                              enc_neighbours[s],
                              drop_path=dpr[sum(enc_depths[:s])], **attn)))
            self.dec_stages.append(Decoder(
                UnpoolWithSkip(dec_in[s], skip_ch[s], dec_channels[s], norm_fn),
                BlockSequence(dec_depths[s], dec_channels[s], dec_groups[s],
                              dec_neighbours[s],
                              drop_path=dpr[sum(enc_depths) + sum(dec_depths[:s])],
                              **attn)))
        if num_classes > 0:
            self.seg_head = nn.Sequential(
                nn.Linear(dec_channels[0], dec_channels[0]),
                norm_fn(dec_channels[0]), nn.ReLU(inplace=True),
                nn.Linear(dec_channels[0], num_classes))

    def forward(self, input_dict: Dict, generator=None,
                condition: Optional[str] = None) -> torch.Tensor:
        coord = input_dict["coord"].float()
        feat = input_dict["feat"].float()
        mask = input_dict["mask"].to(torch.bool)
        stages = len(self.enc_stages)
        if self.conditions:
            condition = condition or input_dict.get("condition_name")
            context = input_dict.get("context")
            for norm in self.modules():
                if isinstance(norm, PDMaskedBatchNorm):
                    norm.condition, norm.context = condition, context

        y = _apply(self.patch_embed.proj, feat, mask)
        # one kNN table a level, at the widest k any consumer there needs
        nbr = _knn_table(coord, mask, max(self.patch_embed_neighbours,
                                          self.dec_neighbours[0]))
        y = self.patch_embed.blocks(y, coord, mask, nbr, generator)

        skips, nbrs, pools = [(y, coord, mask)], [nbr], []
        for s, stage in enumerate(self.enc_stages):
            # the parent slots of a level: a share of the padded length
            n = skips[-1][2].shape[1]
            cap = (None if self.level_capacity_factor >= 1.0 else
                   max(int(n * self.level_capacity_factor), self.min_level_capacity))
            y, p_coord, p_mask, c2p = stage.down(*skips[-1], capacity=cap)
            k = self.enc_neighbours[s]
            if s + 1 < stages:
                k = max(k, self.dec_neighbours[s + 1])
            nbr = _knn_table(p_coord, p_mask, k)
            y = stage.blocks(y, p_coord, p_mask, nbr, generator)
            pools.append(c2p)
            skips.append((y, p_coord, p_mask))
            nbrs.append(nbr)

        y, _, cur_mask = skips.pop()
        nbrs.pop()  # the deepest level's table has no decoder consumer
        for s in reversed(range(stages)):
            skip_feat, skip_coord, skip_mask = skips.pop()
            stage = self.dec_stages[s]
            y = stage.up(y, cur_mask, skip_feat, skip_mask, pools[s])
            y = stage.blocks(y, skip_coord, skip_mask, nbrs.pop(), generator)
            cur_mask = skip_mask

        if self.num_classes > 0:
            lin1, bn, _, lin2 = self.seg_head
            y = lin2(F.relu(bn(lin1(y), cur_mask)))
        return where_valid(cur_mask, y)


@MODELS.register_module("PT-v2m1")
def point_transformer_v2m1(**kwargs):
    """PT-v2m1: the same module with ``pe_multiplier`` on by default."""
    kwargs.setdefault("pe_multiplier", True)
    return PointTransformerV2(**kwargs)


@MODELS.register_module("PT-v2m3")
def point_transformer_v2m3(**kwargs):
    """PT-v2m3 (reference point_transformer_v2m3_pdnorm.py): every
    BatchNorm a per-dataset ``PDMaskedBatchNorm`` driven by the condition
    (and optionally the PPT context)."""
    kwargs.setdefault("conditions", ("ScanNet", "S3DIS", "Structured3D"))
    return PointTransformerV2(**kwargs)
