"""Swin3D-v1m1: shifted-window voxel attention with contextual relative
signal encoding (cRSE), over padded voxel sets.

Counterpart of ``pointcloudpdf_tpu/models/swin3d/swin3d.py`` (reference
Pointcept ``swin3d_v1m1_base.py`` over ``swin3d_layers.py``):

- a block sorts its level's voxels by (window id, z-order code in the
  window), valid first (``window_sort``; shifted blocks move the window
  origin by half a window), cuts the sorted rows into patches of
  ``patch_cap`` and attends within a patch between voxels of one window;
- cRSE: learned per-axis tables for query, key and value, each of
  ``(3, 2L, H, hd)``, indexed by the quantised signal delta of a pair (xyz
  in the level's voxel units, colour, normal).  The q and k terms contract
  the table with q or k first, then gather at the pair's bin; the value
  term sums each row's attention into the bins and takes one product with
  the table (``CRSEAttention``: the JAX module's gather of the value table
  at every pair, a (K, M, H, hd) tensor a patch, is the same sum);
- ``GridKNNDownsample`` pools stride-2 parents (their xyz and signal the
  mean of their children, summed in row order) and max-pools a pre-norm
  linear over each parent's 16 nearest children (K1); ``Upsample`` adds a
  linear of the skip to the 3-NN interpolation of a linear of the coarse
  level (K1), and with ``upsample="linear_attn"`` one window block.

Levels past the input hold the largest valid count of the batch rounded up
to a patch (``compact_levels``), where the JAX module keeps every level at
the input's padded length: valid rows compute the same patches, BatchNorm
statistics and kNN sets.  Each level's window sorts, pair bins and masks are
made once and shared by its blocks.

Submodules carry the reference's names (``stem_layer``, ``downsample``,
``layers.{l}.blocks.{d}`` with ``norm1``, ``attn.qkv`` / ``attn.proj`` /
``attn.{query,key,value}_{xyz,rgb,norm}_table``, ``norm2``, ``mlp.fc1`` /
``fc2``; ``layers.{l}.downsample.norm`` / ``.linear``;
``upsamples.{u}.linear1`` / ``linear2`` / ``block.blocks.0``;
``classifier.0/1/3``), which ``bridge.py`` maps onto the JAX tree.  What the
JAX module computes is kept where it differs from the reference: LayerNorms
at Flax's epsilon 1e-6, BatchNorms at momentum 0.01 and epsilon 1e-3, the
tanh GELU, windows over ``patch_cap`` voxels cut into separate patches.
``down_stride``, ``knn_down``, ``fp16_mode`` and ``base_grid_size`` are
accepted and read by neither package.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.geometry import divide_exact, knn
from ...ops.serialization import morton_encode
from ...ops.voxel import (KEY32_BITS, check_grid_bound, flatten_neighbor_rows,
                          flatten_slot_map, neighbor_table, pack_grid32, scatter_mean_to_parent,
                          table_rulebook, unique_parents)
from ..builder import MODELS
from ..norm import _bn_factory
from ..point_transformer_v3.ptv3 import LN_EPS, MLP, DropPath, _linear
from ..sparse_unet.spconv_unet import OFFSETS3, BasicBlock, SubMConv
from ..utils.structure import where_valid

_INVALID_WINDOW = 0xFFFFFFFF
MORTON_SHIFT = 30  # the z-order code's bits under the window id in a sort key


def crse_groups(cRSE: str, window_size: int, quant_size: int):
    """(name, signal column, quantisation, table half-length L) of each
    signal group (reference WindowAttention.__init__)."""
    groups = []
    if "XYZ" in cRSE:
        groups.append(("xyz", 0, quant_size, window_size * quant_size))
    if "RGB" in cRSE:
        groups.append(("rgb", 3, quant_size * 2, 2 * (quant_size * 2)))
    if "NORM" in cRSE:
        groups.append(("norm", 6, quant_size * 2, 2 * (quant_size * 2)))
    return groups


def window_sort(grid: torch.Tensor, mask: torch.Tensor, window_size: int, shift: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample sort by (window id, z-order code), masked rows last.
    grid (B, N, 3), mask (B, N) -> (order, inverse, window id of each
    sorted slot), each (B, N) int64.  One stable sort of ``win << 30 |
    code``: the JAX module's stable sort by code, then by window id."""
    g = grid.long()
    wgrid = torch.div(g + window_size // 2 if shift else g, window_size,
                      rounding_mode="floor")
    win = torch.where(mask, pack_grid32(wgrid.clamp(min=0)),
                      torch.full_like(g[..., 0], _INVALID_WINDOW))
    order = torch.argsort((win << MORTON_SHIFT) | morton_encode(g), dim=-1, stable=True)
    rows = torch.arange(mask.shape[1], device=grid.device).expand_as(order)
    inverse = torch.empty_like(order).scatter_(1, order, rows)
    return order, inverse, win.gather(1, order)


class Windows:
    """One level's window partition for a (window size, shift): the sorted
    rows cut into ``P`` patches of ``K``, over the first ``rows`` sorted
    positions (the batch's largest valid count rounded up to a patch: past
    it every sample's rows are padding); ``order_rows`` / ``inverse_rows``
    flat row indices into and out of that order; ``pair_valid`` (B, P, 1, K,
    K) the pairs of one window between valid rows; ``bins`` (B, P, K, K, G)
    int16, pair (i, j)'s bin in the table of each of the G (group, axis)
    parts, whose rows in the block's stacked tables are ``offsets`` (start,
    2L)."""

    def __init__(self, level: "SwinLevel", window_size: int, shift: bool,
                 groups, patch_cap: int):
        grid, mask, signal = level.grid, level.mask, level.signal
        b, n = mask.shape
        k = patch_cap
        order, inverse, win_sorted = window_sort(grid, mask, window_size, shift)
        rows = min(-(-max(level.max_valid, 1) // k) * k, -(-n // k) * k)
        pad = rows - min(rows, n)
        base = (torch.arange(b, device=grid.device) * n)[:, None]
        self.rows, self.patches, self.cap = rows, rows // k, k
        self.order_rows = (order[:, :rows] + base).reshape(-1)
        # rows past the sorted positions kept read a zero row (index b n)
        inv = torch.where(inverse < rows, inverse + (torch.arange(b, device=grid.device)
                                                     * rows)[:, None],
                          torch.full_like(inverse, b * rows))
        self.inverse_rows = inv.reshape(-1)
        keep = order[:, :rows]
        valid = F.pad(mask.gather(1, keep), (0, pad)).reshape(b, -1, k)
        win_p = F.pad(win_sorted[:, :rows], (0, pad), value=_INVALID_WINDOW).reshape(b, -1, k)
        self.pair_valid = ((win_p[..., :, None] == win_p[..., None, :])
                           & valid[..., :, None] & valid[..., None, :])[:, :, None]
        sig = F.pad(signal.gather(1, keep[..., None].expand(-1, -1, signal.shape[-1])),
                    (0, 0, 0, pad)).reshape(b, -1, k, signal.shape[-1])
        bins, self.offsets, offset = [], [], 0
        for _, s0, quant, half in groups:
            part = sig[..., s0:s0 + 3]
            delta = part[:, :, :, None, :] - part[:, :, None, :, :]          # (B, P, K, K, 3)
            idx = torch.clamp(torch.floor(delta * quant).to(torch.int32) + half, 0,
                              2 * half - 1)
            for a in range(3):
                bins.append(idx[..., a].to(torch.int16))
                self.offsets.append((offset, 2 * half))
                offset += 2 * half
        self.bins = torch.stack(bins, dim=-1)


class SwinLevel:
    """A level: grid (B, n, 3), mask (B, n), ``xyz`` (B, n, 3) the kNN
    coordinates (level-0 voxel units), ``signal`` (B, n, S) the cRSE signal
    (xyz in this level's voxel units); its window partitions, made on first
    use."""

    def __init__(self, grid, mask, xyz, signal):
        self.grid, self.mask, self.xyz, self.signal = grid, mask, xyz, signal
        self.flat_mask = mask.reshape(-1)
        self.max_valid = int(mask.sum(dim=1).max()) if mask.numel() else 0
        self._windows: Dict = {}

    def windows(self, window_size: int, shift: bool, groups, patch_cap: int) -> Windows:
        key = (window_size, shift, tuple(groups), patch_cap)
        if key not in self._windows:
            self._windows[key] = Windows(self, window_size, shift, groups, patch_cap)
        return self._windows[key]


def _binned(x: torch.Tensor, bins: torch.Tensor, part: int, width: int,
            transpose: bool = False) -> torch.Tensor:
    """x (B, P, H, K, M) summed into the bins of ``part``: (B, P, H, K, width),
    entry [..., i, l] = sum_j x[..., i, j] over pairs (i, j) in bin l
    (``transpose``: over the pairs (j, i), for the key side)."""
    idx = bins[..., part].long()[:, :, None]
    if transpose:
        idx, x = idx.transpose(-1, -2), x.transpose(-1, -2)
    out = x.new_zeros(x.shape[:-1] + (width,))
    return out.scatter_add_(-1, idx.expand_as(x), x)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in f32 at least (float64 stays)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _table_grad(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum over (b, p, k) of a[..., l] x[..., d] -> (l, h, d), for a (B, P,
    H, K, L) and x (B, P, H, K, D): a GEMM a patch and head, then the sum
    (as one GEMM a head over every row, L x D outputs from millions of
    products, it ran on a few thread blocks: 2.9 of a 4.5 s step)."""
    return (a.transpose(-1, -2) @ x).sum(dim=(0, 1)).permute(1, 0, 2)


class CRSEAttention(torch.autograd.Function):
    """Masked softmax attention of a patch with the cRSE terms, in f32.

    q, k, v (B, P, H, K, hd) in any float dtype (computed in f32 at least,
    qs = q ``scale``); tq, tk, tv (NB, H, hd) the block's tables stacked over
    (group, axis), the part ``g`` at rows ``offsets[g]``; bins and
    pair_valid from ``Windows``.

        logits_ij = qs_i . k_j + sum_g (qs_i . tq[b_g(i,j)] + k_j . tk[b_g(i,j)])
        out_i = sum_j a_ij v_j + sum_g sum_l A_g[i, l] tv[l],
        A_g[i, l] = sum_{j : b_g(i,j) = l} a_ij

    Pairs outside ``pair_valid`` take -1e9.  The q and k terms contract q or
    k with a part's table, (B, P, H, K, 2L), and gather at the pairs' bins;
    the value term sums the attention into the bins (one scatter-add a part,
    its index shared by the heads).  The backward is written out: it keeps
    q, k, v as they came (bfloat16 under autocast), the attention (f32) and
    the int16 bins, and recomputes each part's binned sums, so no per-pair
    tensor of a table's width is kept."""

    @staticmethod
    def forward(ctx, q, k, v, scale, tq, tk, tv, bins, pair_valid, offsets):
        qs, kf, vf = _wide(q) * scale, _wide(k), _wide(v)
        logits = qs @ kf.transpose(-1, -2)
        for g, (o, w) in enumerate(offsets):
            idx = bins[..., g].long()[:, :, None].expand_as(logits)
            dq = torch.einsum("bphkd,lhd->bphkl", qs, tq[o:o + w])
            dk = torch.einsum("bphkd,lhd->bphkl", kf, tk[o:o + w])
            logits = logits + dq.gather(-1, idx)
            logits = logits + dk.gather(-1, idx.transpose(-1, -2)).transpose(-1, -2)
        logits = logits.masked_fill(~pair_valid, -1e9)
        # a fully masked row (a padded query) is uniform over its masked
        # keys; its output is zeroed by the caller
        attn = torch.softmax(logits, dim=-1)
        out = attn @ vf
        for g, (o, w) in enumerate(offsets):
            out = out + torch.einsum("bphkl,lhd->bphkd", _binned(attn, bins, g, w),
                                     tv[o:o + w])
        ctx.save_for_backward(q, k, v, tq, tk, tv, bins, pair_valid, attn)
        ctx.offsets, ctx.scale = offsets, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, tq, tk, tv, bins, pair_valid, attn = ctx.saved_tensors
        qs, kf, vf = _wide(q) * ctx.scale, _wide(k), _wide(v)
        dv = attn.transpose(-1, -2) @ dout
        dattn = dout @ vf.transpose(-1, -2)
        dtv = torch.zeros_like(tv)
        for g, (o, w) in enumerate(ctx.offsets):
            idx = bins[..., g].long()[:, :, None].expand_as(dattn)
            gv = torch.einsum("bphkd,lhd->bphkl", dout, tv[o:o + w])
            dattn = dattn + gv.gather(-1, idx)
            dtv[o:o + w] = _table_grad(_binned(attn, bins, g, w), dout)
        ds = attn * (dattn - (dattn * attn).sum(dim=-1, keepdim=True))
        ds = ds.masked_fill(~pair_valid, 0.0)
        dqs = ds @ kf
        dk = ds.transpose(-1, -2) @ qs
        dtq, dtk = torch.zeros_like(tq), torch.zeros_like(tk)
        for g, (o, w) in enumerate(ctx.offsets):
            bq = _binned(ds, bins, g, w)
            bk = _binned(ds, bins, g, w, transpose=True)
            dqs = dqs + torch.einsum("bphkl,lhd->bphkd", bq, tq[o:o + w])
            dk = dk + torch.einsum("bphkl,lhd->bphkd", bk, tk[o:o + w])
            dtq[o:o + w] = _table_grad(bq, qs)
            dtk[o:o + w] = _table_grad(bk, kf)
        return ((dqs * ctx.scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                dtq, dtk, dtv, None, None, None)


class WindowAttention(nn.Module):
    """Same-window masked multi-head attention with cRSE (reference
    WindowAttention): qkv, a gather into the window order, ``CRSEAttention``
    (f32, also under autocast), a gather back, ``proj``, zeros at padded
    rows."""

    def __init__(self, dim: int, window_size: int, quant_size: int, num_heads: int,
                 cRSE: str = "XYZ_RGB", qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.groups = crse_groups(cRSE, window_size, quant_size)
        self.qkv = _linear(dim, 3 * dim, qkv_bias)
        self.proj = _linear(dim, dim)
        hd = dim // num_heads
        for name, _, _, half in self.groups:
            for side in ("query", "key", "value"):
                self.register_parameter(f"{side}_{name}_table", nn.Parameter(
                    nn.init.trunc_normal_(torch.empty(3, 2 * half, num_heads, hd),
                                          std=0.02, a=-0.04, b=0.04)))

    def tables(self, side: str) -> torch.Tensor:
        """The ``side`` tables stacked in the bins' (group, axis) order:
        (sum 2L, H, hd)."""
        return torch.cat([getattr(self, f"{side}_{name}_table").float()[a]
                          for name, _, _, _ in self.groups for a in range(3)])

    def forward(self, feat: torch.Tensor, level: SwinLevel, win: Windows) -> torch.Tensor:
        b, n = level.mask.shape
        c, h = self.dim, self.num_heads
        hd = c // h
        qkv = self.qkv(feat).reshape(b * n, 3 * c).index_select(0, win.order_rows)
        qkv = F.pad(qkv.reshape(b, -1, 3 * c), (0, 0, 0, win.rows - qkv.shape[0] // b))
        q, k, v = qkv.reshape(b, win.patches, win.cap, 3, h, hd).permute(3, 0, 1, 4, 2, 5)
        with torch.autocast(feat.device.type, enabled=False):
            out = CRSEAttention.apply(q, k, v, hd ** -0.5,
                                      self.tables("query"), self.tables("key"),
                                      self.tables("value"), win.bins, win.pair_valid,
                                      win.offsets)
        out = out.permute(0, 1, 3, 2, 4).reshape(b * win.rows, c).to(feat.dtype)
        out = torch.cat([out, out.new_zeros((1, c))]).index_select(0, win.inverse_rows)
        return where_valid(level.mask, self.proj(out.reshape(b, n, c)))


class SwinBlock(nn.Module):
    """LayerNorm, window cRSE attention, LayerNorm, MLP, each a residual
    through drop path; shifted windows on odd blocks (reference
    SwinTransformerBlock)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, quant_size: int,
                 patch_cap: int, shift: bool, drop_path: float, cRSE: str,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift, self.patch_cap = window_size, shift, patch_cap
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, quant_size, num_heads, cRSE)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLP(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, feat: torch.Tensor, level: SwinLevel, generator=None) -> torch.Tensor:
        win = level.windows(self.window_size, self.shift, self.attn.groups, self.patch_cap)
        feat = feat + self.drop_path(self.attn(self.norm1(feat), level, win), generator)
        feat = feat + self.drop_path(self.mlp(self.norm2(feat)), generator)
        return where_valid(level.mask, feat)


def _spread_rows(valid: torch.Tensor, rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Flat gather rows: ``rows`` where ``valid``, elsewhere a row of the
    slot's own (its number modulo ``n_rows``), so that a masked slot's
    gradient (0) is not added into one row by every such slot."""
    spread = torch.arange(valid.numel(), device=valid.device).reshape(valid.shape) % n_rows
    return torch.where(valid, rows.long(), spread).reshape(-1)


def knn_rows(query, ref, k, ref_mask, query_mask):
    """K1's table of each query's k nearest valid refs as flat rows into
    the (B n_ref) ref rows, its slots' validity (a finite distance and a
    valid query) and the squared distances; invalid slots read rows of their
    own (``_spread_rows``).  Returns (rows (B M k,), valid (B, M, k), d2)."""
    b, n_ref = ref_mask.shape
    idx, d2 = knn(query, ref, k, ref_mask=ref_mask)
    valid = torch.isfinite(d2) & query_mask[..., None]
    base = (torch.arange(b, device=ref.device) * n_ref)[:, None, None]
    return _spread_rows(valid, idx.long() + base, b * n_ref), valid, d2


class GridKNNDownsample(nn.Module):
    """Stride-2 parents, each the max over its 16 nearest children (K1) of
    a pre-norm linear (reference swin3d_layers.py GridKNNDownsample)."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 16):
        super().__init__()
        self.k = k
        self.norm = nn.LayerNorm(in_channels, eps=LN_EPS)
        self.linear = nn.Linear(in_channels, out_channels, bias=False)

    def forward(self, feat: torch.Tensor, level: SwinLevel, parent: SwinLevel) -> torch.Tensor:
        b, n = level.mask.shape
        cap = parent.mask.shape[1]
        rows, valid, _ = knn_rows(parent.xyz, level.xyz, self.k, level.mask, parent.mask)
        y = self.linear(self.norm(feat)).reshape(b * n, -1)
        grouped = y.index_select(0, rows).reshape(b, cap, self.k, -1)
        grouped = torch.where(valid[..., None], grouped, torch.full_like(grouped, -1e9))
        return where_valid(parent.mask, grouped.amax(dim=2))


def interpolate(src: SwinLevel, dst: SwinLevel, src_feat: torch.Tensor, k: int,
                eps: float = 1e-8) -> torch.Tensor:
    """k-NN inverse-distance interpolation of ``src_feat`` (B, n_src, C) onto
    ``dst``'s rows (K1; weights 1/d normalised to sum 1, +inf slots 0), as
    the JAX ``interpolation``; padded destination rows 0."""
    b, n_src = src.mask.shape
    rows, valid, d2 = knn_rows(dst.xyz, src.xyz, k, src.mask, dst.mask)
    w = 1.0 / (torch.sqrt(torch.clamp(d2, min=0.0)) + eps)
    w = torch.where(valid, w, torch.zeros_like(w))
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=eps)
    gathered = src_feat.reshape(b * n_src, -1).index_select(0, rows)
    gathered = gathered.reshape(*w.shape, -1)
    return (gathered * w[..., None].to(gathered.dtype)).sum(dim=-2)


class BasicLayer(nn.Module):
    """A stage's blocks and, but for the last stage, its downsample."""

    def __init__(self, blocks: List[nn.Module], downsample: Optional[nn.Module] = None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class Upsample(nn.Module):
    """linear1(skip) + 3-NN interpolation of linear2(coarse), each linear
    after a LayerNorm; with ``attn`` one window block after (reference
    swin3d_layers.py Upsample, ``linear`` / ``linear_attn``)."""

    def __init__(self, in_channels: int, out_channels: int, up_k: int = 3,
                 block: Optional[nn.Module] = None):
        super().__init__()
        self.up_k = up_k
        self.linear1 = nn.Sequential(nn.LayerNorm(out_channels, eps=LN_EPS),
                                     nn.Linear(out_channels, out_channels))
        self.linear2 = nn.Sequential(nn.LayerNorm(in_channels, eps=LN_EPS),
                                     nn.Linear(in_channels, out_channels))
        self.block = None if block is None else BasicLayer([block])

    def forward(self, feat, level, skip_feat, skip_level, generator=None):
        up = interpolate(level, skip_level, self.linear2(feat), self.up_k)
        out = where_valid(skip_level.mask, self.linear1(skip_feat) + up)
        if self.block is not None:
            out = self.block.blocks[0](out, skip_level, generator)
        return out


class ConvBNReLU(nn.Module):
    """A 3^3 submanifold conv, BatchNorm, ReLU (the stem, reference
    MinkConvBNRelu)."""

    def __init__(self, in_channels: int, out_channels: int, norm_fn):
        super().__init__()
        self.conv = SubMConv(in_channels, out_channels, len(OFFSETS3))
        self.norm = norm_fn(out_channels)

    def forward(self, feat, rules, mask):
        return where_valid(mask, F.relu(self.norm(self.conv(feat, rules), mask)))


@MODELS.register_module("Swin3D-v1m1")
class Swin3DUNet(nn.Module):
    """``forward(input_dict, generator=None)`` -> logits (B, N, classes),
    padded rows 0.  The batch holds ``grid_coord`` (B, N, 3), ``feat``
    (colour first, then normal under ``XYZ_RGB_NORM``, or ``coord_feat`` /
    ``normal``) and ``mask``; ``generator`` feeds the drop-path draws in
    training.  With ``stem_transformer=False`` the logits are the JAX
    module's: the stem-down level's rows (ROADMAP §3)."""

    compact_levels = True  # levels past the input at their valid length (tests: False)

    def __init__(self, in_channels: int, num_classes: int, base_grid_size: float = 0.02,
                 depths: Sequence[int] = (2, 4, 9, 4, 4),
                 channels: Sequence[int] = (48, 96, 192, 384, 384),
                 num_heads: Sequence[int] = (6, 6, 12, 24, 24),
                 window_sizes: Sequence[int] = (5, 7, 7, 7, 7), quant_size: int = 4,
                 drop_path_rate: float = 0.2, up_k: int = 3, num_layers: int = 5,
                 stem_transformer: bool = True, down_stride: int = 2,
                 upsample: str = "linear", knn_down: bool = True, cRSE: str = "XYZ_RGB",
                 fp16_mode: int = 0, patch_cap: int = 48):
        super().__init__()
        norm_fn = _bn_factory()
        self.cRSE, self.patch_cap = cRSE, patch_cap
        self.layer_start = 0 if stem_transformer else 1
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]

        def block(i, d, shift, rate):
            return SwinBlock(channels[i], num_heads[i], int(window_sizes[i]), quant_size,
                             patch_cap, shift, rate, cRSE)

        if stem_transformer:
            self.stem_layer = ConvBNReLU(in_channels, channels[0], norm_fn)
            self.downsample = None
        else:
            self.stem_layer = nn.Sequential(ConvBNReLU(in_channels, channels[0], norm_fn),
                                            BasicBlock(channels[0], channels[0], norm_fn))
            self.downsample = GridKNNDownsample(channels[0], channels[1])
        self.layers = nn.ModuleList(
            BasicLayer([block(i, d, d % 2 == 1, dpr[sum(depths[:i]) + d])
                        for d in range(depths[i])],
                       GridKNNDownsample(channels[i], channels[i + 1])
                       if i < num_layers - 1 else None)
            for i in range(self.layer_start, num_layers))
        self.upsamples = nn.ModuleList(
            Upsample(channels[i], channels[i - 1], up_k,
                     block(i - 1, 0, False, 0.1)
                     if "attn" in upsample and window_sizes[i - 1] > 0 else None)
            for i in range(num_layers - 1, self.layer_start, -1))
        self.classifier = nn.Sequential(OrderedDict([
            ("0", _linear(channels[self.layer_start], channels[0])),
            ("1", norm_fn(channels[0])), ("2", nn.ReLU()),
            ("3", _linear(channels[0], num_classes))]))

    def parent(self, level: SwinLevel) -> SwinLevel:
        """The stride-2 parents of ``level`` (``unique_parents``), at the
        batch's largest parent count rounded up to a patch (or the level's
        length): their xyz and signal the mean of their children's (summed
        in row order), the signal's xyz halved into the parents' voxel
        units."""
        b, n = level.mask.shape
        p_grid, p_mask, c2p = unique_parents(level.grid, level.mask, 2)
        cap = n
        if self.compact_levels:
            count = int(p_mask.sum(dim=1).max())
            cap = min(n, -(-max(count, 1) // self.patch_cap) * self.patch_cap)
            p_grid, p_mask = p_grid[:, :cap].contiguous(), p_mask[:, :cap].contiguous()
        values = torch.cat([level.xyz, level.signal], dim=-1).float().reshape(b * n, -1)
        pooled = scatter_mean_to_parent(values, flatten_slot_map(c2p, cap), b * cap)
        pooled = pooled.reshape(b, cap, -1)
        p_signal = pooled[..., 3:]
        p_signal = torch.cat([divide_exact(p_signal[..., :3], 2.0), p_signal[..., 3:]], -1)
        return SwinLevel(p_grid, p_mask, pooled[..., :3], p_signal)

    def levels(self, input_dict: Dict) -> List[SwinLevel]:
        """The forward's levels, the input first, each the parents of the one
        before (``parent``; as many as the layers, the stem-down level
        included).  They depend on the voxels alone."""
        grid = input_dict["grid_coord"]
        mask = input_dict["mask"].to(torch.bool)
        # the window ids keep the JAX package's 32-bit keys (``window_sort``),
        # so the grid keeps their budget
        check_grid_bound(grid, mask, KEY32_BITS)
        xyz = grid.float()
        levels = [SwinLevel(grid.to(torch.int32), mask, xyz, self.signal(input_dict, xyz))]
        for _ in range(len(self.layers) + self.layer_start - 1):
            levels.append(self.parent(levels[-1]))
        return levels

    def signal(self, input_dict: Dict, xyz: torch.Tensor) -> torch.Tensor:
        """The cRSE signal: voxel-unit xyz, colour (and normal)."""
        feat = input_dict["feat"]
        cf = input_dict.get("coord_feat", feat)
        rgb = cf[..., :3].float()
        parts = [xyz, rgb]
        if "NORM" in self.cRSE:
            if "normal" in input_dict:
                parts.append(input_dict["normal"][..., :3].float())
            elif cf.shape[-1] >= 6:
                parts.append(cf[..., 3:6].float())
            else:
                parts.append(torch.zeros_like(rgb))
        return torch.cat(parts, dim=-1)

    def forward(self, input_dict: Dict, generator=None) -> torch.Tensor:
        levels = self.levels(input_dict)
        level = levels[0]
        b, n = level.mask.shape
        rules = table_rulebook(flatten_neighbor_rows(
            neighbor_table(level.grid, level.mask, OFFSETS3)))
        feat = input_dict["feat"].float().reshape(b * n, -1)
        if self.downsample is None:
            feat = self.stem_layer(feat, rules, level.flat_mask).reshape(b, n, -1)
        else:
            stem, res = self.stem_layer
            feat = res(stem(feat, rules, level.flat_mask), rules, level.flat_mask)
            feat = self.downsample(feat.reshape(b, n, -1), level, levels[1])
        skips = []
        for i, layer in enumerate(self.layers, start=self.layer_start):
            for blk in layer.blocks:
                feat = blk(feat, levels[i], generator)
            skips.append((feat, levels[i]))
            if layer.downsample is not None:
                feat = layer.downsample(feat, levels[i], levels[i + 1])
        feat, level = skips.pop()
        for up in self.upsamples:
            skip_feat, skip_level = skips.pop()
            feat = up(feat, level, skip_feat, skip_level, generator)
            level = skip_level
        rows = level.mask.shape[1]
        fc1, bn, _, fc2 = self.classifier
        y = F.relu(bn(fc1(feat).reshape(b * rows, -1), level.flat_mask))
        logits = where_valid(level.mask, fc2(y).reshape(b, rows, -1))
        return F.pad(logits, (0, 0, 0, n - rows))
