"""Stratified Transformer (ST-v1m1 / ST-v1m2) over padded batches.

Counterpart of ``pointcloudpdf_tpu/models/stratified_transformer/st.py``:
a KPConv stem, then encoder layers of pre-norm blocks whose attention runs
over a fixed-K stratified key set (``k_local`` nearest points of the
query's shifted window plus ``k_sparse`` nearest FPS-downsampled points of
the enclosing 2x window) with the contextual relative position encoding,
FPS + kNN max-pool downsampling, and a 3-NN interpolation decoder.
``forward`` returns ``(logits, intermediates)`` with the intermediates
``stem``, ``enc{i}``, ``dec{i}`` and ``up{step}`` as ``Points``.

Submodules carry the reference's (Pointcept) names and nesting
(``stem_layer``, ``downsample``, ``layers.{l}.blocks.{d}``, ``upsamples``,
``classifier``), so ``bridge.py`` maps the JAX tree onto them by the
reference importer's rules read backwards.

What the JAX modules do only for the TPU is not here: the query chunks, the
one-hot table contractions and the merged gather sources.  The attention
core is ``ops.st_attention`` (kernel K5), the KPConv core ``ops.kpconv``
(kernel K6); both kernels are inference-only, as in the JAX package, so a
module that trains takes the plain differentiable version, and one in
eval mode the wrapper, which on the card launches the kernel or raises
when a gradient is asked of it.  LayerNorm runs at epsilon 1e-6, the JAX package's
(Flax's default; the reference's PyTorch default is 1e-5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...ops.geometry import (ball_query, divide_exact, gather_rows,
                             interpolation, knn)
from ...ops.kpconv import kpconv, kpconv_plain
from ...ops.sampling import blocked_farthest_point_sampling
from ...ops.st_attention import st_attention, st_attention_plain
from ...ops.voxel import pack_grid32
from ..builder import MODELS
from ..norm import MaskedBatchNorm
from ..utils.structure import Points, where_valid

LN_EPS = 1e-6


def _window_ids(coord: torch.Tensor, mask: torch.Tensor, window_size: float,
                shift: bool) -> torch.Tensor:
    """(B, N) window id per point (the voxel of the window grid, packed)."""
    big = torch.full_like(coord, 1e9)
    cmin = torch.where(mask[..., None], coord, big).amin(dim=1, keepdim=True)
    pos = coord - cmin
    if shift:
        pos = pos + window_size / 2
    g = torch.clamp(torch.floor(divide_exact(pos, window_size)), 0, 2047
                    ).to(torch.int32)
    cap = torch.tensor([2047, 2047, 1023], dtype=torch.int32, device=g.device)
    return pack_grid32(torch.minimum(g, cap))


def kpconv_kernel_points() -> np.ndarray:
    """15 deterministic kernel points: centre + 6 axes + 8 cube corners."""
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    corners = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        np.float32,
    ) / np.sqrt(3)
    return np.concatenate([np.zeros((1, 3)), axes, corners]).astype(np.float32)


class KPConvLayer(nn.Module):
    """The kernel-point weights and the kernel points' absolute positions
    (a buffer: a reference checkpoint's disposition carries over)."""

    def __init__(self, in_channels: int, out_channels: int, sigma_r: float):
        super().__init__()
        points = kpconv_kernel_points() * np.float32(1.5 * sigma_r)
        self.register_buffer("K_points", torch.from_numpy(points))
        self.weight = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(len(points), in_channels, out_channels), std=0.02,
            a=-0.04, b=0.04))


class KPConvBlock(nn.Module):
    """Kernel-point conv over ball-query neighbourhoods (reference
    KPConvSimpleBlock / KPConvResBlock)."""

    def __init__(self, in_channels: int, out_channels: int,
                 prev_grid_size: float, sigma: float = 1.0,
                 residual: bool = False, kp_radius: float = 2.5,
                 max_neighbor: int = 34):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.residual = residual
        self.radius = kp_radius * prev_grid_size       # neighbour ball
        self.sigma_r = sigma * prev_grid_size          # influence extent
        self.max_neighbor = max_neighbor
        mid = out_channels // 4 if residual else out_channels

        def unary(c_in, c_out):
            return nn.Sequential(nn.Linear(c_in, c_out, bias=False),
                                 MaskedBatchNorm(c_out, momentum=0.02))

        if residual:
            self.unary_1 = unary(in_channels, mid)
            self.kpconv = KPConvLayer(mid, mid, self.sigma_r)
            self.unary_2 = unary(mid, out_channels)
            if in_channels != out_channels:
                self.shortcut_op = unary(in_channels, out_channels)
        else:
            self.kpconv = KPConvLayer(in_channels, mid, self.sigma_r)
            self.bn = MaskedBatchNorm(out_channels, momentum=0.02)

    def neighbours(self, coord, mask):
        """The block's neighbour table: the ``max_neighbor`` nearest valid
        points inside its ball, (idx (B, N, S) int32, nmask (B, N, S))."""
        idx, nmask = ball_query(coord, coord, self.radius, self.max_neighbor,
                                ref_mask=mask)
        return idx, nmask & mask[..., None]

    def forward(self, feat, coord, mask, neighbours=None):
        """``neighbours``: a table another block of the same ball already
        found on these points (the stem's two blocks share one)."""
        x = feat
        if self.residual:
            lin, bn = self.unary_1
            x = F.leaky_relu(bn(lin(x), mask), 0.2)
        idx, nmask = neighbours or self.neighbours(coord, mask)
        # the kernel is inference-only: a training block takes the plain
        # version, an eval block the wrapper, which raises on the card when
        # a gradient is asked of it
        core = kpconv_plain if self.training else kpconv
        y = core(coord, x, idx, nmask, self.kpconv.K_points,
                 self.kpconv.weight, self.sigma_r).to(x.dtype)
        if self.residual:
            # the kpconv output goes straight into unary_2; no activation
            # after the shortcut add (reference KPConvResBlock.forward)
            lin, bn = self.unary_2
            y = F.leaky_relu(bn(lin(y), mask), 0.2)
            if self.in_channels != self.out_channels:
                lin, bn = self.shortcut_op
                y = y + bn(lin(feat), mask)
            else:
                y = y + feat
        else:
            y = F.leaky_relu(self.bn(y, mask), 0.2)
        return where_valid(mask, y)


class StratifiedWindowAttention(nn.Module):
    """Masked multi-head attention over the stratified fixed-K key set with
    cRPE (reference WindowAttention)."""

    def __init__(self, dim: int, num_heads: int, window_size: float,
                 quant_size: float, rel_query: bool = True,
                 rel_key: bool = True, rel_value: bool = True,
                 qkv_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.quant_size = quant_size
        # in Python doubles, as the JAX module sizes its tables
        self.num_bins = 2 * int((2 * window_size + 1e-4) // quant_size)
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        shape = (self.num_bins, num_heads, dim // num_heads, 3)
        for name, on in (("query", rel_query), ("key", rel_key),
                         ("value", rel_value)):
            table = None
            if on:
                table = nn.Parameter(nn.init.trunc_normal_(
                    torch.empty(shape), std=0.02, a=-0.04, b=0.04))
            self.register_parameter(f"relative_pos_{name}_table", table)

    def _table(self, name: str) -> Optional[torch.Tensor]:
        """The (3, 2L, C) merged view of a (2L, H, hd, 3) table."""
        t = getattr(self, f"relative_pos_{name}_table")
        if t is None:
            return None
        return t.permute(3, 0, 1, 2).reshape(3, self.num_bins, self.dim)

    def forward(self, feat, coord, key_idx, key_mask, mask):
        q, k, v = self.qkv(feat).chunk(3, dim=-1)
        tables = [self._table(n) for n in ("query", "key", "value")]
        # inference-only kernel: the same dispatch as KPConvBlock's
        core = st_attention_plain if self.training else st_attention
        out = core(q, k, v, coord, key_idx, key_mask & mask[..., None],
                   *tables, self.num_heads, self.window_size, self.quant_size,
                   self.num_bins)
        return where_valid(mask, self.proj(out.to(feat.dtype)))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        # exact erf GELU (torch's default, the reference's)
        return self.fc2(F.gelu(self.fc1(x)))


class STBlock(nn.Module):
    """Pre-norm attention + MLP block (reference SwinTransformerBlock).
    Drop path keeps or drops a whole sample; its draws come from the
    generator handed to ``forward`` (torch's global one when None)."""

    def __init__(self, dim: int, num_heads: int, window_size: float,
                 quant_size: float, rel_query: bool, rel_key: bool,
                 rel_value: bool, drop_path: float, mlp_ratio: float = 4.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = StratifiedWindowAttention(
            dim, num_heads, window_size, quant_size, rel_query, rel_key,
            rel_value)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _drop_path(self, x, generator):
        if self.drop_path == 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_path
        draw = torch.rand((x.shape[0], 1, 1), generator=generator,
                          device=x.device if generator is None
                          else generator.device)
        return x * (draw.to(x.device) < keep).to(x.dtype) / keep

    def forward(self, feat, coord, key_idx, key_mask, mask, generator=None):
        y = self.attn(self.norm1(feat), coord, key_idx, key_mask, mask)
        feat = feat + self._drop_path(y, generator)
        y = self.mlp(self.norm2(feat))
        feat = feat + self._drop_path(y, generator)
        return where_valid(mask, feat)


class TransitionDown(nn.Module):
    """FPS(ratio) + kNN grouping + LayerNorm / Linear + max-pool.  The
    downsampled count comes from the padded length, not the valid count."""

    def __init__(self, in_channels: int, out_channels: int, ratio: float,
                 k: int, fps_group_steps: int = 128,
                 exact_count: bool = False):
        super().__init__()
        self.ratio = ratio
        self.k = k
        self.fps_group_steps = fps_group_steps
        self.exact_count = exact_count
        self.norm = nn.LayerNorm(in_channels, eps=LN_EPS)
        self.linear = nn.Linear(in_channels, out_channels, bias=False)

    def forward(self, pts: Points) -> Points:
        coord, feat, mask = pts
        n = coord.shape[1]
        m = (int(n * self.ratio) + 1 if self.exact_count
             else max(int(n * self.ratio), 1))
        idx, valid = blocked_farthest_point_sampling(
            coord, m, mask, max_group_steps=self.fps_group_steps)
        new_coord = coord.gather(1, idx[..., None].expand(-1, -1, 3))
        nidx, nd2 = knn(new_coord, coord, self.k, ref_mask=mask)
        nmask = torch.isfinite(nd2) & valid[..., None]
        y = self.linear(self.norm(gather_rows(feat, nidx)))     # (B, M, K, C)
        y = torch.where(nmask[..., None], y, torch.full_like(y, -1e9))
        return Points(new_coord, where_valid(valid, y.amax(dim=2)), valid)


class Upsample(nn.Module):
    """3-NN interpolation decode step (reference Upsample): ``linear2`` on
    the coarse features, interpolated, plus ``linear1`` on the skip."""

    def __init__(self, k: int, in_channels: int, out_channels: int):
        super().__init__()
        self.k = k
        self.linear1 = nn.Sequential(nn.LayerNorm(out_channels, eps=LN_EPS),
                                     nn.Linear(out_channels, out_channels))
        self.linear2 = nn.Sequential(nn.LayerNorm(in_channels, eps=LN_EPS),
                                     nn.Linear(in_channels, out_channels))

    def forward(self, pts: Points, skip: Points) -> Points:
        up = interpolation(pts.coord, skip.coord, self.linear2(pts.feat),
                           k=self.k, src_mask=pts.mask, dst_mask=skip.mask)
        return skip.with_feat(
            where_valid(skip.mask, self.linear1(skip.feat) + up))


class BasicLayer(nn.Module):
    """One encoder layer: its blocks and, unless it is the last, the
    downsampling behind them."""

    def __init__(self, blocks: List[STBlock],
                 downsample: Optional[TransitionDown]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


def key_sets_layer(coord, mask, window_size: float, depth: int, ds_idx,
                   ds_valid, k_local: int, k_sparse: int
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Fixed-K stratified keys for every shift parity a layer of ``depth``
    blocks uses: ``k_local`` nearest points that share the query's small
    window, then ``k_sparse`` nearest of the FPS subset (``ds_idx`` rows,
    ``ds_valid``) that share its 2x window but not its small window.  The
    two kNNs run once; each parity adds window-id compares.  Returns
    [(key_idx (B, N, K) int32 rows, key_mask (B, N, K) bool)] by parity;
    masked slots still hold safe gather rows."""
    idx_l, d_l = knn(coord, coord, k_local, ref_mask=mask)
    fin_l = torch.isfinite(d_l)
    ds_coord = coord.gather(1, ds_idx[..., None].expand(-1, -1, 3))
    idx_s, d_s = knn(coord, ds_coord, k_sparse, ref_mask=ds_valid)
    fin_s = torch.isfinite(d_s)
    # FPS slots back to rows of the layer
    orig_s = ds_idx.gather(1, idx_s.long().flatten(1)).view_as(idx_s)
    key_idx = torch.cat([idx_l, orig_s.to(idx_l.dtype)], dim=-1)

    def at(ids, rows):                     # (B, N) ids at (B, N, K) rows
        return ids.gather(1, rows.long().flatten(1)).view(rows.shape)

    out = []
    for shift in ([False] if depth <= 1 else [False, True]):
        win = _window_ids(coord, mask, window_size, shift)
        big = _window_ids(coord, mask, 2 * window_size, shift)
        m_l = fin_l & (at(win, idx_l) == win[..., None])
        m_s = (fin_s & (at(big, orig_s) == big[..., None])
               & (at(win, orig_s) != win[..., None]))
        out.append((key_idx, torch.cat([m_l, m_s], dim=-1)))
    return out


@MODELS.register_module("ST-v1m1")
class StratifiedTransformer(nn.Module):
    """``forward(input_dict, generator=None)`` -> (logits (B, N, classes),
    intermediates); ``generator`` feeds the drop-path draws in training."""

    def __init__(self, downsample_scale: int, depths: Sequence[int],
                 channels: Sequence[int], num_heads: Sequence[int],
                 window_size: Sequence[float], up_k: int,
                 grid_sizes: Sequence[float], quant_sizes: Sequence[float],
                 rel_query: bool = True, rel_key: bool = False,
                 rel_value: bool = False, drop_path_rate: float = 0.2,
                 num_layers: int = 4, concat_xyz: bool = False,
                 num_classes: int = 13, ratio: float = 0.25, k: int = 16,
                 prev_grid_size: float = 0.04, sigma: float = 1.0,
                 stem_transformer: bool = False,
                 kp_ball_radius: float = 0.02 * 2.5,
                 kp_max_neighbor: int = 34, mlp_ratio: float = 4.0,
                 k_local: Union[int, Sequence[int]] = 32,
                 k_sparse: Union[int, Sequence[int]] = 16,
                 fps_group_steps: int = 128, ref_exact_counts: bool = False,
                 in_channels: int = 6):
        super().__init__()
        if stem_transformer:
            raise NotImplementedError(
                "ST-v1m1 with stem_transformer=True (no KPConv stem skip) is "
                "not ported; every shipped config uses the stem")
        # grid_sizes and concat_xyz are config fields the JAX module holds
        # and never reads
        self.downsample_scale = downsample_scale
        self.depths = tuple(depths)
        self.window_size = tuple(window_size)
        self.num_layers = num_layers
        self.k_local = k_local
        self.k_sparse = k_sparse
        self.fps_group_steps = fps_group_steps
        self.ref_exact_counts = ref_exact_counts
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        kp_radius = kp_ball_radius / prev_grid_size

        def down(c_in, c_out):
            return TransitionDown(c_in, c_out, ratio, k,
                                  fps_group_steps=fps_group_steps,
                                  exact_count=ref_exact_counts)

        self.stem_layer = nn.ModuleList([
            KPConvBlock(in_channels, channels[0], prev_grid_size, sigma,
                        residual=False, kp_radius=kp_radius,
                        max_neighbor=kp_max_neighbor),
            KPConvBlock(channels[0], channels[0], prev_grid_size, sigma,
                        residual=True, kp_radius=kp_radius,
                        max_neighbor=kp_max_neighbor)])
        self.downsample = down(channels[0], channels[1])
        self.layers = nn.ModuleList()
        for i in range(1, num_layers):
            base = sum(depths[:i])
            blocks = [STBlock(channels[i], num_heads[i], window_size[i],
                              quant_sizes[i], rel_query, rel_key, rel_value,
                              dpr[base + d], mlp_ratio)
                      for d in range(depths[i])]
            self.layers.append(BasicLayer(
                blocks, down(channels[i], channels[i + 1])
                if i < num_layers - 1 else None))
        # upsamples[j] lifts layer num_layers-1-j onto the one below it;
        # the last lands on the stem
        self.upsamples = nn.ModuleList([
            Upsample(up_k, channels[i], channels[i - 1])
            for i in range(num_layers - 1, 0, -1)])
        self.classifier = nn.Sequential(
            nn.Linear(channels[0], channels[0]), MaskedBatchNorm(channels[0]),
            nn.ReLU(inplace=True), nn.Linear(channels[0], num_classes))

    def _cap(self, value, i: int) -> int:
        return value[i] if isinstance(value, (list, tuple)) else value

    def key_sets(self, pts: Points, i: int):
        """The FPS subset for layer i's sparse keys (count from the padded
        length: ``N // downsample_scale``) and the layer's key sets."""
        m = pts.coord.shape[1] // self.downsample_scale
        m = m + 1 if self.ref_exact_counts else max(m, 1)
        ds_idx, ds_valid = blocked_farthest_point_sampling(
            pts.coord, m, pts.mask, max_group_steps=self.fps_group_steps)
        return key_sets_layer(
            pts.coord, pts.mask, self.window_size[i], self.depths[i], ds_idx,
            ds_valid, self._cap(self.k_local, i), self._cap(self.k_sparse, i))

    def forward(self, input_dict: Dict, generator=None
                ) -> Tuple[torch.Tensor, Dict[str, Points]]:
        coord = input_dict["coord"].float()
        feat = input_dict["feat"].float()
        mask = input_dict["mask"].to(torch.bool)
        inter: Dict[str, Points] = {}

        # both stem blocks look into the same ball: one query serves them
        # (under jit the JAX package's two identical queries fold into one)
        table = self.stem_layer[0].neighbours(coord, mask)
        for block in self.stem_layer:
            feat = block(feat, coord, mask, table)
        stem = inter["stem"] = Points(coord, feat, mask)
        pts = self.downsample(stem)

        skips = []
        for li, layer in enumerate(self.layers):
            i = li + 1
            key_sets = self.key_sets(pts, i)
            feat = pts.feat
            for d, block in enumerate(layer.blocks):
                key_idx, key_mask = key_sets[d % 2]
                feat = block(feat, pts.coord, key_idx, key_mask, pts.mask,
                             generator)
            pts = pts.with_feat(feat)
            skips.append(pts)
            inter[f"enc{i}"] = pts
            if i < self.num_layers - 1:
                pts = layer.downsample(pts)

        # decoder: ``up{step}`` mirrors the reference's upsamples.{step}
        # outputs, which the ST recognizer reads
        pts = skips.pop()
        for step, up in enumerate(self.upsamples):
            i = self.num_layers - 1 - step
            pts = up(pts, skips.pop() if skips else stem)
            inter[f"dec{i - 1}" if i == 1 else f"dec{i}"] = pts
            inter[f"up{step}"] = pts

        lin1, bn, relu, lin2 = self.classifier
        logits = lin2(relu(bn(lin1(pts.feat), pts.mask)))
        return where_valid(pts.mask, logits), inter


@MODELS.register_module("ST-v1m2")
def stratified_transformer_v1m2(
        in_channels=6, num_classes=13, channels=(48, 96, 192, 384, 384),
        num_heads=(6, 12, 24, 24), depths=(3, 9, 3, 3),
        window_size=(0.2, 0.4, 0.8, 1.6), quant_size=(0.01, 0.02, 0.04, 0.08),
        mlp_expend_ratio=4.0, down_ratio=0.25, down_num_sample=16,
        kp_ball_radius=2.5 * 0.02, kp_max_neighbor=34, kp_grid_size=0.02,
        kp_sigma=1.0, drop_path_rate=0.2, rel_query=True, rel_key=True,
        rel_value=True, qkv_bias=True, stem=True, up_k=3, **caps):
    """ST-v1m2 "refined": the v1m1 module under the refined constructor
    (per-layer tuples shifted one slot behind a stem slot, cRPE on q, k and
    v, an explicit MLP ratio, renamed KPConv knobs)."""
    num_layers = len(depths)
    assert len(channels) == num_layers + 1, "v1m2 channels carry a stem slot"

    def pad(seq, fill):
        return (fill,) + tuple(seq)

    return StratifiedTransformer(
        downsample_scale=int(round(1.0 / down_ratio)), depths=pad(depths, 0),
        channels=tuple(channels), num_heads=pad(num_heads, 1),
        window_size=pad(window_size, window_size[0]), up_k=up_k,
        grid_sizes=pad(quant_size, quant_size[0]),
        quant_sizes=pad(quant_size, quant_size[0]), rel_query=rel_query,
        rel_key=rel_key, rel_value=rel_value, drop_path_rate=drop_path_rate,
        num_layers=num_layers + 1, num_classes=num_classes, ratio=down_ratio,
        k=down_num_sample, prev_grid_size=kp_grid_size, sigma=kp_sigma,
        stem_transformer=not stem, kp_ball_radius=kp_ball_radius,
        kp_max_neighbor=kp_max_neighbor, mlp_ratio=mlp_expend_ratio,
        in_channels=in_channels, **caps)
