"""Point Transformer V3 (PT-v3m1): serialized patch attention over padded
voxel sets.

Counterpart of ``pointcloudpdf_tpu/models/point_transformer_v3/ptv3.py``
(reference Pointcept ``point_transformer_v3m1_base.py``):

- each level's voxels sort along space-filling curves (``order``: z,
  z-trans, hilbert, hilbert-trans; ``ops.serialization``), valid first;
  a block reads its level in order ``i % len(order)`` and cuts the sorted
  rows into patches of ``patch_size``, with masked dense multi-head
  attention inside each patch, optionally biased by a learned table of
  per-axis grid offsets (RPE);
- xCPE is a 3^3 submanifold conv with bias over the level's exact
  neighbour table, compacted into a ``Rulebook`` once a level and shared
  by the level's encoder and decoder blocks; the stem is a 5^3 one, whose
  table's 3^3 columns are level 0's table (SpUNet's ``_SUB3``);
- grid pooling takes each stride-2 parent voxel (``unique_parents``, at a
  level capacity shrunk by ``level_capacity_factor``) the max of its
  children's projections; unpooling reads the child -> parent map back.

Submodules carry the reference's names (``embedding.stem.conv`` /
``.norm``, ``enc.enc{s}.down``, ``enc.enc{s}.block{i}``, ``dec.dec{s}.up``,
``dec.dec{s}.block{i}``; in a block ``cpe.0/1/2``, ``norm1.0``,
``attn.qkv``, ``attn.proj``, ``attn.rpe.rpe_table``, ``norm2.0``,
``mlp.0.fc1`` / ``fc2``), which ``bridge.py`` maps onto the JAX tree.  What
the JAX module computes is kept where it differs from the reference: its
LayerNorms run at Flax's epsilon 1e-6, its blocks cycle through the orders
and ``shuffle_orders`` shuffles nothing, and curve codes clip to 10 bits an
axis.  BatchNorms run at momentum 0.01 and epsilon 1e-3 (``_bn_factory``);
``pdnorm_bn`` / ``pdnorm_ln`` swap them and the LayerNorms for per-condition
banks, named by ``forward``'s ``condition`` or the batch's
``condition_name``.

The JAX module's dense-extent path (``dense_extent``, ``conv_window``,
``conv_coverage_check``: TPU sorted-window convs) is not ported; the
constructor rejects those options, and the values the JAX module ignores
but that would change the result (``qk_scale``, ``attn_drop``,
``proj_drop``, ``pre_norm=False``, a stride other than 2).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.serialization import _INVALID, serialize_code
from ...ops.voxel import (check_grid_bound, count_dropped, flatten_neighbor_rows,
                          flatten_slot_map, neighbor_table, table_rulebook,
                          unique_parents)
from ..builder import MODELS
from ..norm import PDLayerNorm, PDMaskedBatchNorm, _bn_factory
from ..sparse_unet.spconv_unet import OFFSETS3, OFFSETS5, _SUB3, SubMConv
from ..utils.structure import masked_mean, where_valid

LN_EPS = 1e-6  # Flax's nn.LayerNorm(), as in the JAX module


def _linear(in_features, out_features, bias=True):
    """A Linear initialised as the JAX module's Dense: truncated normal of
    std 0.02, zero bias."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    nn.init.trunc_normal_(layer.weight, std=0.02, a=-0.04, b=0.04)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _sort_orders(grid: torch.Tensor, mask: torch.Tensor, orders: Sequence[str]):
    """Per-order sorts of a padded level: grid (B, N, 3), mask (B, N) ->
    ``order`` and ``inverse``, each (len(orders), B, N) int64.
    ``order[o, b]`` lists sample b's rows by curve code, masked rows last at
    the sentinel (stable, so equal codes keep row order, as ``jnp.argsort``);
    ``inverse`` is where each row landed, a scatter of ``arange``."""
    rows = torch.arange(mask.shape[1], device=grid.device).expand_as(mask)
    perms, invs = [], []
    for name in orders:
        code = serialize_code(grid, name)
        code = torch.where(mask, code, torch.full_like(code, _INVALID))
        perm = torch.argsort(code, dim=-1, stable=True)
        perms.append(perm)
        invs.append(torch.empty_like(perm).scatter_(1, perm, rows))
    return torch.stack(perms), torch.stack(invs)


def rpe_bound(patch_size: int) -> int:
    """The RPE's clip of a per-axis grid offset (the JAX module's
    expression, float rounding included: 15 at patch 128)."""
    return int((4 * patch_size) ** (1 / 3) * 2)


class Level:
    """What a level's blocks share: its mask, the 3^3 rulebook, each
    order's sort as flat row indices, and the RPE's offset index of each
    (order, patch size), made on first use."""

    def __init__(self, grid, mask, nbr3, order, inverse):
        b, n = mask.shape
        base = (torch.arange(b, device=mask.device) * n)[None, :, None]
        self.grid, self.mask = grid, mask
        self.flat_mask = mask.reshape(b * n)
        self.rules = table_rulebook(flatten_neighbor_rows(nbr3))
        self.perm = order
        self.order_rows = (order + base).reshape(order.shape[0], b * n)
        self.inverse_rows = (inverse + base).reshape(inverse.shape[0], b * n)
        self._rpe = {}
        self._valid = None

    def patches(self, patch_size: int) -> int:
        """The patches of ``patch_size`` rows that hold a valid row in some
        sample: every sort puts a sample's padded rows last, so the patches
        past these hold padding alone.  One host synchronisation a level."""
        if self._valid is None:
            self._valid = int(self.mask.sum(1).max())
        return -(-self._valid // patch_size)

    def rpe_index(self, oi: int, patch_size: int) -> torch.Tensor:
        """(B, P, K, K) int32 over the level's first P = ``patches(K)``
        patches: for query k and key m of a patch in order ``oi``, the row
        of the (x, y, z) offset ``g_k - g_m`` (each axis clipped to
        +-``rpe_bound``) in the RPE's table of every offset triple.  The
        index depends on the level's grid and order alone, so the level's
        blocks share it (and the backward's saved copy)."""
        key = (oi, patch_size)
        if key not in self._rpe:
            self._rpe[key] = rpe_index(self.grid, self.mask, self.perm[oi], patch_size,
                                       self.patches(patch_size))
        return self._rpe[key]


def rpe_index(grid: torch.Tensor, mask: torch.Tensor, perm: torch.Tensor,
              patch_size: int, patches: Optional[int] = None) -> torch.Tensor:
    """(B, P, K, K) int32 rows of the RPE's offset-triple table for the
    first ``patches`` (default all) patches of ``grid`` (B, N, 3) sorted by
    ``perm`` (B, N) (``offset_index`` at ``rpe_bound(patch_size)``)."""
    b, n = perm.shape
    k = patch_size
    n_pad = -(-n // k) * k
    p = n_pad // k if patches is None else patches
    g = grid.gather(1, perm[..., None].expand(-1, -1, 3))
    g = F.pad(g.to(torch.int32), (0, 0, 0, n_pad - n))[:, :p * k].reshape(b, p, k, 3)
    valid = F.pad(mask.gather(1, perm), (0, n_pad - n))[:, :p * k].reshape(b, p, k)
    return offset_index(g, valid, rpe_bound(k))


def offset_index(g: torch.Tensor, valid: torch.Tensor, bound: int) -> torch.Tensor:
    """Patches' grids g (B, P, K, 3) int and row validity (B, P, K) ->
    (B, P, K, K) int32: for query k and key m the row of the offset ``g_k -
    g_m`` in a table of every offset triple, each axis clipped to +-``bound``
    and shifted to [0, rpe_num), as ``(dx rpe_num + dy) rpe_num + dz``.

    A pair with a padded query or key (its bias is masked, its gradient 0)
    takes the row of its (k, m) slot modulo the table instead: a Mix3D
    empty slot's pairs would otherwise all sit at the zero offset, and the
    lookup's backward sums one row's slots one after another."""
    k = g.shape[2]
    span = 2 * bound + 1
    idx = None
    for axis in range(3):
        a = g[..., axis]
        rel = torch.clamp(a[..., :, None] - a[..., None, :], -bound, bound) + bound
        idx = rel if idx is None else idx * span + rel
    slots = torch.arange(k * k, dtype=torch.int32, device=g.device) % span ** 3
    return torch.where(valid[..., :, None] & valid[..., None, :], idx, slots.reshape(k, k))


class DropPath(nn.Module):
    """Per-sample stochastic depth on a (B, N, C) tensor.  In training its
    draws come from the generator handed to ``forward``; there is no
    fallback to the global RNG (the JAX module needs its "dropout" rng)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("drop path in training needs a generator")
        keep = 1.0 - self.rate
        draw = torch.rand((x.shape[0], 1, 1), generator=generator,
                          device=generator.device).to(x.device)
        return x * (draw < keep).to(x.dtype) / keep


class RPE(nn.Module):
    """Relative-position bias: a learned (3 rpe_num, H) table, one block of
    ``rpe_num`` rows an axis, indexed by the clipped per-axis grid offset;
    the three axes' rows sum into a key pair's (H,) bias.

    The lookup goes through the table of every offset triple, ``rpe_num^3``
    rows each the sum of its three axis rows (in the JAX sum's order): one
    ``index_select`` a pair, whose backward is a scatter-add (atomic adds),
    not advanced indexing's sort-based backward, nor ``F.embedding``'s,
    which both sum one row's slots one after another
    (``tools/ptv3_rpe_compare_torch.py``: 2.6 against 11.9 ms for
    ``F.embedding`` at the S3DIS step's level 0 on an H100).  ``bound``
    clips an axis's offset (``rpe_bound`` for PT-v3)."""

    def __init__(self, bound: int, num_heads: int):
        super().__init__()
        self.bound = bound
        self.rpe_num = 2 * self.bound + 1
        self.rpe_table = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(3 * self.rpe_num, num_heads), std=0.02, a=-0.04, b=0.04))

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        """index (B, P, K, K) from ``Level.rpe_index`` -> bias (B, P, H, K, K)."""
        r = self.rpe_num
        tx, ty, tz = self.rpe_table.float().split(r)
        triples = ((tx[:, None, None] + ty[None, :, None]) + tz[None, None, :]).reshape(r ** 3, -1)
        bias = triples.index_select(0, index.reshape(-1)).reshape(*index.shape, -1)
        return bias.permute(0, 1, 4, 2, 3)


class SerializedAttention(nn.Module):
    """Masked dense multi-head attention over curve-order patches: qkv, a
    gather into the order, padding to a whole number of patches, softmax
    inside each patch (logits in f32, also under autocast; masked keys at
    -1e9), a gather back, ``proj``, zeros at padded rows.  Only the level's
    patches that hold a valid row run (``Level.patches``): the others hold
    padding alone, whose rows come out 0 either way.  A level is held at
    the input's padded length (the JAX module's capacities), so on a LiDAR
    scan most of a deep level's patches are such."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 qkv_bias: bool = True, enable_rpe: bool = False):
        super().__init__()
        self.channels = channels
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.qkv = _linear(channels, 3 * channels, qkv_bias)
        self.proj = _linear(channels, channels)
        self.rpe = RPE(rpe_bound(patch_size), num_heads) if enable_rpe else None

    def forward(self, feat: torch.Tensor, level: Level, oi: int) -> torch.Tensor:
        b, n = level.mask.shape
        c, h, k = self.channels, self.num_heads, self.patch_size
        n_pad = -(-n // k) * k
        p = level.patches(k)
        qkv = self.qkv(feat).reshape(b * n, 3 * c).index_select(0, level.order_rows[oi])
        qkv = F.pad(qkv.reshape(b, n, 3 * c), (0, 0, 0, n_pad - n))[:, :p * k]
        keys = F.pad(level.mask.gather(1, level.perm[oi]), (0, n_pad - n))[:, :p * k]
        q, kk, v = qkv.reshape(b, p, k, 3, h, c // h).permute(3, 0, 1, 4, 2, 5)
        with torch.autocast(feat.device.type, enabled=False):
            logits = (q.float() * (c // h) ** -0.5) @ kk.float().transpose(-1, -2)
            if self.rpe is not None:
                logits = logits + self.rpe(level.rpe_index(oi, k))
        logits = logits.masked_fill(~keys.reshape(b, p, 1, 1, k), -1e9)
        # a fully masked patch's rows are uniform over masked keys; those
        # rows are padding, zeroed below
        out = torch.softmax(logits, dim=-1).to(v.dtype) @ v       # (B, P, H, K, hd)
        out = F.pad(out.permute(0, 1, 3, 2, 4).reshape(b, p * k, c),
                    (0, 0, 0, n_pad - p * k))[:, :n]
        out = out.reshape(b * n, c).index_select(0, level.inverse_rows[oi])
        return where_valid(level.mask, self.proj(out.reshape(b, n, c)))


class MLP(nn.Module):
    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.fc1 = _linear(channels, hidden)
        self.fc2 = _linear(hidden, channels)

    def forward(self, x):
        # flax.linen.gelu is the tanh approximation
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    """xCPE (3^3 conv with bias, Linear, LayerNorm) as a residual, then the
    pre-norm attention and MLP residuals, each through drop path."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float, drop_path: float, qkv_bias: bool,
                 enable_rpe: bool, ln_fn):
        super().__init__()
        self.cpe = nn.Sequential(SubMConv(channels, channels, len(OFFSETS3), bias=True),
                                 _linear(channels, channels), ln_fn(channels))
        self.norm1 = nn.Sequential(ln_fn(channels))
        self.attn = SerializedAttention(channels, num_heads, patch_size, qkv_bias,
                                        enable_rpe)
        self.norm2 = nn.Sequential(ln_fn(channels))
        self.mlp = nn.Sequential(MLP(channels, int(channels * mlp_ratio)))
        self.drop_path = DropPath(drop_path)

    def forward(self, feat: torch.Tensor, level: Level, oi: int,
                generator=None) -> torch.Tensor:
        b, n, c = feat.shape
        conv, fc, norm = self.cpe
        y = norm(fc(conv(feat.reshape(b * n, c), level.rules)))
        feat = feat + where_valid(level.flat_mask, y).reshape(b, n, c)
        feat = feat + self.drop_path(self.attn(self.norm1(feat), level, oi), generator)
        feat = feat + self.drop_path(self.mlp(self.norm2(feat)), generator)
        return where_valid(level.mask, feat)


class SerializedPooling(nn.Module):
    """Grid pooling: each parent voxel the max of its children's
    projections (f32, ties sharing the gradient), then BatchNorm and ReLU."""

    def __init__(self, in_channels: int, out_channels: int, norm_fn):
        super().__init__()
        self.proj = _linear(in_channels, out_channels)
        self.norm = nn.Sequential(norm_fn(out_channels))

    def forward(self, feat, c2p, parent_mask):
        b, n_child = c2p.shape
        cap = parent_mask.shape[1]
        proj = self.proj(feat).reshape(b * n_child, -1).float()
        c = proj.shape[-1]
        flat_c2p = flatten_slot_map(c2p, cap)
        valid = flat_c2p >= 0
        # absent children send -inf to rows of their own (their row
        # number modulo the parents), not all to one row
        spread = torch.arange(b * n_child, device=feat.device) % (b * cap)
        slot = torch.where(valid, flat_c2p.long(), spread)
        src = torch.where(valid[:, None], proj, torch.full_like(proj, float("-inf")))
        pooled = proj.new_full((b * cap, c), float("-inf")).scatter_reduce(
            0, slot[:, None].expand(-1, c), src, "amax", include_self=False)
        pooled = torch.where(torch.isfinite(pooled), pooled, torch.zeros_like(pooled))
        flat_p_mask = parent_mask.reshape(-1)
        pooled = where_valid(flat_p_mask, F.relu(self.norm[0](pooled, flat_p_mask)))
        return pooled.reshape(b, cap, c)


class SerializedUnpooling(nn.Module):
    """Map unpooling: the parent's projection (BatchNorm, ReLU) read by each
    child, plus the child's skip projection (BatchNorm, ReLU)."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 norm_fn):
        super().__init__()
        self.proj = nn.Sequential(_linear(in_channels, out_channels), norm_fn(out_channels))
        self.proj_skip = nn.Sequential(_linear(skip_channels, out_channels),
                                       norm_fn(out_channels))

    def forward(self, feat, parent_mask, skip_feat, child_mask, c2p):
        b, n_parent = parent_mask.shape
        n_child = child_mask.shape[1]
        lin, bn = self.proj
        y = F.relu(bn(lin(feat).reshape(b * n_parent, -1), parent_mask.reshape(-1)))
        lin, bn = self.proj_skip
        sk = F.relu(bn(lin(skip_feat).reshape(b * n_child, -1), child_mask.reshape(-1)))
        flat_c2p = flatten_slot_map(c2p, n_parent)
        valid = flat_c2p >= 0
        # an index_select (its backward a scatter-add); absent children
        # read rows of their own, zeroed after
        spread = torch.arange(b * n_child, device=feat.device) % (b * n_parent)
        up = y.index_select(0, torch.where(valid, flat_c2p.long(), spread))
        up = torch.where(valid[:, None], up, torch.zeros_like(up))
        return (sk.float() + up.float()).reshape(b, n_child, -1)


class Embedding(nn.Module):
    """The stem: a 5^3 submanifold conv, BatchNorm and ReLU."""

    def __init__(self, in_channels: int, embed_channels: int, norm_fn):
        super().__init__()
        self.stem = nn.Sequential(OrderedDict(
            conv=SubMConv(in_channels, embed_channels, len(OFFSETS5)),
            norm=norm_fn(embed_channels)))

    def forward(self, feat, rules, flat_mask):
        y = self.stem.norm(self.stem.conv(feat, rules), flat_mask)
        return where_valid(flat_mask, F.relu(y))


@MODELS.register_module("PT-v3m1")
class PointTransformerV3(nn.Module):
    """``forward(input_dict, generator=None, condition=None)`` -> the
    decoder's features (B, N, dec_channels[0]), padded rows 0; with
    ``cls_mode`` a masked mean over the deepest level (B, enc_channels[-1]).
    The batch holds ``grid_coord`` (B, N, 3), ``feat`` and ``mask``;
    ``generator`` feeds the drop-path draws in training."""

    def __init__(self, in_channels: int = 6,
                 order: Sequence[str] = ("z", "z-trans", "hilbert", "hilbert-trans"),
                 stride: Sequence[int] = (2, 2, 2, 2),
                 enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
                 enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
                 enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
                 enc_patch_size: Sequence[int] = (48, 48, 48, 48, 48),
                 dec_depths: Sequence[int] = (2, 2, 2, 2),
                 dec_channels: Sequence[int] = (64, 64, 128, 256),
                 dec_num_head: Sequence[int] = (4, 4, 8, 16),
                 dec_patch_size: Sequence[int] = (48, 48, 48, 48),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, drop_path: float = 0.3,
                 pre_norm: bool = True, shuffle_orders: bool = True,
                 enable_rpe: bool = False, enable_flash: bool = True,
                 upcast_attention: bool = True, upcast_softmax: bool = True,
                 cls_mode: bool = False, pdnorm_bn: bool = False,
                 pdnorm_ln: bool = False, pdnorm_decouple: bool = True,
                 pdnorm_adaptive: bool = False, pdnorm_affine: bool = True,
                 pdnorm_conditions: Sequence[str] = (),
                 level_capacity_factor: float = 1.0, min_level_capacity: int = 128,
                 dense_extent=None, conv_window=None, conv_coverage_check=None):
        super().__init__()
        passed = [name for name, v in (("dense_extent", dense_extent),
                                       ("conv_window", conv_window),
                                       ("conv_coverage_check", conv_coverage_check))
                  if v is not None]
        if passed:
            raise NotImplementedError(
                f"PT-v3m1: {', '.join(passed)} (the TPU's dense-extent "
                "sorted-window convs) are not ported; the port takes the "
                "exact rulebook path")
        # values the JAX module ignores but that would change the result;
        # enable_flash, upcast_* and shuffle_orders are accepted as it accepts them
        unported = [name for name, bad in (
            ("qk_scale", qk_scale is not None), ("attn_drop", attn_drop > 0),
            ("proj_drop", proj_drop > 0), ("pre_norm", not pre_norm),
            ("stride", any(s != 2 for s in stride))) if bad]
        if unported:
            raise NotImplementedError(
                f"PT-v3m1: {', '.join(unported)} as given is not supported: the "
                "JAX package scales by head_dim ** -0.5, drops nothing in "
                "attention, normalises before each residual and pools by 2")
        num_stages = len(enc_depths)
        self.order = tuple(order)
        self.cls_mode = cls_mode
        self.level_capacity_factor = level_capacity_factor
        self.min_level_capacity = min_level_capacity
        conds = tuple(pdnorm_conditions)
        self.pd_conditions = conds if conds and (pdnorm_bn or pdnorm_ln) else ()
        norm_fn = _bn_factory(conds if pdnorm_bn else (), None, pdnorm_decouple,
                              pdnorm_adaptive, pdnorm_affine)
        if conds and pdnorm_ln:
            def ln_fn(c):
                return PDLayerNorm(c, conds, None, pdnorm_decouple, pdnorm_adaptive,
                                   pdnorm_affine)
        else:
            def ln_fn(c):
                return nn.LayerNorm(c, eps=LN_EPS)

        self.embedding = Embedding(in_channels, enc_channels[0], norm_fn)
        total = sum(enc_depths)
        enc_dp = [drop_path * i / max(total - 1, 1) for i in range(total)]
        self.enc = nn.Sequential()
        for s in range(num_stages):
            stage = nn.Sequential()
            if s > 0:
                stage.add_module("down", SerializedPooling(
                    enc_channels[s - 1], enc_channels[s], norm_fn))
            base = sum(enc_depths[:s])
            for i in range(enc_depths[s]):
                stage.add_module(f"block{i}", Block(
                    enc_channels[s], enc_num_head[s], enc_patch_size[s], mlp_ratio,
                    enc_dp[base + i], qkv_bias, enable_rpe, ln_fn))
            self.enc.add_module(f"enc{s}", stage)
        self.dec = None
        if not cls_mode:
            dec_ch = list(dec_channels) + [enc_channels[-1]]
            total = sum(dec_depths)
            dec_dp = [drop_path * i / max(total - 1, 1) for i in range(total)]
            self.dec = nn.Sequential()
            for s in reversed(range(num_stages - 1)):
                stage = nn.Sequential()
                stage.add_module("up", SerializedUnpooling(
                    dec_ch[s + 1], enc_channels[s], dec_ch[s], norm_fn))
                base = sum(dec_depths[:s])
                for i in range(dec_depths[s]):
                    stage.add_module(f"block{i}", Block(
                        dec_ch[s], dec_num_head[s], dec_patch_size[s], mlp_ratio,
                        dec_dp[base + i], qkv_bias, enable_rpe, ln_fn))
                self.dec.add_module(f"dec{s}", stage)

    def capacity(self, n_child: int) -> int:
        """A pooled level's parent slots: the JAX module's, a share of the
        child level's padded length rounded up to 8."""
        if self.level_capacity_factor >= 1.0:
            return n_child
        cap = max(self.min_level_capacity, int(n_child * self.level_capacity_factor))
        return min(-(-cap // 8) * 8, n_child)

    def index_maps(self, grid: torch.Tensor, mask: torch.Tensor) -> Dict[str, List]:
        """The voxel maps of a forward: each level's ``grid`` and ``mask``
        (level 0 the input), its 3^3 neighbour table ``nbr3``, the stem's
        5^3 table ``nbr5``, each stride's child -> parent map ``c2p`` and
        each level's curve sorts ``order`` / ``inverse`` (len(order), B, n),
        at the JAX module's level capacities.  Children whose parent
        overflowed a capacity are counted as dropped."""
        nbr5 = neighbor_table(grid, mask, OFFSETS5)
        maps = dict(grid=[grid.to(torch.int32)], mask=[mask], nbr5=nbr5,
                    nbr3=[nbr5[..., _SUB3]], c2p=[], order=[], inverse=[])
        for s in range(len(self.enc)):
            if s > 0:
                n_child = maps["mask"][-1].shape[1]
                cap = self.capacity(n_child)
                p_grid, p_mask, c2p = unique_parents(maps["grid"][-1], maps["mask"][-1],
                                                     2, capacity=cap)
                if cap < n_child:
                    count_dropped((maps["mask"][-1] & (c2p < 0)).sum())
                maps["grid"].append(p_grid)
                maps["mask"].append(p_mask)
                maps["c2p"].append(c2p)
                maps["nbr3"].append(neighbor_table(p_grid, p_mask, OFFSETS3))
            order, inverse = _sort_orders(maps["grid"][-1], maps["mask"][-1], self.order)
            maps["order"].append(order)
            maps["inverse"].append(inverse)
        return maps

    def forward(self, input_dict: Dict, generator=None,
                condition: Optional[str] = None) -> torch.Tensor:
        grid = input_dict["grid_coord"]
        mask = input_dict["mask"].to(torch.bool)
        b, n = mask.shape
        if self.pd_conditions:
            condition = condition or input_dict.get("condition_name")
            context = input_dict.get("context")
            for norm in self.modules():
                if isinstance(norm, (PDMaskedBatchNorm, PDLayerNorm)):
                    norm.condition, norm.context = condition, context
        check_grid_bound(grid, mask)
        maps = self.index_maps(grid, mask)
        levels = [Level(*(maps[key][s] for key in ("grid", "mask", "nbr3", "order",
                                                    "inverse")))
                  for s in range(len(maps["mask"]))]
        c2p = maps["c2p"]
        feat = self.embedding(input_dict["feat"].float().reshape(b * n, -1),
                              table_rulebook(flatten_neighbor_rows(maps["nbr5"])),
                              levels[0].flat_mask).reshape(b, n, -1)
        skips = []
        for s, stage in enumerate(self.enc):
            level = levels[s]
            blocks = list(stage.named_children())
            if s > 0:
                feat = stage.down(feat, c2p[s - 1], level.mask)
                blocks = blocks[1:]
            for i, (_, block) in enumerate(blocks):
                feat = block(feat, level, i % len(self.order), generator)
            skips.append(feat)
        if self.cls_mode:
            return masked_mean(feat, levels[-1].mask, dim=1)
        for name, stage in self.dec.named_children():
            s = int(name[len("dec"):])
            level = levels[s]
            feat = stage.up(feat, levels[s + 1].mask, skips[s], level.mask, c2p[s])
            for i, (_, block) in enumerate(list(stage.named_children())[1:]):
                feat = block(feat, level, i % len(self.order), generator)
        return where_valid(levels[0].mask, feat)
