"""Voxel keys, voxel-grid parents and the sparse-conv rulebook (counterpart
of ``pointcloudpdf_tpu/ops/voxel.py``).

A sparse tensor is a padded list: ``grid`` (B, N, 3) non-negative integer
voxel coordinates and ``mask`` (B, N).  Keys pack as x(20) y(20) z(20)
bits in int64, the invalid key above every valid one.  The JAX package
packs x(11) y(11) z(10) bits into uint32 and wraps past 2,048 cells in x
or y, which a LiDAR scan at 5 cm reaches (Waymo clips at +-75.2 m, 3,008
cells; nuScenes clips nowhere).  Both packings order keys x-major,
lexicographically, so inside the JAX budget every sort, slot and table
here is the JAX one's.  ``check_grid_bound`` holds a grid to a bit budget
(this one by default).  Window ids that are compared with the JAX
package's values keep its layout (``pack_grid32``, ``KEY32_BITS``).

The JAX ``neighbor_table`` looks voxels up in a multi-round scatter hash
(``build_hash_table`` / ``lookup_hash``), a TPU workaround that leaves
about 1e-4 of the keys unplaced.  The port builds the exact table of that
package's ``build_table`` / ``lookup``: a sample's keys sorted once, every
offset query binary-searched.  The dense-extent forms (``raster_sort``,
``unique_parents_sorted``, ``build_occupancy``, ``neighbor_table_dense``)
are not ported.

``gather_conv`` runs over a ``Rulebook``, the compacted (in row, out row)
pairs of each kernel offset: absent neighbours gather nothing, and the
backward of its gather is a scatter-add.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

KEY_BITS = (20, 20, 20)
X_BITS, Y_BITS, Z_BITS = KEY_BITS
GRID_LIMITS = tuple(1 << b for b in KEY_BITS)
INVALID_KEY = 1 << sum(KEY_BITS)
# the JAX package's uint32 layout
KEY32_BITS = (11, 11, 10)
# offset queries a chunk of ``neighbor_table`` (its int64 temporaries)
QUERY_CHUNK = 1 << 23


def _pack(grid: torch.Tensor, bits) -> torch.Tensor:
    g = grid.long()
    return (g[..., 0] << (bits[1] + bits[2])) | (g[..., 1] << bits[2]) | g[..., 2]


def pack_grid(grid: torch.Tensor) -> torch.Tensor:
    """(..., 3) non-negative integer voxel coords in [0, 2^20) -> (...)
    int64 keys."""
    return _pack(grid, KEY_BITS)


def pack_grid32(grid: torch.Tensor) -> torch.Tensor:
    """(..., 3) coords in [0, 2048) x [0, 2048) x [0, 1024) -> (...) int64
    keys of the JAX package's uint32 values (x 11, y 11, z 10 bits)."""
    return _pack(grid, KEY32_BITS)


def check_grid_bound(grid: torch.Tensor, mask: torch.Tensor, bits=KEY_BITS) -> None:
    """Raise ``ValueError`` unless every valid voxel of ``grid`` lies in
    the bit budget ``bits`` (x, y, z; by default the keys', [0, 2^20) an
    axis).  One host synchronisation."""
    limits = tuple(1 << b for b in bits)
    m = mask.to(torch.bool)[..., None]
    g = torch.where(m, grid, torch.zeros_like(grid)).reshape(-1, 3)
    lo, hi = torch.stack([g.amin(0), g.amax(0)]).tolist()
    if min(lo) < 0 or any(h >= lim for h, lim in zip(hi, limits)):
        raise ValueError(
            f"voxel grid from {tuple(lo)} to {tuple(hi)} (extent "
            f"{tuple(h - l + 1 for l, h in zip(lo, hi))} cells) is outside "
            f"{' x '.join(f'[0, {lim})' for lim in limits)}, the voxel keys' "
            f"x {bits[0]}, y {bits[1]}, z {bits[2]} bits")


def unique_parents(grid: torch.Tensor, mask: torch.Tensor, stride: int,
                   capacity: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dedup ``grid // stride`` per sample at a fixed ``capacity`` (default
    N).  grid (B, N, 3) non-negative ints, mask (B, N) bool ->
    (parent_grid (B, cap, 3) int32, parent_mask (B, cap) bool,
    child_to_parent (B, N) int32).

    The first P slots hold a sample's P parent voxels sorted by key; each
    valid child maps to its parent's slot, padding to -1.  Where P exceeds
    the capacity the parents of the largest keys are dropped and their
    children map to -1 too.  Slot for slot the JAX function's result.
    """
    n = grid.shape[1]
    cap = n if capacity is None else min(capacity, n)
    parent = torch.div(grid.long(), stride, rounding_mode="floor")
    invalid = torch.full_like(mask, INVALID_KEY, dtype=torch.int64)
    keys = torch.where(mask, pack_grid(parent), invalid)
    sorted_keys = keys.sort(dim=-1).values
    first = torch.ones_like(mask)
    first[:, 1:] = sorted_keys[:, 1:] != sorted_keys[:, :-1]
    first &= sorted_keys != INVALID_KEY
    # the unique keys, ascending, then the invalid ones
    parent_keys = torch.where(first, sorted_keys, invalid).sort(dim=-1).values
    parent_keys = parent_keys[:, :cap].contiguous()
    parent_mask = parent_keys != INVALID_KEY
    parent_grid = torch.stack([parent_keys >> (Y_BITS + Z_BITS),
                               (parent_keys >> Z_BITS) & ((1 << Y_BITS) - 1),
                               parent_keys & ((1 << Z_BITS) - 1)], dim=-1)
    parent_grid = torch.where(parent_mask[..., None], parent_grid,
                              torch.zeros_like(parent_grid)).to(torch.int32)
    # a child finds its slot by binary search; the children of dropped
    # parents miss the truncated table
    pos = torch.clamp(torch.searchsorted(parent_keys, keys.contiguous()), 0, cap - 1)
    hit = (parent_keys.gather(1, pos) == keys) & mask
    child_to_parent = torch.where(hit, pos, torch.full_like(pos, -1))
    return parent_grid, parent_mask, child_to_parent.to(torch.int32)


_DROPPED: Dict[torch.device, torch.Tensor] = {}


def capacity_dropped_points(reset: bool = False) -> int:
    """Valid points that a level capacity dropped (PT-v2's ``GridPool``,
    SpUNet's strided convs), summed over every forward since the last reset
    (the JAX package's ``capacity_dropped_points`` diagnostic);
    synchronises."""
    total = sum(int(t) for t in _DROPPED.values())
    if reset:
        _DROPPED.clear()
    return total


def count_dropped(n: torch.Tensor) -> None:
    """Add ``n`` to the drop count: a device-side sum, no synchronisation."""
    with torch.inference_mode(False), torch.no_grad():
        acc = _DROPPED.get(n.device)
        if acc is None:
            acc = _DROPPED[n.device] = torch.zeros((), dtype=torch.long,
                                                   device=n.device)
        acc += n.detach()


def kernel_offsets(kernel_size: int = 3) -> np.ndarray:
    """(kernel_size^3, 3) int32 offsets, centred, in the JAX package's
    ``itertools.product`` order (dz fastest)."""
    r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    return np.asarray(list(itertools.product(r, r, r)), np.int32)


def neighbor_table(grid: torch.Tensor, mask: torch.Tensor, offsets) -> torch.Tensor:
    """(B, N, K) int32: per sample, the row of the voxel at each kernel
    offset of each voxel, -1 where none is (a padded row, a query outside
    the bit budget, an empty cell).

    The exact table: a sample's keys sorted (stably, so of two rows in one
    cell the lower is found) and every query binary-searched, the JAX
    ``build_table`` + ``lookup``; the JAX ``neighbor_table`` gives the same
    rows wherever its hash placed every key.
    """
    b, n = mask.shape
    off = torch.as_tensor(np.asarray(offsets), dtype=torch.int64, device=grid.device)
    limits = torch.tensor(GRID_LIMITS, dtype=torch.int64, device=grid.device)
    g = grid.long()
    keys = torch.where(mask, pack_grid(g), torch.full_like(g[..., 0], INVALID_KEY))
    table, rows = keys.sort(dim=-1, stable=True)
    step = max(1, QUERY_CHUNK // max(b * n, 1))
    cols = []
    for k0 in range(0, off.shape[0], step):
        q = g[:, :, None, :] + off[k0:k0 + step]                 # (B, N, k, 3)
        ok = mask[..., None] & ((q >= 0) & (q < limits)).all(-1)
        qk = pack_grid(q).reshape(b, -1)
        pos = torch.searchsorted(table, qk).clamp_(max=n - 1)
        hit = (table.gather(1, pos) == qk) & ok.reshape(b, -1)
        found = torch.where(hit, rows.gather(1, pos), torch.full_like(pos, -1))
        cols.append(found.reshape(b, n, -1))
    return torch.cat(cols, dim=2).to(torch.int32)


def flatten_neighbor_rows(nbr: torch.Tensor) -> torch.Tensor:
    """(B, N, K) per-sample rows -> (B*N, K) rows into the flat array."""
    b, n, k = nbr.shape
    base = (torch.arange(b, dtype=nbr.dtype, device=nbr.device) * n)[:, None, None]
    return torch.where(nbr >= 0, nbr + base, torch.full_like(nbr, -1)).reshape(b * n, k)


def flatten_slot_map(idx: torch.Tensor, slot_count: Optional[int] = None
                     ) -> torch.Tensor:
    """(B, N) per-sample slots -> (B*N,) flat slots (-1 kept);
    ``slot_count`` is the per-sample size of the target array (default N)."""
    b, n = idx.shape
    stride = n if slot_count is None else slot_count
    base = (torch.arange(b, dtype=idx.dtype, device=idx.device) * stride)[:, None]
    return torch.where(idx >= 0, idx + base, torch.full_like(idx, -1)).reshape(b * n)


class Rulebook(NamedTuple):
    """A sparse conv's pairs, grouped by kernel offset: output row
    ``out_rows[p]`` takes ``feat[in_rows[p]] @ W[k]``, the first
    ``counts[0]`` pairs at offset 0, the next ``counts[1]`` at offset 1, and
    so on (host ints); ``n_out`` output rows."""

    in_rows: torch.Tensor
    out_rows: torch.Tensor
    counts: Tuple[int, ...]
    n_out: int


def table_rulebook(nbr: torch.Tensor) -> Rulebook:
    """A submanifold conv's rulebook from its (M, K) neighbour table:
    the pairs (nbr[m, k], m) of the present neighbours, by offset, then by
    output row.  Two host synchronisations."""
    m, k = nbr.shape
    flat = nbr.t().reshape(-1)
    sel = torch.nonzero(flat >= 0).squeeze(1)
    counts = torch.bincount(sel // m, minlength=k).tolist()
    return Rulebook(flat.index_select(0, sel).long(), sel % m, tuple(counts), m)


def map_rulebooks(child_to_parent: torch.Tensor, pos: torch.Tensor,
                  num_parents: int, num_offsets: int = 8
                  ) -> Tuple[Rulebook, Rulebook]:
    """The rulebooks of a strided conv and of its inverse from the flat
    (M,) child -> parent map (-1 absent) and each child's kernel position
    ``pos`` in [0, num_offsets): down, a child into its parent; up, its
    parent into the child.  Two host synchronisations."""
    keys = torch.where(child_to_parent >= 0, pos.long(),
                       torch.full_like(pos, num_offsets, dtype=torch.long))
    counts = torch.bincount(keys, minlength=num_offsets + 1).tolist()[:num_offsets]
    child = torch.argsort(keys, stable=True)[:sum(counts)]
    parent = child_to_parent.index_select(0, child).long()
    return (Rulebook(child, parent, tuple(counts), num_parents),
            Rulebook(parent, child, tuple(counts), child_to_parent.shape[0]))


def gather_conv(feat: torch.Tensor, nbr, weights: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k feat[nbr[i, k]] @ W[k] over the present neighbours.

    feat (M, C_in); ``nbr`` an (M, K) table with -1 sentinels or its
    ``Rulebook`` (any rulebook: ``map_rulebooks`` gives the strided convs');
    weights (K, C_in, C_out).  One gather of the pairs' rows, a GEMM an
    offset on its slice, one scatter-add into f32 rows (an output row
    takes its offsets in order, as the JAX scan adds them; f32 at least);
    memory O(pairs C).  Returns the output in ``feat``'s dtype.
    """
    rules = nbr if isinstance(nbr, Rulebook) else table_rulebook(nbr)
    w = weights.to(feat.dtype)
    gathered = feat.index_select(0, rules.in_rows)
    parts = [part @ w_k for part, w_k, count in
             zip(gathered.split(rules.counts), w.unbind(0), rules.counts) if count]
    y = torch.cat(parts) if parts else gathered.new_zeros((0, w.shape[-1]))
    acc = torch.promote_types(y.dtype, torch.float32)
    out = torch.zeros((rules.n_out, w.shape[-1]), dtype=acc, device=feat.device)
    return out.index_add(0, rules.out_rows, y.to(acc)).to(feat.dtype)


def depthwise_conv(feat: torch.Tensor, rules: Rulebook, weight: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k feat[nbr[i, k]] * w[k] over the present neighbours, a
    depthwise conv: feat (M, C), weight (K, C).  One gather of the pairs'
    rows, each offset's slice scaled by its weight row, one scatter-add into
    f32 rows (an output row takes its offsets in order, as the JAX scan adds
    them).  Returns the output in ``feat``'s dtype."""
    w = weight.to(feat.dtype)
    gathered = feat.index_select(0, rules.in_rows)
    parts = [part * w_k for part, w_k, count in
             zip(gathered.split(rules.counts), w.unbind(0), rules.counts) if count]
    y = torch.cat(parts) if parts else gathered
    acc = torch.promote_types(y.dtype, torch.float32)
    out = torch.zeros((rules.n_out, feat.shape[-1]), dtype=acc, device=feat.device)
    return out.index_add(0, rules.out_rows, y.to(acc)).to(feat.dtype)


# absent children's rows: segments of their own past the parents, this
# many, so that no one segment is long
_ABSENT_SEGMENTS = 1024


def scatter_mean_to_parent(feat: torch.Tensor, child_to_parent: torch.Tensor,
                           num_parents: int) -> torch.Tensor:
    """Mean-pool child features (M, C) onto ``num_parents`` slots by the
    flat child -> parent map (-1 absent); empty slots 0.

    A parent's children are added in row order (a stable sort by parent,
    then a segment sum), on the card as on the CPU: atomic adds (``index_add``,
    ``scatter_add``) take them in any order there, and a pooled coordinate's
    last bit then differs from one forward to the next and can flip a kNN
    tie at the next level."""
    m = child_to_parent.shape[0]
    spread = num_parents + torch.arange(m, device=feat.device) % _ABSENT_SEGMENTS
    key = torch.where(child_to_parent >= 0, child_to_parent.long(), spread)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=num_parents + _ABSENT_SEGMENTS)
    summed = torch.segment_reduce(feat.index_select(0, order), "sum", lengths=counts,
                                  axis=0)[:num_parents]
    return summed / torch.clamp(counts[:num_parents, None].to(feat.dtype), min=1.0)
