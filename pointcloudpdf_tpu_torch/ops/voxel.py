"""Voxel keys and voxel-grid parents (counterpart of
``pointcloudpdf_tpu/ops/voxel.py`` ``pack_grid`` and ``unique_parents``;
the sparse-conv tables of that module are not ported yet).

Keys pack as x(11) y(11) z(10) bits, the JAX package's uint32 layout, held
here in int64 (the same values: equality and order carry over); the
invalid key lies above every valid one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

X_BITS, Y_BITS, Z_BITS = 11, 11, 10
INVALID_KEY = 1 << 32


def pack_grid(grid: torch.Tensor) -> torch.Tensor:
    """(..., 3) non-negative integer voxel coords -> (...) int64 keys."""
    g = grid.long()
    return ((g[..., 0] << (Y_BITS + Z_BITS)) | (g[..., 1] << Z_BITS)
            | g[..., 2])


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
