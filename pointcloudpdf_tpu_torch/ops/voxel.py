"""Voxel key packing (counterpart of ``pointcloudpdf_tpu/ops/voxel.py``
``pack_grid``; the sparse-conv tables of that module are not ported yet).

Keys pack as x(11) y(11) z(10) bits, the JAX package's uint32 layout, held
here in int64 (the same values: equality and order carry over).
"""

from __future__ import annotations

import torch

X_BITS, Y_BITS, Z_BITS = 11, 11, 10


def pack_grid(grid: torch.Tensor) -> torch.Tensor:
    """(..., 3) non-negative integer voxel coords -> (...) int64 keys."""
    g = grid.long()
    return ((g[..., 0] << (Y_BITS + Z_BITS)) | (g[..., 1] << Z_BITS)
            | g[..., 2])
