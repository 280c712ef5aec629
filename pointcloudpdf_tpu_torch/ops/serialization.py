"""Space-filling-curve serialization of padded point sets: z-order (morton)
and Hilbert codes.

Counterpart of ``pointcloudpdf_tpu/ops/serialization.py`` (morton_encode,
morton_sort_indices, hilbert_encode, serialize_code), used by blocked FPS to
cut a sample into spatially coherent windows, by the bound-pruned kNN (K1)
to cut it into compact chunks and by PT-v3 to order its patches.  PyTorch
has no uint32 arithmetic, so the 30-bit codes live in int64; the masked
sentinel 0xFFFFFFFF still sorts after every code, and ``stable=True``
repeats ``jnp.argsort``'s order on equal codes.  Coordinates clip to 10
bits an axis, as in the JAX package: past 1023 a coordinate becomes 1023.
"""

from __future__ import annotations

import torch

MORTON_BITS = 10  # bits per axis; 3 * 10 = 30-bit codes
_INVALID = 0xFFFFFFFF


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x with 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode(grid_coord: torch.Tensor) -> torch.Tensor:
    """(..., 3) non-negative integer coords -> (...,) int64 z-order codes;
    values are clipped to [0, 2**10 - 1]."""
    g = grid_coord.to(torch.int64).clamp(0, (1 << MORTON_BITS) - 1)
    return (_part1by2(g[..., 0]) | (_part1by2(g[..., 1]) << 1)
            | (_part1by2(g[..., 2]) << 2))


def hilbert_encode(grid_coord: torch.Tensor, bits: int = MORTON_BITS) -> torch.Tensor:
    """(..., 3) non-negative integer coords -> (...,) int64 Hilbert-curve
    codes (Skilling's axes -> transpose transform, then the transposed bits
    interleaved, axis 0 most significant of each triple); values clipped to
    ``bits`` bits.  Code for code the JAX ``hilbert_encode``."""
    g = grid_coord.to(torch.int64).clamp(0, (1 << bits) - 1)
    x = [g[..., 0], g[..., 1], g[..., 2]]
    for shift in range(bits - 1, 0, -1):
        q = 1 << shift
        p = q - 1
        for i in range(3):
            hit = (x[i] & q) != 0
            # invert x[0]'s low bits, or exchange the low bits of x[0] and x[i]
            t = (x[0] ^ x[i]) & p
            x0 = torch.where(hit, x[0] ^ p, x[0] ^ t)
            if i != 0:
                x[i] = torch.where(hit, x[i], x[i] ^ t)
            x[0] = x0
    # Gray encode
    x[1] = x[1] ^ x[0]
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[0])
    for shift in range(bits - 1, 0, -1):
        q = 1 << shift
        t = torch.where((x[2] & q) != 0, t ^ (q - 1), t)
    x = [xi ^ t for xi in x]
    return (_part1by2(x[0]) << 2) | (_part1by2(x[1]) << 1) | _part1by2(x[2])


def serialize_code(grid_coord: torch.Tensor, order: str = "z") -> torch.Tensor:
    """(..., 3) int grid -> (...,) int64 code of the named curve order:
    ``z``, ``z-trans`` (x and y swapped), ``hilbert``, ``hilbert-trans``
    (``_`` for ``-`` too), the reference's names."""
    order = order.replace("_", "-")
    if order.endswith("-trans"):
        grid_coord = grid_coord[..., [1, 0, 2]]
        order = order[: -len("-trans")]
    if order == "z":
        return morton_encode(grid_coord)
    if order == "hilbert":
        return hilbert_encode(grid_coord)
    raise NotImplementedError(f"unknown serialization order: {order}")


def morton_codes(coord: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample z-order codes, masked points at the sentinel 0xFFFFFFFF.

    coord (B, N, 3) float, mask (B, N) bool -> (B, N) int64.  The grid is
    the sample's valid bounding box quantised as ``(coord - cmin) *
    (1023 / extent)`` in float32, exactly as the JAX package does (PyTorch
    takes ``1023 / extent`` as ``reciprocal(extent) * 1023``; the kNN
    kernel's prep in ``csrc/knn.cu`` repeats that rounding).
    """
    coord = coord.float()
    m3 = mask[..., None]
    inf = torch.tensor(float("inf"), device=coord.device)
    cmin = torch.where(m3, coord, inf).amin(dim=-2, keepdim=True)
    cmax = torch.where(m3, coord, -inf).amax(dim=-2, keepdim=True)
    extent = torch.clamp((cmax - cmin).amax(dim=-1, keepdim=True), min=1e-6)
    scale = ((1 << MORTON_BITS) - 1) / extent
    g = torch.clamp((coord - cmin) * scale, 0, (1 << MORTON_BITS) - 1)
    code = morton_encode(g.to(torch.int32))
    return torch.where(mask, code, torch.full_like(code, _INVALID))


def morton_sort_indices(coord: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample permutation sorting points by morton code (``morton_codes``),
    masked last: coord (B, N, 3) float, mask (B, N) bool -> (B, N) int64."""
    return torch.argsort(morton_codes(coord, mask), dim=-1, stable=True)

