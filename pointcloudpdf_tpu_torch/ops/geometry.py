"""Neighbourhood geometry over padded point batches: kNN (kernel K1),
ball query, grouping and inverse-distance interpolation.

Counterpart of ``pointcloudpdf_tpu/ops/geometry.py`` (``knn`` with its
exact contract, ``ball_query``, ``grouping``, ``interpolation``), batched over a leading
sample axis instead of vmapped.  The TPU dispatch tiers of the JAX ``knn``
(serialization windows, approximate top-k, split Pallas) are not ported:
on the card one exact kernel serves every size.

K1 (csrc/knn.cu) replaces ``knn_pallas`` / ``_knn_pallas_pruned``
(pointcloudpdf_tpu/ops/pallas_knn.py); its source note says what bounds it
on the card and how it is built.  ``knn_plain`` is its plain PyTorch
version: the same squared distance ``(dx*dx + dy*dy) + dz*dz`` over
element-wise ops, so on the card the two agree bit for bit in ``dist2``
and in ``idx`` up to exact ties.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _cuda

KNN_LAUNCHES = 0  # K1 launches since the last reset
_PLAIN_TILE_ELEMS = 1 << 26  # knn_plain: largest (queries x refs) block


def knn(
    query: torch.Tensor,
    ref: torch.Tensor,
    k: int,
    ref_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid refs of every query, per sample.

    query (B, M, 3), ref (B, N, 3), ref_mask (B, N) bool ->
    (idx (B, M, k) int32, dist2 (B, M, k) float32), ascending.  Slots past
    the valid refs hold ``dist2 == inf`` and repeat the nearest index (0
    when the sample has no valid ref), so every index is a safe gather row.
    With ``k > N`` the N found are padded with the nearest neighbour at
    +inf, as the JAX package does.
    """
    B, M, _ = query.shape
    N = ref.shape[1]
    if ref_mask is None:
        ref_mask = torch.ones((B, N), dtype=torch.bool, device=ref.device)
    if k > N:
        idx, dist2 = knn(query, ref, N, ref_mask)
        pad_idx = idx[..., :1].expand(B, M, k - N)
        pad_d = torch.full((B, M, k - N), float("inf"), device=dist2.device)
        return torch.cat([idx, pad_idx], -1), torch.cat([dist2, pad_d], -1)
    if _cuda.use_kernel(query):
        return _knn_cuda(query, ref, k, ref_mask)
    return knn_plain(query, ref, k, ref_mask)


def _knn_cuda(query, ref, k, ref_mask):
    global KNN_LAUNCHES
    if k > 64:
        raise ValueError(f"knn kernel takes k <= 64, got {k}")
    query = query.float().contiguous()
    ref = ref.float().contiguous()
    ref_mask = ref_mask.to(torch.bool).contiguous()
    _cuda.expect_cuda("knn", query, ref, ref_mask)
    B, M, _ = query.shape
    N = ref.shape[1]
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
    dist2 = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
    err = _cuda.library().pcpdf_knn(
        query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(), B, M, N, k,
        idx.data_ptr(), dist2.data_ptr(),
        ctypes.c_void_p(_cuda.stream_of(query)))
    _cuda.check(err, "pcpdf_knn")
    KNN_LAUNCHES += 1
    return idx, dist2


def knn_plain(query, ref, k, ref_mask):
    """Plain PyTorch version of K1, chunked over query tiles so no (M, N)
    matrix larger than 2**26 elements exists (a dense one at a
    131072-point bucket would be 68 GB)."""
    query = query.float()
    ref = ref.float()
    B, M, _ = query.shape
    N = ref.shape[1]
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
    dist2 = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
    tile = max(1, _PLAIN_TILE_ELEMS // max(N, 1))
    for b in range(B):
        r = ref[b]
        invalid = ~ref_mask[b].to(torch.bool)
        for q0 in range(0, M, tile):
            q = query[b, q0:q0 + tile]
            dx = r[None, :, 0] - q[:, None, 0]
            dy = r[None, :, 1] - q[:, None, 1]
            dz = r[None, :, 2] - q[:, None, 2]
            d = (dx * dx + dy * dy) + dz * dz
            d.masked_fill_(invalid[None, :], float("inf"))
            vals, ids = torch.topk(d, k, dim=1, largest=False, sorted=True)
            idx[b, q0:q0 + tile] = ids.to(torch.int32)
            dist2[b, q0:q0 + tile] = vals
    finite = torch.isfinite(dist2)
    first = torch.where(finite[..., :1], idx[..., :1], torch.zeros_like(idx[..., :1]))
    idx = torch.where(finite, idx, first)
    return idx, dist2


def ball_query(
    query: torch.Tensor,
    ref: torch.Tensor,
    radius: float,
    k: int,
    ref_mask: Optional[torch.Tensor] = None,
    min_radius: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to k neighbours within [min_radius, radius] of every query, as a
    masked kNN: the k nearest valid refs are found (K1), then those outside
    the annulus are invalidated.

    Returns (idx (B, M, k) int32, neighbour_mask (B, M, k) bool); invalid
    slots repeat the query's first index, so every index is a safe gather
    row.
    """
    idx, dist2 = knn(query, ref, k, ref_mask)
    inside = (dist2 <= radius * radius) & (dist2 >= min_radius * min_radius)
    inside &= torch.isfinite(dist2)
    return torch.where(inside, idx, idx[..., :1]), inside


def divide_exact(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as an IEEE division on every device.  For a Python
    scalar divisor PyTorch's CUDA kernel multiplies by the reciprocal, which
    is off by an ulp where the CPU (and the JAX package) divide: enough to
    flip a ``floor`` at a bin or window boundary.  A tensor divisor on
    ``x``'s device takes the true division."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def gather_rows(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    b = torch.arange(feat.shape[0], device=feat.device).view(-1, 1, 1)
    return feat[b, idx.long()]


def grouping(
    feat: torch.Tensor,
    idx: torch.Tensor,
    coord: Optional[torch.Tensor] = None,
    new_coord: Optional[torch.Tensor] = None,
    with_coord: bool = False,
) -> torch.Tensor:
    """Gather neighbour features (B, M, K, C); with ``with_coord`` prepend
    the relative positions ``coord[idx] - new_coord``."""
    grouped = gather_rows(feat, idx)
    if with_coord:
        rel = gather_rows(coord, idx) - new_coord[:, :, None, :]
        grouped = torch.cat([rel, grouped], dim=-1)
    return grouped


def interpolation(
    src_coord: torch.Tensor,
    dst_coord: torch.Tensor,
    src_feat: torch.Tensor,
    k: int = 3,
    src_mask: Optional[torch.Tensor] = None,
    dst_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
) -> torch.Tensor:
    """k-NN inverse-distance-weighted upsampling of src_feat onto dst_coord
    (weights 1/d normalised to sum 1; +inf slots weigh 0)."""
    idx, dist2 = knn(dst_coord, src_coord, k, ref_mask=src_mask)
    valid = torch.isfinite(dist2)
    w = 1.0 / (torch.sqrt(torch.clamp(dist2, min=0.0)) + eps)
    w = torch.where(valid, w, torch.zeros_like(w))
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=eps)
    return (gather_rows(src_feat, idx) * w[..., None]).sum(dim=-2)
