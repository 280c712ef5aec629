"""Neighbourhood geometry over padded point batches: kNN (kernel K1),
ball query, grouping and inverse-distance interpolation.

Counterpart of ``pointcloudpdf_tpu/ops/geometry.py`` (``knn`` with its
exact contract, ``ball_query``, ``grouping``, ``interpolation``), batched over a leading
sample axis instead of vmapped.  The TPU dispatch tiers of the JAX ``knn``
(serialization windows, approximate top-k, split Pallas) are not ported:
on the card two exact kernels serve every size.

K1 (csrc/knn.cu) replaces ``knn_pallas`` / ``_knn_pallas_pruned``
(pointcloudpdf_tpu/ops/pallas_knn.py): a brute-force kernel for ref sets
below ``KNN_PRUNE_MIN_REFS`` points and, at or above it, the bound-pruned
kernel over the z-order plan of ``knn_plan``; the source note says what
bounds each on the card.  ``knn_plain`` is their plain PyTorch version: the
same squared distance ``(dx*dx + dy*dy) + dz*dz`` over element-wise ops, so
on the card each agrees with it bit for bit in ``dist2`` and in ``idx`` up
to exact ties.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda
from .serialization import morton_codes

KNN_LAUNCHES = 0  # knn calls that launched K1 since the last reset
KNN_PRUNED_LAUNCHES = 0  # of those, calls that took the bound-pruned kernel
KNN_BRUTE_LAUNCHES = 0  # of those, calls that took the brute-force kernel
# ref sets of at least this many points take the bound-pruned kernel, smaller
# ones the brute-force kernel (PERF.md, the K1 rows, gives the times that set it)
KNN_PRUNE_MIN_REFS = 8192
KNN_TILE = 32  # sorted queries a tile of the pruned kernel: one warp
_KNN_BOX_PARTS = 32  # csrc/knn.cu kBoxParts: blocks a sample in the box pass
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
        if N >= KNN_PRUNE_MIN_REFS:
            return knn_pruned_cuda(query, ref, k, ref_mask, query is ref)[:2]
        return knn_brute_cuda(query, ref, k, ref_mask)
    return knn_plain(query, ref, k, ref_mask)


def _kernel_inputs(query, ref, k, ref_mask):
    if k > 64:
        raise ValueError(f"knn kernel takes k <= 64, got {k}")
    query = query.float().contiguous()
    ref = ref.float().contiguous()
    ref_mask = ref_mask.to(torch.bool).contiguous()
    _cuda.expect_cuda("knn", query, ref, ref_mask)
    B, M, _ = query.shape
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
    dist2 = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
    return query, ref, ref_mask, idx, dist2


def knn_brute_cuda(query, ref, k, ref_mask, lanes=0):
    """K1's brute-force kernel: every query against every ref, ``lanes``
    lanes a query (a power of two up to 32; 0: ``knn_lanes``'s choice)."""
    global KNN_LAUNCHES, KNN_BRUTE_LAUNCHES
    if lanes not in (0, 1, 2, 4, 8, 16, 32):
        raise ValueError(f"knn brute-force kernel takes 0 or 1-32 lanes (a power of two), "
                         f"got {lanes}")
    query, ref, ref_mask, idx, dist2 = _kernel_inputs(query, ref, k, ref_mask)
    B, M, _ = query.shape
    err = _cuda.library().pcpdf_knn_brute(
        query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(), B, M, ref.shape[1],
        k, lanes, idx.data_ptr(), dist2.data_ptr(), ctypes.c_void_p(_cuda.stream_of(query)))
    _cuda.check(err, "pcpdf_knn_brute")
    KNN_LAUNCHES += 1
    KNN_BRUTE_LAUNCHES += 1
    return idx, dist2


def knn_lanes(B: int, M: int) -> int:
    """The lanes a query the brute-force kernel takes for B samples of M
    queries on this card: the fewest (a power of two, 1 to 32) that give
    its grid 4 warps an SM (csrc/knn.cu, ``brute_lanes``)."""
    return int(_cuda.library().pcpdf_knn_lanes(B, M))


def knn_chunk(n_refs: int) -> int:
    """Sorted refs a chunk of the pruned kernel for a ref set of ``n_refs``
    points: finer chunks prune more, but each warp keeps one bound a chunk
    in shared memory and rescans its share of them at every visit (PERF.md,
    the K1 rows, gives the times that set these steps)."""
    return 64 if n_refs <= 1 << 15 else 128 if n_refs <= 1 << 17 else 256


def knn_pruned_cuda(query, ref, k, ref_mask, same=False, visits=False, chunk=None):
    """K1's bound-pruned kernel over the plan of ``knn_plan`` (``same``: the
    queries are the refs).  Returns (idx, dist2, visits): with ``visits``
    an int32 (B, ceil(M / 32) + 1) count of the chunks each tile of
    ``knn_tiles`` visited, else None.  ``chunk`` defaults to
    ``knn_chunk(N)``."""
    global KNN_LAUNCHES, KNN_PRUNED_LAUNCHES
    query, ref, ref_mask, idx, dist2 = _kernel_inputs(query, ref, k, ref_mask)
    B, M, _ = query.shape
    chunk = chunk or knn_chunk(ref.shape[1])
    plan = knn_plan(query, ref, ref_mask, same, chunk)
    counts = (torch.zeros((B, -(-M // KNN_TILE) + 1), dtype=torch.int32,
                          device=query.device) if visits else None)
    err = _cuda.library().pcpdf_knn_pruned(
        query.data_ptr(), plan.query_order.data_ptr(), plan.ref_sorted.data_ptr(),
        plan.chunk_box.data_ptr(), plan.sub_box.data_ptr(), plan.n_valid.data_ptr(),
        int(same), B, M, ref.shape[1], k, chunk, idx.data_ptr(), dist2.data_ptr(),
        counts.data_ptr() if visits else None, ctypes.c_void_p(_cuda.stream_of(query)))
    _cuda.check(err, "pcpdf_knn_pruned")
    KNN_LAUNCHES += 1
    KNN_PRUNED_LAUNCHES += 1
    return idx, dist2, counts


class KnnPlan(NamedTuple):
    """What the bound-pruned kernel reads.  An order holds flat indices,
    ``b * N + i`` for point i of sample b, as one sort over every sample
    gives them."""

    ref_order: torch.Tensor  # (B, N) int64: refs in morton order, masked last
    query_order: torch.Tensor  # (B, M) int64: queries in morton order
    ref_sorted: torch.Tensor  # (B, N, 4) f32: xyz, original index (int32 bits)
    chunk_box: torch.Tensor  # (B, ceil(N / chunk), 6) f32: lo xyz, hi xyz
    sub_box: torch.Tensor  # (B, ceil(N / chunk) * chunk / 32, 6): each run of 32
    n_valid: torch.Tensor  # (B,) int32: valid refs


def knn_plan(query, ref, ref_mask, same=False, chunk=None) -> KnnPlan:
    """The bound-pruned kNN's plan: refs ordered by morton code (masked
    last, ``serialization.morton_codes``), queries by their own code (the
    refs' order when ``same``), the sorted refs with their original index,
    and each chunk of ``chunk`` (default ``knn_chunk(N)``) sorted refs, and
    each run of 32 of them, with the bounding box of its valid refs (+inf /
    -inf when it has none).  Each order is one stable sort of
    ``b << 32 | code`` over all samples.  On CUDA tensors the keys and the
    chunks come from K1's prep kernels; elsewhere (or under
    ``_cuda.plain_versions()``) from their plain versions, with the same
    values.  Under the profiler its work is the range ``K1 prep``."""
    query, ref = query.float().contiguous(), ref.float().contiguous()
    ref_mask = ref_mask.to(torch.bool).contiguous()
    B, N, _ = ref.shape
    chunk = chunk or knn_chunk(N)
    kernel = _cuda.use_kernel(ref)
    # the range costs host time on every call, so only while profiling
    scope = (torch.profiler.record_function("K1 prep")
             if torch.autograd._profiler_enabled() else contextlib.nullcontext())
    with scope:
        stream = ctypes.c_void_p(_cuda.stream_of(ref)) if kernel else None
        if kernel:
            ref_keys, n_valid = _keys_cuda(ref, ref_mask, stream)
        else:
            ref_keys = _keys_plain(ref, ref_mask)
            n_valid = ref_mask.sum(dim=1, dtype=torch.int32)
        ref_order = torch.sort(ref_keys.view(-1), stable=True).indices.view(B, N)
        if same:
            query_order = ref_order
        else:
            query_keys = (_keys_cuda(query, None, stream)[0] if kernel else
                          _keys_plain(query, torch.ones_like(query[..., 0], dtype=torch.bool)))
            query_order = torch.sort(query_keys.view(-1), stable=True).indices.view(query.shape[:2])
        if kernel:
            ref_sorted, chunk_box, sub_box = _chunks_cuda(ref, ref_mask, ref_order, chunk, stream)
        else:
            ref_sorted, chunk_box, sub_box = _chunks_plain(ref, ref_mask, ref_order, chunk)
    return KnnPlan(ref_order, query_order, ref_sorted, chunk_box, sub_box, n_valid)


def _keys_plain(xyz, mask):
    B = xyz.shape[0]
    sample = torch.arange(B, dtype=torch.int64, device=xyz.device) << 32
    return morton_codes(xyz, mask) | sample[:, None]


def _keys_cuda(xyz, mask, stream):
    B, N, _ = xyz.shape
    part = torch.empty((B, _KNN_BOX_PARTS, 8), dtype=torch.float32, device=xyz.device)
    keys = torch.empty((B, N), dtype=torch.int64, device=xyz.device)
    n_valid = torch.empty((B,), dtype=torch.int32, device=xyz.device)
    err = _cuda.library().pcpdf_knn_codes(
        xyz.data_ptr(), None if mask is None else mask.data_ptr(), B, N,
        part.data_ptr(), keys.data_ptr(), n_valid.data_ptr(), stream)
    _cuda.check(err, "pcpdf_knn_codes")
    return keys, n_valid


def _chunks_cuda(ref, ref_mask, order, chunk, stream):
    B, N, _ = ref.shape
    n_chunks = -(-N // chunk)
    ref_sorted = torch.empty((B, N, 4), dtype=torch.float32, device=ref.device)
    chunk_box = torch.empty((B, n_chunks, 6), dtype=torch.float32, device=ref.device)
    sub_box = torch.empty((B, n_chunks * chunk // KNN_TILE, 6), dtype=torch.float32,
                          device=ref.device)
    err = _cuda.library().pcpdf_knn_chunks(
        ref.data_ptr(), ref_mask.data_ptr(), order.data_ptr(), B, N, chunk,
        ref_sorted.data_ptr(), chunk_box.data_ptr(), sub_box.data_ptr(), stream)
    _cuda.check(err, "pcpdf_knn_chunks")
    return ref_sorted, chunk_box, sub_box


def _chunks_plain(ref, ref_mask, order, chunk):
    B, N, _ = ref.shape
    perm = order - torch.arange(B, device=order.device)[:, None] * N
    xyz = ref.float().gather(1, perm[..., None].expand(B, N, 3))
    valid = ref_mask.to(torch.bool).gather(1, perm)[..., None]
    index_bits = perm.to(torch.int32).view(torch.float32)[..., None]
    ref_sorted = torch.cat([xyz, index_bits], dim=-1)
    pad = -N % chunk
    inf = torch.tensor(float("inf"), device=ref.device)
    lo = torch.nn.functional.pad(torch.where(valid, xyz, inf), (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(torch.where(valid, xyz, -inf), (0, 0, 0, pad), value=float("-inf"))
    lo = lo.view(B, -1, KNN_TILE, 3).amin(dim=2)
    hi = hi.view(B, -1, KNN_TILE, 3).amax(dim=2)
    runs = chunk // KNN_TILE
    chunk_box = torch.cat([lo.view(B, -1, runs, 3).amin(dim=2),
                           hi.view(B, -1, runs, 3).amax(dim=2)], dim=-1)
    return ref_sorted, chunk_box, torch.cat([lo, hi], dim=-1)


def box_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lower bound on ``dist2`` between any point of box ``a`` and any
    point of box ``b`` (each (..., 6): lo xyz, hi xyz), with the kernel's
    rounding: per axis ``gap = max(0, lo_a - hi_b, lo_b - hi_a)``, then
    ``(gx*gx + gy*gy) + gz*gz`` in f32.  Rounding is monotone, so the bound
    never exceeds the ``dist2`` of such a pair."""
    gap = torch.clamp(torch.maximum(a[..., :3] - b[..., 3:], b[..., :3] - a[..., 3:]), min=0)
    g2 = gap * gap
    return (g2[..., 0] + g2[..., 1]) + g2[..., 2]


def knn_tiles(M, n_valid, same):
    """The pruned kernel's tiles of one sample: (start, end) ranges of its
    sorted query positions, ceil(M / 32) + 1 of them (``tile_rows`` in
    csrc/knn.cu).  With ``same`` the valid queries (the first ``n_valid``
    of the refs' order) and the masked ones take tiles of their own; a
    spare tile is empty."""
    split = n_valid if same else M
    head = -(-split // KNN_TILE)
    rows = []
    for t in range(-(-M // KNN_TILE) + 1):
        p0 = t * KNN_TILE if t < head else split + (t - head) * KNN_TILE
        rows.append((p0, max(p0, min(p0 + KNN_TILE, split if t < head else M))))
    return rows


def knn_deferred(sorted_query, tiles):
    """(M,) bool over sorted positions: the queries the pruned kernel does
    not search itself, because they equal every query back to the one
    before their tile; the tile holding their run's start writes their
    rows."""
    M = sorted_query.shape[0]
    eq = torch.zeros(M, dtype=torch.bool)
    eq[1:] = (sorted_query[1:] == sorted_query[:-1]).all(-1)
    deferred = torch.zeros(M, dtype=torch.bool)
    for p0, p1 in tiles:
        for p in range(p0, p1):
            if not eq[p]:
                break
            deferred[p] = True
    return deferred


def knn_tile_bounds(query, plan: KnnPlan, same=False):
    """What the pruned kernel forms in each warp, as plain tensors: the
    deferred queries (B, M) over sorted positions (``knn_deferred``), the
    box of every tile of ``knn_tiles`` over its other queries (B, tiles, 6;
    +inf / -inf where it has none) and its bound to every chunk (B, tiles,
    chunks).  Dense, so for small sets (tests)."""
    B, M, _ = query.shape
    q = query.float().reshape(B * M, 3)[plan.query_order]
    boxes = torch.empty((B, -(-M // KNN_TILE) + 1, 6))
    boxes[..., :3], boxes[..., 3:] = float("inf"), float("-inf")
    deferred = torch.zeros((B, M), dtype=torch.bool)
    for b in range(B):
        tiles = knn_tiles(M, int(plan.n_valid[b]), same)
        deferred[b] = knn_deferred(q[b], tiles)
        for t, (p0, p1) in enumerate(tiles):
            rows = q[b, p0:p1][~deferred[b, p0:p1]]
            if len(rows):
                boxes[b, t, :3] = rows.amin(0)
                boxes[b, t, 3:] = rows.amax(0)
    return deferred, boxes, box_bound(boxes[:, :, None], plan.chunk_box[:, None])


def knn_plain(query, ref, k, ref_mask):
    """Plain PyTorch version of K1, chunked over query tiles so no (M, N)
    matrix larger than 2**26 elements exists (a dense one at a
    131072-point bucket would be 68 GB).  In f32 the k smallest (dist2,
    index) pairs in lexicographic order, as the kernels take them: of two
    refs at an exact tie the lower index comes first (``topk`` leaves the
    order of ties open, and on CUDA a tie at the k-th place can swap a
    neighbour)."""
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
            if d.dtype == torch.float32:
                # an f32 distance's bits order as it does (d >= 0): one
                # int64 key a (dist2, index) pair
                key = (d.view(torch.int32).long() << 32) | torch.arange(
                    N, dtype=torch.int64, device=d.device)
                key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
                ids = key & 0xFFFFFFFF
                vals = (key >> 32).to(torch.int32).view(torch.float32)
            else:  # a float64 pass (the tests' float64 gradients)
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
