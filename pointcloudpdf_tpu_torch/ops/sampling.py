"""Farthest point sampling (kernel K2): exact and morton-blocked.

Counterpart of ``pointcloudpdf_tpu/ops/sampling.py``
(``farthest_point_sampling``, ``blocked_farthest_point_sampling`` with its
exact ``G == 1`` branch, ``downsample_count``), batched over a leading
sample axis.  Both modes reduce to exact FPS over a batch of point sets:
the samples themselves (exact mode) or every sample's morton windows
(blocked mode, as ``TransitionDown`` calls it).  K2 (csrc/fps.cu, replacing
``farthest_point_sampling_pallas`` in pointcloudpdf_tpu/ops/pallas_fps.py;
its source note says what bounds it on the card) has two kernels:
``fps_sets`` runs whole sets through the block kernel, and ``fps_windows``
runs the blocked mode's windows through the windows kernel, which reads
each window's rows of the sorted sample in place.  ``fps_sets_plain`` and
``fps_windows_plain`` are their plain PyTorch versions, with the same
distance arithmetic and the same first-index argmax, so the kernels and
the plain versions pick the same indices.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _cuda
from .serialization import morton_sort_indices

FPS_LAUNCHES = 0  # K2 launches (either kernel) since the last reset
_SMEM_POINTS = 8192  # csrc/fps.cu kSmemPoints: larger sets need scratch
FPS_WINDOW_MAX = 1024  # csrc/fps.cu kWindowMax: larger windows take fps_sets


def fps_sets(xyz: torch.Tensor, mask: torch.Tensor, m: int) -> torch.Tensor:
    """Exact FPS of m points in each of S sets; starts at index 0.

    xyz (S, n, 3) float, mask (S, n) bool -> (S, m) int64 set-local
    indices.  Masked points are never picked while a valid one is left;
    past the valid count the picks repeat valid points."""
    if _cuda.use_kernel(xyz):
        return _fps_sets_cuda(xyz, mask, m)
    return fps_sets_plain(xyz, mask, m)


def _fps_sets_cuda(xyz, mask, m):
    global FPS_LAUNCHES
    xyz = xyz.float().contiguous()
    mask = mask.to(torch.bool).contiguous()
    _cuda.expect_cuda("fps", xyz, mask)
    S, n, _ = xyz.shape
    out = torch.empty((S, m), dtype=torch.int32, device=xyz.device)
    scratch = (torch.empty((S, 4 * n), dtype=torch.float32, device=xyz.device)
               if n > _SMEM_POINTS else None)
    err = _cuda.library().pcpdf_fps(
        xyz.data_ptr(), mask.data_ptr(), S, n, m,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        ctypes.c_void_p(_cuda.stream_of(xyz)))
    _cuda.check(err, "pcpdf_fps")
    FPS_LAUNCHES += 1
    return out.long()


def fps_sets_plain(xyz, mask, m):
    """Plain PyTorch version of K2: m rounds, vectorised over the sets."""
    xyz = xyz.float()
    S, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.where(mask.to(torch.bool),
                       torch.tensor(1e10, dtype=torch.float32, device=xyz.device),
                       torch.tensor(float("-inf"), device=xyz.device))
    out = torch.zeros((S, m), dtype=torch.int64, device=xyz.device)
    last = out[:, 0]
    for r in range(1, m):
        lx = x.gather(1, last[:, None])
        ly = y.gather(1, last[:, None])
        lz = z.gather(1, last[:, None])
        dx, dy, dz = x - lx, y - ly, z - lz
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(dist, dim=1)
        out[:, r] = last
    return out


def fps_windows(sorted_coord: torch.Tensor, valid_count: torch.Tensor,
                G: int, g: int, k_g: int) -> torch.Tensor:
    """Exact FPS of k_g points in each of the G morton windows of g slots
    of every sample; each window starts at its first slot.

    sorted_coord (B, N, 3) float, the samples in morton order with their
    valid points first; valid_count (B,) int -> (B, G k_g) int64, the
    picks' positions in the sorted order (see ``_window_rows``)."""
    if _cuda.use_kernel(sorted_coord):
        if g > FPS_WINDOW_MAX:  # the block kernel over gathered windows
            return _gathered_windows(sorted_coord, valid_count, G, g, k_g,
                                     _fps_sets_cuda)
        return _fps_windows_cuda(sorted_coord, valid_count, G, g, k_g)
    return fps_windows_plain(sorted_coord, valid_count, G, g, k_g)


def _fps_windows_cuda(sorted_coord, valid_count, G, g, k_g):
    global FPS_LAUNCHES
    sorted_coord = sorted_coord.float().contiguous()
    count = valid_count.to(torch.int32).contiguous()
    _cuda.expect_cuda("fps_windows", sorted_coord, count)
    B, N, _ = sorted_coord.shape
    pos = torch.empty((B, G * k_g), dtype=torch.int64, device=sorted_coord.device)
    err = _cuda.library().pcpdf_fps_windows(
        sorted_coord.data_ptr(), count.data_ptr(), B, N, G, g, k_g,
        pos.data_ptr(), ctypes.c_void_p(_cuda.stream_of(sorted_coord)))
    _cuda.check(err, "pcpdf_fps_windows")
    FPS_LAUNCHES += 1
    return pos


def _window_rows(valid_count, G, g, N):
    """Window gi of a sample with v valid points covers the sorted slots
    start + s, s < g, where q = ceil(v / G) and start = min(gi q,
    max(v - q, 0)): (rows (B, G, g) clamped to N - 1, valid (B, G, g),
    true where s < q and start + s < v)."""
    v = valid_count.long()
    q = (v + G - 1) // G                                          # quota
    ar_g = torch.arange(G, device=v.device)
    ar_s = torch.arange(g, device=v.device)
    hi = torch.clamp(v - q, min=0)[:, None]
    starts = torch.minimum(torch.clamp(ar_g[None, :] * q[:, None], min=0), hi)
    window = starts[..., None] + ar_s                             # (B, G, g)
    local_valid = (ar_s[None, None, :] < q[:, None, None]) & (
        window < v[:, None, None])
    return torch.clamp(window, 0, N - 1), local_valid


def _gathered_windows(sorted_coord, valid_count, G, g, k_g, sets):
    """The windows gathered into (B G, g, 3) sets, FPS by ``sets``, the
    picks mapped back to their sorted positions."""
    B, N, _ = sorted_coord.shape
    window, local_valid = _window_rows(valid_count, G, g, N)
    coord_g = sorted_coord.gather(
        1, window.reshape(B, G * g, 1).expand(B, G * g, 3))
    picks = sets(coord_g.reshape(B * G, g, 3), local_valid.reshape(B * G, g), k_g)
    return window.gather(2, picks.reshape(B, G, k_g)).reshape(B, G * k_g)


def fps_windows_plain(sorted_coord, valid_count, G, g, k_g):
    """Plain PyTorch version of the windows kernel: the windows gathered,
    then ``fps_sets_plain``."""
    return _gathered_windows(sorted_coord.float(), valid_count, G, g, k_g,
                             fps_sets_plain)


def farthest_point_sampling(coord: torch.Tensor, m: int,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Exact FPS of m points per sample: coord (B, N, 3) -> (B, m) int64."""
    if mask is None:
        mask = torch.ones(coord.shape[:2], dtype=torch.bool, device=coord.device)
    return fps_sets(coord, mask, m)


def _flag_duplicates(key: torch.Tensor) -> torch.Tensor:
    """(B, m) -> bool, True at every repeat of an earlier (in stable sorted
    order) equal key."""
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    dup_sorted = torch.zeros_like(sorted_key, dtype=torch.bool)
    dup_sorted[:, 1:] = sorted_key[:, 1:] == sorted_key[:, :-1]
    return torch.zeros_like(dup_sorted).scatter(1, order, dup_sorted)


def window_shape(N: int, m: int, num_groups: Optional[int] = None,
                 max_group_steps: int = 128) -> Tuple[int, int, int]:
    """The blocked mode's windows for m picks of N padded points: (G
    windows, g = N / G slots, k_g = m / G picks each); G is ceil(m /
    max_group_steps) (or ``num_groups``), lowered until it divides m and
    N."""
    if num_groups is None:
        num_groups = max(1, -(-m // max_group_steps))
    while m % num_groups != 0 or N % num_groups != 0:
        num_groups -= 1
    return num_groups, N // num_groups, m // num_groups


def blocked_farthest_point_sampling(
    coord: torch.Tensor,
    m: int,
    mask: Optional[torch.Tensor] = None,
    num_groups: Optional[int] = None,
    max_group_steps: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Morton-blocked FPS: (idx (B, m) int64, valid (B, m) bool).

    Points sort along the z-order curve with masked points last; the valid
    prefix is covered by G windows of N/G sorted slots each, and exact FPS
    picks m/G points in every window.  Duplicate picks (possible when a
    sample has fewer than m valid points) are flagged invalid.  With a
    single group this is exact FPS in index order (the reference kernel's
    order, starting at point 0).
    """
    B, N, _ = coord.shape
    coord = coord.float()
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=coord.device)
    mask = mask.to(torch.bool)
    G, g_size, k_g = window_shape(N, m, num_groups, max_group_steps)

    if G == 1:
        idx = farthest_point_sampling(coord, m, mask)
        valid = mask.gather(1, idx)
        return idx, valid & ~_flag_duplicates(idx)

    order = morton_sort_indices(coord, mask)                      # (B, N)
    sorted_coord = coord.gather(1, order[..., None].expand(B, N, 3))
    pos = fps_windows(sorted_coord, mask.sum(dim=1, dtype=torch.int32), G,
                      g_size, k_g)                                # (B, m)
    idx = order.gather(1, pos)
    valid = mask.gather(1, idx)
    return idx, valid & ~_flag_duplicates(pos)


def downsample_count(valid_count: torch.Tensor, stride: int) -> torch.Tensor:
    """Per-sample downsampled valid count (reference ``n_o = o // stride``)."""
    return torch.clamp(valid_count // stride, min=1)
