"""K2's windows kernel (``csrc/fps.cu`` ``fps_windows_kernel``) in its order
of work, emulated in plain PyTorch, and ``fps_windows_plain`` against the
blocked call's window path before the kernel read its windows in place.

The emulation follows the kernel: one warp a window of g <= 1,024 slots,
lane l holding the consecutive slots l PPL + j (PPL = 8, 16 or 32 points a
lane), their running distances updated a round at a time from the last
pick's coordinates, the lane's best by a tree in slot order (the larger
distance wins, an equal one keeps the lower slot), then the warp's argmax:
the largest key (a valid distance's float bits + 1, a masked point 0),
then the lowest lane that holds it, whose best is the pick.  The windows
start, quota and validity come from the sample's valid count, as
``fps_windows_plain`` computes them.  No JAX and no card.
"""

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.ops import sampling
from pointcloudpdf_tpu_torch.ops.serialization import morton_sort_indices

SHAPES = [(256, 64), (512, 128), (1024, 128)]  # (g, k_g): PT-v1's and ST's windows
G = 4  # windows a sample


def key_of(d):
    """The kernel's argmax key: a valid (>= 0) distance's float bits + 1, a
    masked point (-inf) 0; as int64."""
    bits = d.contiguous().view(torch.int32).long()
    return torch.where(d >= 0, bits + 1, torch.zeros_like(bits))


def emulated_windows(sorted_coord, count, G, g, k_g):
    """(B, G k_g) positions as the windows kernel picks them."""
    B, N, _ = sorted_coord.shape
    ppl = 8 if g <= 256 else 16 if g <= 512 else 32
    n = 32 * ppl
    rows, valid = sampling._window_rows(count, G, g, N)           # (B, G, g)
    pad = n - g
    rows = torch.cat([rows, rows[..., :1].expand(-1, -1, pad)], -1)
    valid = torch.cat([valid, torch.zeros(B, G, pad, dtype=torch.bool)], -1)
    xyz = sorted_coord.gather(1, rows.reshape(B, G * n, 1).expand(-1, -1, 3))
    xyz = xyz.reshape(B * G, n, 3)
    xyz[:, g:] = 0.0                                              # past the window
    x, y, z = xyz.unbind(-1)
    dist = torch.where(valid.reshape(B * G, n), torch.tensor(1e10), torch.tensor(float("-inf")))
    W = B * G
    slot = torch.zeros(W, dtype=torch.long)
    picks = [slot]
    for _ in range(1, k_g):
        c = xyz[torch.arange(W), slot]                            # (W, 3)
        dx, dy, dz = x - c[:, :1], y - c[:, 1:2], z - c[:, 2:]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        # the lane's tree in slot order
        d = dist.reshape(W, 32, ppl).clone()
        jj = torch.arange(ppl).expand(W, 32, ppl).clone()
        step = 1
        while step < ppl:
            lo, hi = d[..., 0::2 * step], d[..., step::2 * step]
            take = hi > lo
            d[..., 0::2 * step] = torch.where(take, hi, lo)
            jj[..., 0::2 * step] = torch.where(take, jj[..., step::2 * step], jj[..., 0::2 * step])
            step *= 2
        key = key_of(d[..., 0])                                   # (W, 32)
        top = key.max(1, keepdim=True).values
        owner = torch.argmax((key == top).to(torch.int8), dim=1)  # the lowest such lane
        slot = owner * ppl + jj[torch.arange(W), owner, 0]
        picks.append(slot)
    picks = torch.stack(picks, 1).reshape(B, G, k_g)
    return rows.gather(2, picks).reshape(B, G * k_g)


def blocked_before(coord, m, mask, max_group_steps):
    """The blocked call as it was before its windows were read in place
    (G > 1): the window rows and validity built, the windows gathered, FPS
    over the gathered sets, the picks mapped back."""
    B, N, _ = coord.shape
    G_, g, k_g = sampling.window_shape(N, m, None, max_group_steps)
    order = morton_sort_indices(coord, mask)
    sorted_coord = coord.gather(1, order[..., None].expand(B, N, 3))
    v = mask.sum(dim=1)
    q = (v + G_ - 1) // G_
    ar_g, ar_s = torch.arange(G_), torch.arange(g)
    hi = torch.clamp(v - q, min=0)[:, None]
    starts = torch.minimum(torch.clamp(ar_g[None, :] * q[:, None], min=0), hi)
    window = starts[..., None] + ar_s
    local_valid = (ar_s[None, None, :] < q[:, None, None]) & (window < v[:, None, None])
    window = torch.clamp(window, 0, N - 1)
    coord_g = sorted_coord.gather(1, window.reshape(B, G_ * g, 1).expand(B, G_ * g, 3))
    picks = sampling.fps_sets_plain(coord_g.reshape(B * G_, g, 3),
                                    local_valid.reshape(B * G_, g), k_g)
    pos = window.gather(2, picks.reshape(B, G_, k_g)).reshape(B, m)
    idx = order.gather(1, pos)
    valid = mask.gather(1, idx)
    return idx, valid & ~sampling._flag_duplicates(pos)


def cloud(seed, g, k_g, ties):
    """Four samples of G windows of g slots: all valid; a masked tail (the
    last windows overlap); fewer valid points than picks in each window;
    none valid.  ``ties``: coordinates on a coarse grid and every 5th point
    a copy of its neighbour (exact ties, duplicates, zero distances)."""
    N = G * g
    valid = [N, N - g // 3 - 5, G * k_g // 2, 0]
    rng = np.random.RandomState(seed)
    coord = (rng.rand(4, N, 3) * np.array([4.0, 3.0, 2.0])).astype(np.float32)
    if ties:
        coord = (np.round(coord * 4) / 4).astype(np.float32)
        coord[:, 1::5] = coord[:, 0:-1:5]
    mask = np.arange(N)[None, :] < np.asarray(valid)[:, None]
    coord[~mask] = 0.0
    return torch.from_numpy(coord), torch.from_numpy(mask)


def test_argmax_key_rule():
    """The key keeps the order of valid distances, 0 and subnormals
    included, puts a masked point below all, and ties stay ties (the lowest
    lane then wins)."""
    d = torch.tensor([float("-inf"), 0.0, 1e-45, 1e-38, 0.5, 0.5, 1.0, 1e10])
    k = key_of(d)
    assert k[0] == 0 and (k[1:] > 0).all()
    assert (k[1:-1] <= k[2:]).all() and k[4] == k[5]
    assert ((k[1:, None] > k[None, 1:]) == (d[1:, None] > d[None, 1:])).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("g,k_g", SHAPES)
def test_emulated_kernel_matches_plain(g, k_g, ties):
    """The kernel's order of work picks ``fps_windows_plain``'s positions."""
    coord, mask = cloud(g + k_g, g, k_g, ties)
    order = morton_sort_indices(coord, mask)
    sorted_coord = coord.gather(1, order[..., None].expand(-1, -1, 3))
    count = mask.sum(1, dtype=torch.int32)
    want = sampling.fps_windows_plain(sorted_coord, count, G, g, k_g)
    got = emulated_windows(sorted_coord, count, G, g, k_g)
    assert torch.equal(got, want)
    # the empty sample picks its window starts
    assert (want[3] == 0).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("g,k_g", SHAPES)
def test_blocked_call_unchanged(g, k_g, ties):
    """``blocked_farthest_point_sampling`` through ``fps_windows`` gives the
    window path's indices and flags as before, duplicates flagged where a
    window has fewer valid points than picks."""
    coord, mask = cloud(3 * g + k_g, g, k_g, ties)
    m = G * k_g
    steps = k_g
    assert sampling.window_shape(G * g, m, None, steps) == (G, g, k_g)
    idx, valid = sampling.blocked_farthest_point_sampling(coord, m, mask, max_group_steps=steps)
    bidx, bvalid = blocked_before(coord, m, mask, steps)
    assert torch.equal(idx, bidx) and torch.equal(valid, bvalid)
    assert not valid[2].all() and not valid[3].any()
