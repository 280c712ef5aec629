"""The order of work of K1's brute-force kernel (``knn_brute_kernel`` in
csrc/knn.cu), emulated in PyTorch on the CPU.

The kernel compacts a sample's valid refs into shared memory (passes of
4 consecutive refs a thread, a warp scan of the counts, a block scan of
the warps' totals), lets a group of G lanes serve each query (lane l takes
the compacted refs j = l (mod G), 4 a step), visits the steps from the
warp's home (its first query's share of the queries) in strides coprime
with their count, keeps a top-K_MAX a lane sorted by (dist2, index)
behind two gates (not after the lane's last entry, not farther than the
group's gate), queues the candidates that pass, inserts a warp's queues
when one of them might overflow and then renews the group's gate (the
r-th least over the lanes of each lane's m-th distance, m = min(k,
ceil(2k / G)), r = ceil(k / m)), and merges the G lists in k rounds of a
group-wide minimum by (dist2, index).  Sets too large for shared memory
go through in tiles.  Emulated here step for step, vectorised over the
queries, on clustered, planar, duplicate-heavy, partly masked, all-masked
and fewer-valid-than-k clouds, the result must equal a lexicographic brute
force exactly, dist2 and idx.

No JAX: the kernel has no JAX counterpart to hold it against; its oracle is
the lexicographic brute force (``knn_plain`` up to the order of exact ties).
"""

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.ops import geometry

THREADS = 256  # csrc/knn.cu kBruteThreads
COMPACT_REFS = 4  # kCompactRefs
UNROLL = 4  # kUnroll
QUEUE = 8  # kQueue


def _clustered(rng, n):
    centers = rng.uniform(0, 8, size=(12, 3)) * [1.0, 1.0, 0.4]
    return centers[rng.randint(0, 12, size=n)] + rng.normal(scale=0.25, size=(n, 3))


def _planar(rng, n):
    pts = rng.uniform(0, 4, size=(n, 3))
    pts[:, 2] = 0.75  # a floor: one axis constant
    return pts


def _duplicates(rng, n):
    # a coarse grid: many refs at one point and many equal distances
    base = np.round(_clustered(rng, n // 6) * 2.0) / 2.0
    return np.repeat(base, 6, axis=0)[rng.permutation(n)][:n]


def _cloud(rng, make, B, n, valid, drop=0.0):
    """(B, n, 3) coords, (B, n) mask: sample b's first valid[b] points are
    real, the tail zero and masked; ``drop`` masks a share of the rest."""
    coord = np.zeros((B, n, 3), np.float32)
    mask = np.zeros((B, n), bool)
    for b, v in enumerate(valid):
        coord[b, :v] = make(rng, max(v, 6))[:v]
        mask[b, :v] = rng.uniform(size=v) >= drop
    return torch.from_numpy(coord), torch.from_numpy(mask)


def _cases():
    """(name, query, ref, ref_mask, k) on seeded clouds."""
    rng = np.random.RandomState(0)
    out = []
    ref, mask = _cloud(rng, _clustered, 2, 220, [220, 170])
    out.append(("clustered self", ref, ref, mask))
    ref, mask = _cloud(rng, _planar, 1, 280, [280])
    query = torch.from_numpy(_planar(rng, 64).astype(np.float32))[None]
    out.append(("planar cross", query, ref, mask))
    ref, mask = _cloud(rng, _duplicates, 1, 240, [240])
    out.append(("duplicates self", ref, ref, mask))
    ref, mask = _cloud(rng, _clustered, 2, 320, [320, 260], drop=0.4)
    query = ref[:, ::5].contiguous()
    out.append(("partly masked cross", query, ref, mask))
    ref, mask = _cloud(rng, _clustered, 3, 120, [120, 0, 5])
    out.append(("all-masked sample, fewer valid than k", ref, ref, mask))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _dist2(query, ref):
    """(M, n) squared distances in the kernel's association."""
    dx = ref[None, :, 0] - query[:, None, 0]
    dy = ref[None, :, 1] - query[:, None, 1]
    dz = ref[None, :, 2] - query[:, None, 2]
    return (dx * dx + dy * dy) + dz * dz


def _compact(mask):
    """The kernel's compaction of one sample's mask: passes of THREADS x
    COMPACT_REFS refs, a thread's count, the warp's inclusive scan, the
    block's scan of the warps' totals; returns the original index of every
    compacted slot."""
    n = mask.shape[0]
    slots = torch.full((int(mask.sum()),), -1, dtype=torch.long)
    base = 0
    for c0 in range(0, n, THREADS * COMPACT_REFS):
        flags = torch.zeros(THREADS * COMPACT_REFS, dtype=torch.long)
        part = mask[c0:c0 + THREADS * COMPACT_REFS].long()
        flags[:len(part)] = part
        per_thread = flags.view(THREADS, COMPACT_REFS)
        cnt = per_thread.sum(1)
        incl = cnt.view(-1, 32).cumsum(1).view(-1)  # the warp's inclusive scan
        totals = incl.view(-1, 32)[:, -1]
        before = (totals.cumsum(0) - totals).repeat_interleave(32)
        pos = base + before + incl - cnt
        for t in range(THREADS):
            p = int(pos[t])
            for u in range(COMPACT_REFS):
                if per_thread[t, u]:
                    slots[p] = c0 + t * COMPACT_REFS + u
                    p += 1
        base += int(totals.sum())
    return slots


def _before(d, j, bd, bi):
    """(d, j) before (bd, bj) by (dist2, index)."""
    return (d < bd) | ((d == bd) & (j < bi))


def _insert(bd, bi, d, j, tau):
    """One candidate a (query, lane) into the lists sorted by (dist2,
    index), where it comes before the list's last entry and is not farther
    than ``tau``."""
    ok = _before(d, j, bd[..., -1], bi[..., -1]) & ~(d > tau[:, None])
    pos = (~_before(d[..., None], j[..., None], bd, bi)).sum(-1, keepdim=True)
    slot = torch.arange(bd.shape[-1])
    shifted_d = torch.cat([bd[..., :1], bd[..., :-1]], -1)
    shifted_i = torch.cat([bi[..., :1], bi[..., :-1]], -1)
    new_d = torch.where(slot < pos, bd, torch.where(slot == pos, d[..., None], shifted_d))
    new_i = torch.where(slot < pos, bi, torch.where(slot == pos, j[..., None], shifted_i))
    return torch.where(ok[..., None], new_d, bd), torch.where(ok[..., None], new_i, bi)


def _visit_stride(steps):
    """csrc/knn.cu visit_stride: near the golden section, coprime with steps."""
    p = max(1, int(np.float32(0.618034) * np.float32(steps)))
    while np.gcd(p, steps) != 1:
        p -= 1
    return p


def _group_gate(bd, k):
    """The r-th least over the lanes of each lane's m-th distance."""
    G = bd.shape[1]
    m = min(k, -(-2 * k // G))
    r = -(-k // m)
    assert r <= G and r * m >= k
    return torch.sort(bd[:, :, m - 1], dim=1).values[:, r - 1]


def _emulate(query, ref, mask, k, K_MAX, G, tile=None):
    """The kernel on one sample: (idx (M, k), dist2 (M, k)).  ``tile``:
    raw refs a tile (the streamed path), else the whole set at once."""
    M, N = query.shape[0], ref.shape[0]
    bd = torch.full((M, G, K_MAX), float("inf"))
    bi = torch.full((M, G, K_MAX), -1, dtype=torch.long)
    tau = torch.full((M,), float("inf"))
    # each thread's queue; a warp is 32 / G consecutive queries of a block
    qd = torch.zeros((M, G, QUEUE))
    qi = torch.zeros((M, G, QUEUE), dtype=torch.long)
    qn = torch.zeros((M, G), dtype=torch.long)
    warp = torch.arange(M) // max(1, 32 // G)
    first_q = warp * max(1, 32 // G)  # each query's warp's first query

    def flush(bd, bi, qn, which):
        for t in range(int(qn.max())):
            take = which & (t < qn)
            nd, ni = _insert(bd, bi, qd[..., t], qi[..., t], tau)
            bd = torch.where(take[..., None], nd, bd)
            bi = torch.where(take[..., None], ni, bi)
        return bd, bi, torch.where(which, torch.zeros_like(qn), qn)

    for t0 in range(0, N, tile or N):
        t1 = min(N, t0 + (tile or N))
        slots = _compact(mask[t0:t1]) + t0
        n = len(slots)
        d_all = _dist2(query, ref[slots])
        stride = UNROLL * G
        steps = -(-n // stride)
        if steps == 0:
            continue
        jump = _visit_stride(steps)
        home = torch.clamp(first_q * steps // M, max=steps - 1)
        for s in range(steps):
            at = (home + s * jump) % steps  # each query's warp's step
            g = torch.minimum(bd[..., -1], tau[:, None])
            for u in range(UNROLL):
                j = at[:, None] * stride + u * G + torch.arange(G)[None]
                inside = j < n
                jc = j.clamp(max=n - 1)
                d = torch.where(inside, d_all.gather(1, jc), torch.tensor(float("inf")))
                # d < next_up(g): d <= g, or d < g where g is +inf
                ok = torch.where(torch.isinf(g), d < g, d <= g)
                at_slot = torch.nn.functional.one_hot(qn.clamp(max=QUEUE - 1), QUEUE).bool()
                at_slot &= ok[..., None]
                qd = torch.where(at_slot, d[..., None], qd)
                qi = torch.where(at_slot, slots[jc][..., None], qi)
                qn = qn + ok.long()
            full = (qn > QUEUE - UNROLL).any(1)
            if bool(full.any()):
                hit = torch.isin(warp, warp[full])
                bd, bi, qn = flush(bd, bi, qn, hit[:, None].expand(M, G))
                tau = torch.where(hit, _group_gate(bd, k), tau)
    bd, bi, qn = flush(bd, bi, qn, torch.ones((M, G), dtype=torch.bool))
    # k rounds of the group's least head by (dist2, index)
    idx = torch.empty((M, k), dtype=torch.long)
    dist2 = torch.empty((M, k))
    first = torch.zeros(M, dtype=torch.long)
    rows = torch.arange(M)
    for r in range(k):
        hd, hi = bd[:, :, 0], bi[:, :, 0]
        order = torch.argsort(hi, dim=1, stable=True)
        lane = order.gather(1, torch.argsort(hd.gather(1, order), dim=1, stable=True))[:, 0]
        md, mi = hd[rows, lane], hi[rows, lane]
        found = torch.isfinite(md)
        if r == 0:
            first = torch.where(found, mi, first)
        idx[:, r] = torch.where(found, mi, first)
        dist2[:, r] = md
        pop = found[:, None] & (torch.arange(G)[None] == lane[:, None])
        popped_d = torch.cat([bd[..., 1:], torch.full_like(bd[..., :1], float("inf"))], -1)
        popped_i = torch.cat([bi[..., 1:], torch.full_like(bi[..., :1], -1)], -1)
        bd = torch.where(pop[..., None], popped_d, bd)
        bi = torch.where(pop[..., None], popped_i, bi)
    return idx, dist2


def _lexicographic(query, ref, mask, k):
    """The k least (dist2, index) pairs of every query over the valid refs;
    slots past them +inf, repeating the nearest index (0 when none)."""
    d = torch.where(mask[None], _dist2(query, ref), torch.tensor(float("inf")))
    j = torch.arange(ref.shape[0]).expand_as(d)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]  # stable: lower index first
    dist2, idx = d.gather(1, order), j.gather(1, order)
    fin = torch.isfinite(dist2)
    first = torch.where(fin[:, :1], idx[:, :1], torch.zeros_like(idx[:, :1]))
    return torch.where(fin, idx, first), dist2


@pytest.mark.parametrize("G", [1, 4, 32])
@pytest.mark.parametrize("K_MAX,k", [(4, 3), (16, 16), (64, 40)])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_kernel_equals_lexicographic_brute_force(case, K_MAX, k, G):
    _, query, ref, mask = case
    for b in range(query.shape[0]):
        idx, dist2 = _emulate(query[b], ref[b], mask[b], k, K_MAX, G)
        want_idx, want_d2 = _lexicographic(query[b], ref[b], mask[b], k)
        assert torch.equal(dist2, want_d2)
        assert torch.equal(idx, want_idx)


@pytest.mark.parametrize("G", [1, 8])
def test_emulated_tiles_equal_the_whole_set(G):
    """The streamed path: tiles of 128 raw refs, the lists and the group's
    gate carried across them."""
    _, query, ref, mask = CASES[3]
    idx, dist2 = _emulate(query[0], ref[0], mask[0], 16, 16, G, tile=128)
    want_idx, want_d2 = _lexicographic(query[0], ref[0], mask[0], 16)
    assert torch.equal(dist2, want_d2) and torch.equal(idx, want_idx)


def test_compaction_keeps_index_order():
    """Across passes and warps the compacted slots are the valid refs in
    ascending order."""
    rng = np.random.RandomState(3)
    mask = torch.from_numpy(rng.uniform(size=2600) < 0.6)
    assert torch.equal(_compact(mask), mask.nonzero().flatten())
    assert len(_compact(torch.zeros(50, dtype=torch.bool))) == 0


def test_group_gate_never_drops_a_neighbour():
    """The gate is at least the k-th distance of the refs seen so far (so at
    least the final k-th): with it the lists keep every true neighbour."""
    _, query, ref, mask = CASES[0]
    q, r = query[0], ref[0]
    for G, K_MAX, k in ((4, 16, 16), (32, 4, 3), (8, 64, 40), (1, 16, 9), (2, 4, 3),
                        (16, 16, 16), (32, 64, 64)):
        bd = torch.sort(torch.rand((q.shape[0], G, K_MAX)), dim=-1).values
        gate = _group_gate(bd, k)
        kth = torch.sort(bd.flatten(1), dim=1).values[:, k - 1]
        assert bool((gate >= kth).all())
    idx, dist2 = _emulate(q, r, mask[0], 16, 16, 32)
    want = geometry.knn_plain(q[None], r[None], 16, mask[:1])[1][0]
    assert torch.equal(dist2, want)
