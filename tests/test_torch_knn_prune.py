"""The pruning rule of K1's bound-pruned kernel, on the CPU.

``geometry.knn_plan`` (the z-order orders, the sorted refs, the chunk
boxes) and ``geometry.knn_tile_bounds`` (the tile boxes and their bounds to
every chunk, f32 in the kernel's association) are what the kernel reads and
forms.  On seeded clouds shaped to stress them (clustered, a wall with one
axis constant, duplicate points, masked tails, an all-masked sample, fewer
valid refs than k, a zero-padded query tail) these tests hold:

- the orders are permutations, masked refs last;
- no bound exceeds the ``dist2`` of a pair it covers, bit for bit, so no
  chunk holding a true neighbour of ``knn_plain`` is ever skipped;
- the kernel's visit rule (ascending bound, stop at the first chunk whose
  bound is strictly above the largest k-th distance of the tile, a warp
  skipping a chunk none of its queries can use, insertion by (dist2, index))
  emulated here in plain PyTorch gives ``knn_plain``'s result exactly.

No JAX: the kernel has no JAX counterpart to hold it against; its oracle is
``knn_plain``.
"""

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.ops import geometry

def _clustered(rng, n):
    centers = rng.uniform(0, 8, size=(12, 3)) * [1.0, 1.0, 0.4]
    return centers[rng.randint(0, 12, size=n)] + rng.normal(scale=0.25, size=(n, 3))


def _wall(rng, n):
    pts = rng.uniform(0, 4, size=(n, 3))
    pts[:, 0] = 1.5  # one axis constant
    return pts


def _duplicates(rng, n):
    base = _clustered(rng, n // 4)
    return np.repeat(base, 4, axis=0)[rng.permutation(n)]


def _batch(rng, make, n, valid):
    coord = np.zeros((len(valid), n, 3), np.float32)
    for b, v in enumerate(valid):
        coord[b, :v] = make(rng, n)[:v]
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    return torch.from_numpy(coord), torch.from_numpy(mask)


def _cases():
    """(name, query, ref, ref_mask, k, same) on seeded clouds."""
    rng = np.random.RandomState(0)
    out = []
    ref, mask = _batch(rng, _clustered, 1800, [1800, 1300])
    out.append(("clustered self, masked tail", ref, ref, mask, 16, True))
    ref, mask = _batch(rng, _wall, 1500, [1500, 1100])
    out.append(("wall self", ref, ref, mask, 8, True))
    ref, mask = _batch(rng, _duplicates, 1600, [1600, 1600])
    out.append(("duplicates self", ref, ref, mask, 12, True))
    ref, mask = _batch(rng, _clustered, 700, [700, 0, 5])
    out.append(("all-masked sample, fewer valid than k", ref, ref, mask, 8, True))
    ref, mask = _batch(rng, _clustered, 1600, [1600, 1200])
    query = ref[:, :500].clone()
    query[:, 380:] = 0.0  # the padded tail of a new_coord
    out.append(("cross, zero-padded query tail", query, ref, mask, 16, False))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _perm(order):
    """A plan's flat order (b * N + i) as per-sample indices."""
    return order - torch.arange(order.shape[0])[:, None] * order.shape[1]


def _sorted_positions(perm):
    """pos[b, i]: where original index i sits in the order ``perm``."""
    pos = torch.empty_like(perm)
    pos.scatter_(1, perm, torch.arange(perm.shape[1]).expand_as(perm).contiguous())
    return pos


def _lex_topk(d, j, k):
    """The k least (d, j) pairs of each row, lexicographically."""
    order = torch.argsort(j, dim=1, stable=True)
    d, j = d.gather(1, order), j.gather(1, order)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    return d.gather(1, order), j.gather(1, order)


def _emulate(query, plan, k, chunk, same):
    """The pruned kernel's visit rule over ``plan``, tile by tile (a warp
    each in the kernel); returns (idx, dist2, visits) in the caller's query
    order."""
    B, M, _ = query.shape
    deferred, _, lbs = geometry.knn_tile_bounds(query, plan, same)
    perm = _perm(plan.query_order)
    idx = torch.empty((B, M, k), dtype=torch.int32)
    dist2 = torch.empty((B, M, k), dtype=torch.float32)
    visits = torch.zeros(lbs.shape[:2], dtype=torch.int32)
    for b in range(B):
        nv = int(plan.n_valid[b])
        nc = -(-nv // chunk)
        refs = plan.ref_sorted[b, :nv]
        ref_xyz, ref_idx = refs[:, :3], refs[:, 3].view(torch.int32).long()
        for t, (p0, p1) in enumerate(geometry.knn_tiles(M, nv, same)):
            rows = perm[b, p0:p1][~deferred[b, p0:p1]]
            if not len(rows):
                continue
            q = query[b, rows]
            best_d = torch.full((len(rows), k), float("inf"))
            best_j = torch.full((len(rows), k), 1 << 40, dtype=torch.long)
            lb = lbs[b, t, :nc].clone()
            chunks = torch.arange(nc)
            home = min(p0 // chunk if same else p0 * nc // M, max(nc - 1, 0))
            while nc:
                # the least bound, then the nearest to home, then the lower index
                tied = chunks[lb == lb.min()]
                c = int(tied[torch.argmin((tied - home).abs() * (nc + 1) + tied)])
                tau = float(best_d[:, k - 1].max())
                if not torch.isfinite(lb[c]) or float(lb[c]) > tau:
                    break
                lb[c] = float("inf")
                visits[b, t] += 1
                lo, hi = c * chunk, min((c + 1) * chunk, nv)
                point_lb = geometry.box_bound(torch.cat([q, q], -1), plan.chunk_box[b, c])
                if not bool((~(point_lb > best_d[:, k - 1])).any()):
                    continue  # the warp skips every run of the chunk
                dx = ref_xyz[None, lo:hi, 0] - q[:, None, 0]
                dy = ref_xyz[None, lo:hi, 1] - q[:, None, 1]
                dz = ref_xyz[None, lo:hi, 2] - q[:, None, 2]
                d = (dx * dx + dy * dy) + dz * dz
                j = ref_idx[None, lo:hi].expand_as(d)
                best_d, best_j = _lex_topk(torch.cat([best_d, d], 1),
                                           torch.cat([best_j, j], 1), k)
            fin = torch.isfinite(best_d)
            first = torch.where(fin[:, :1], best_j[:, :1], torch.zeros_like(best_j[:, :1]))
            idx[b, rows] = torch.where(fin, best_j, first).to(torch.int32)
            dist2[b, rows] = best_d
        # a deferred query takes the results of the one before it in the order
        for pos in deferred[b].nonzero().flatten().tolist():
            idx[b, perm[b, pos]] = idx[b, perm[b, pos - 1]]
            dist2[b, perm[b, pos]] = dist2[b, perm[b, pos - 1]]
    return idx, dist2, visits


def _plan_and_plain(case, chunk):
    _, query, ref, mask, k, same = case
    plan = geometry.knn_plan(query, ref, mask, same, chunk)
    pidx, pd2 = geometry.knn_plain(query, ref, k, mask)
    return query, ref, mask, k, plan, pidx, pd2


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_orders_are_permutations_masked_last(case):
    query, ref, mask, k, plan, _, _ = _plan_and_plain(case, 32)
    B, N = mask.shape
    ref_perm = _perm(plan.ref_order)
    for perm, n in ((ref_perm, N), (_perm(plan.query_order), query.shape[1])):
        assert torch.equal(torch.sort(perm, dim=1).values, torch.arange(n).expand(B, n))
    valid_sorted = mask.gather(1, ref_perm)
    assert torch.equal(plan.n_valid, mask.sum(1).to(torch.int32))
    assert torch.equal(valid_sorted, torch.arange(N)[None] < plan.n_valid[:, None])
    assert torch.equal(plan.ref_sorted[..., :3], ref.gather(1, ref_perm[..., None].expand(B, N, 3)))
    assert torch.equal(plan.ref_sorted[..., 3].view(torch.int32).long(), ref_perm)
    if case[5]:
        assert plan.query_order is plan.ref_order
    # every valid ref inside its run's box; a chunk's box is its runs' box
    run = torch.arange(N) // geometry.KNN_TILE
    sub = plan.sub_box[:, run]
    inside = (sub[..., :3] <= plan.ref_sorted[..., :3]) & (plan.ref_sorted[..., :3] <= sub[..., 3:])
    assert bool(inside.all(-1)[valid_sorted].all())
    runs = plan.sub_box.view(B, plan.chunk_box.shape[1], -1, 6)
    assert torch.equal(plan.chunk_box,
                       torch.cat([runs[..., :3].amin(2), runs[..., 3:].amax(2)], -1))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_no_chunk_holding_a_true_neighbour_is_skipped(case):
    """Every bound is at most the dist2 of every (query, valid ref) pair of
    its tile and chunk, so a chunk that holds a neighbour of knn_plain has a
    bound at most that query's k-th distance."""
    chunk = 32
    query, ref, mask, k, plan, pidx, pd2 = _plan_and_plain(case, chunk)
    same = case[5]
    deferred, _, lbs = geometry.knn_tile_bounds(query, plan, same)
    B, M, _ = query.shape
    qpos = _sorted_positions(_perm(plan.query_order))
    rpos = _sorted_positions(_perm(plan.ref_order))
    for b in range(B):
        tile_of_pos = torch.empty(M, dtype=torch.long)
        for t, (p0, p1) in enumerate(geometry.knn_tiles(M, int(plan.n_valid[b]), same)):
            tile_of_pos[p0:p1] = t
        # a deferred query takes the search of the first query of its run
        for pos in deferred[b].nonzero().flatten().tolist():
            tile_of_pos[pos] = tile_of_pos[pos - 1]
        t_of_q = tile_of_pos[qpos[b]]
        c_of_r = rpos[b] // chunk
        # every pair, against the plain formula
        dx = ref[b, None, :, 0] - query[b, :, None, 0]
        dy = ref[b, None, :, 1] - query[b, :, None, 1]
        dz = ref[b, None, :, 2] - query[b, :, None, 2]
        d = (dx * dx + dy * dy) + dz * dz
        lb = lbs[b][t_of_q[:, None], c_of_r[None, :]]
        assert bool((lb[:, mask[b]] <= d[:, mask[b]]).all())
        # the true neighbours in particular
        fin = torch.isfinite(pd2[b])
        kth = pd2[b, :, k - 1]
        nb_lb = lbs[b][t_of_q[:, None].expand(M, k), c_of_r[pidx[b].long()]]
        assert bool((nb_lb[fin] <= kth[:, None].expand(M, k)[fin]).all())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_visit_rule_reproduces_plain(case, chunk=32):
    query, ref, mask, k, plan, pidx, pd2 = _plan_and_plain(case, chunk)
    idx, d2, visits = _emulate(query, plan, k, chunk, case[5])
    assert torch.equal(d2, pd2)
    # both take the lower index first at an exact tie; where the two
    # differ the distance must be a tie
    B = query.shape[0]
    exact = geometry.gather_rows(ref, idx)
    true_d2 = ((exact - query[:, :, None]) ** 2).sum(-1)
    diff = (idx != pidx) & torch.isfinite(d2)
    assert bool((true_d2[diff] == d2[diff]).all())
    # against a lexicographic brute force, indices too
    for b in range(B):
        d = torch.full((query.shape[1], ref.shape[1]), float("inf"))
        dx = ref[b, None, :, 0] - query[b, :, None, 0]
        dy = ref[b, None, :, 1] - query[b, :, None, 1]
        dz = ref[b, None, :, 2] - query[b, :, None, 2]
        d[:, mask[b]] = ((dx * dx + dy * dy) + dz * dz)[:, mask[b]]
        j = torch.arange(ref.shape[1]).expand_as(d)
        ld, lj = _lex_topk(d, j, k)
        fin = torch.isfinite(ld)
        first = torch.where(fin[:, :1], lj[:, :1], torch.zeros_like(lj[:, :1]))
        assert torch.equal(idx[b].long(), torch.where(fin, lj, first))
    # the visits: fewer than every chunk on the clustered cloud (no tile
    # mixes valid queries with the masked tail), every chunk where tau stays
    # +inf (fewer valid refs than k)
    n_chunks = -(-plan.n_valid.long() // chunk)
    if case[0].startswith("clustered"):
        assert bool((visits < n_chunks[:, None]).all())
        assert float(visits.sum()) < 0.5 * float((n_chunks[:, None] * visits.shape[1]).sum())
    if case[0].startswith("all-masked"):
        # sample 2: the 5 valid queries, then the zero tail of masked ones,
        # searched once by the tile where its run starts
        assert bool((visits[1] == 0).all())
        assert visits[2, :2].tolist() == [1, 1] and bool((visits[2, 2:] == 0).all())


def test_duplicate_refs_at_one_point_visit_every_chunk():
    """All refs at one point: every chunk's bound equals tau, so none may be
    skipped (a tie can win on index) and the lowest indices win."""
    ref = torch.full((1, 300, 3), 0.5)
    mask = torch.ones((1, 300), dtype=torch.bool)
    query = torch.tensor([[[0.0, 0.0, 0.0]]]).expand(1, 40, 3).contiguous()
    query = query + torch.arange(40.0)[None, :, None] * 0.01
    plan = geometry.knn_plan(query, ref, mask, False, 32)
    idx, d2, visits = _emulate(query, plan, 8, 32, False)
    pidx, pd2 = geometry.knn_plain(query, ref, 8, mask)
    assert torch.equal(d2, pd2)
    assert torch.equal(idx, torch.arange(8, dtype=torch.int32).expand(1, 40, 8))
    assert visits.tolist() == [[10, 10, 0]]  # two tiles of queries, one spare


def test_plan_with_the_kernel_defaults():
    """The plan at the kernel's own chunk on the clustered case."""
    case = CASES[0]
    chunk = geometry.knn_chunk(case[2].shape[1])
    query, ref, mask, k, plan, pidx, pd2 = _plan_and_plain(case, chunk)
    assert plan.chunk_box.shape == (2, -(-ref.shape[1] // chunk), 6)
    idx, d2, _ = _emulate(query, plan, k, chunk, True)
    assert torch.equal(d2, pd2)
