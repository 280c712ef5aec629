"""The port's CUDA kernels (K1 kNN, K2 FPS, K3 vector attention, K4 its
training forward + backward, K5 cRPE window attention, K6 KPConv, K7 PT-v2
grouped vector attention) against their plain PyTorch versions on a GPU.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips where no CUDA device is present.  The file imports
nothing of JAX, so it also runs where JAX is not installed; without the
suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the read-back of K5's bins)
from pointcloudpdf_tpu_torch.models.norm import MaskedBatchNorm
from pointcloudpdf_tpu_torch.models.point_transformer import PointTransformerLayer
from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2
from pointcloudpdf_tpu_torch.models.utils.structure import Points
from pointcloudpdf_tpu_torch.models.stratified_transformer import st
from pointcloudpdf_tpu_torch.ops import _cuda, geometry, sampling
from pointcloudpdf_tpu_torch.ops import gva
from pointcloudpdf_tpu_torch.ops import kpconv as kp
from pointcloudpdf_tpu_torch.ops import st_attention as sa
from pointcloudpdf_tpu_torch.ops import vector_attention as va

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cloud(seed, B, N, valid, dev):
    rng = np.random.RandomState(seed)
    coord = (rng.rand(B, N, 3) * np.array([4.0, 3.0, 2.0])).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(valid)[:, None]
    coord[~mask] = 0.0
    return torch.from_numpy(coord).to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("k", [3, 8, 16, 40])
def test_knn_kernel_matches_plain(dev, k):
    """dist2 bitwise equal (same rounding); indices equal but at exact
    ties, where the kernel's index lies at the same distance."""
    r, m = _cloud(9, 2, 5000, [5000, 3100], dev)
    before = geometry.KNN_LAUNCHES
    idx, d2 = geometry.knn(r, r, k, m)
    assert geometry.KNN_LAUNCHES == before + 1
    with _cuda.plain_versions():
        pidx, pd2 = geometry.knn(r, r, k, m)
    assert geometry.KNN_LAUNCHES == before + 1
    assert torch.equal(d2, pd2)
    fin = torch.isfinite(d2)
    diff = (idx != pidx) & fin
    true_d2 = ((geometry.gather_rows(r, idx) - r[:, :, None]) ** 2).sum(-1)
    assert torch.allclose(true_d2[diff], d2[diff], rtol=1e-6, atol=0)
    assert (idx >= 0).all() and (idx < 5000).all()


def test_knn_kernel_masked_tail_and_k_above_n(dev):
    r, m = _cloud(11, 3, 64, [64, 3, 0], dev)
    idx, d2 = geometry.knn(r, r, 8, m)
    with _cuda.plain_versions():
        pidx, pd2 = geometry.knn(r, r, 8, m)
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    q = _cloud(12, 3, 40, [40, 40, 40], dev)[0]
    idx, d2 = geometry.knn(q, r[:, :5].contiguous(), 8, m[:, :5].contiguous())
    assert idx.shape == (3, 40, 8) and torch.isinf(d2[..., 5:]).all()


def _assert_knn_matches_plain(q, r, k, m, idx, d2):
    """dist2 bitwise equal to knn_plain's; indices equal but at exact ties,
    where the kernel's index lies at the same distance."""
    with _cuda.plain_versions():
        pidx, pd2 = geometry.knn(q, r, k, m)
    assert torch.equal(d2, pd2)
    fin = torch.isfinite(d2)
    diff = (idx != pidx) & fin
    true_d2 = ((geometry.gather_rows(r, idx) - q[:, :, None]) ** 2).sum(-1)
    assert torch.allclose(true_d2[diff], d2[diff], rtol=1e-6, atol=0)
    assert (idx >= 0).all() and (idx < r.shape[1]).all()


def _clustered_with_duplicates(seed, B, N, valid, dev):
    """Room-scale clusters (chip_smoke's), every 8th point a copy of
    another: duplicate coordinates, as voxel centres repeat."""
    rng = np.random.RandomState(seed)
    coord, mask = chip_smoke.clustered_cloud(rng, B, N, valid)
    for b in range(B):
        src = rng.randint(0, valid[b], size=valid[b] // 8)
        coord[b, rng.randint(0, valid[b], size=len(src))] = coord[b, src]
    return torch.from_numpy(coord).to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("k", [3, 16, 34, 64])
def test_knn_pruned_kernel_matches_plain(dev, k, same):
    """40,000 refs take the bound-pruned kernel: clustered, with duplicates
    and a masked tail; self kNN and a cross kNN from a quarter of them with
    a zero-padded tail."""
    r, m = _clustered_with_duplicates(21, 2, 40000, [40000, 33000], dev)
    q = r
    if not same:
        q = r[:, ::4].contiguous()
        q[:, 9000:] = 0.0
    before = geometry.KNN_PRUNED_LAUNCHES
    idx, d2 = geometry.knn(q, r, k, m)
    assert geometry.KNN_PRUNED_LAUNCHES == before + 1
    _assert_knn_matches_plain(q, r, k, m, idx, d2)


def test_knn_threshold_takes_each_kernel(dev):
    """One ref set each side of KNN_PRUNE_MIN_REFS, each against the plain
    version."""
    n = geometry.KNN_PRUNE_MIN_REFS
    for size, counter in ((n - 1, "KNN_BRUTE_LAUNCHES"), (n, "KNN_PRUNED_LAUNCHES")):
        r, m = _clustered_with_duplicates(22, 2, size, [size, size - 500], dev)
        before = getattr(geometry, counter)
        idx, d2 = geometry.knn(r, r, 16, m)
        assert getattr(geometry, counter) == before + 1
        _assert_knn_matches_plain(r, r, 16, m, idx, d2)


def test_knn_plan_kernels_match_plain(dev):
    """The prep kernels (morton codes, sorted refs, chunk boxes) give the
    plain plan's values exactly."""
    r, m = _clustered_with_duplicates(23, 2, 20000, [20000, 15000], dev)
    q = r[:, :7000].contiguous()
    got = geometry.knn_plan(q, r, m, False)
    with _cuda.plain_versions():
        want = geometry.knn_plan(q, r, m, False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_knn_pruned_visits(dev):
    """The visit counter: fewer chunks than there are on a clustered cloud
    (tiles of valid queries), every chunk where no bound exceeds tau (all
    refs at one point: each chunk may hold a tie that wins on index) and
    where tau stays +inf (fewer valid refs than k)."""
    n = 40000
    r, m = _clustered_with_duplicates(24, 1, n, [n], dev)
    idx, d2, visits = geometry.knn_pruned_cuda(r, r, 16, m, True, visits=True)
    n_chunks = -(-n // geometry.knn_chunk(n))
    assert visits.shape == (1, -(-n // geometry.KNN_TILE) + 1)
    assert int(visits.max()) < n_chunks and float(visits.float().mean()) < 0.2 * n_chunks
    _assert_knn_matches_plain(r, r, 16, m, idx, d2)

    r = torch.full((1, n, 3), 0.5, device=dev)
    q = torch.rand((1, 3000, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    m = torch.ones((1, n), dtype=torch.bool, device=dev)
    idx, d2, visits = geometry.knn_pruned_cuda(q, r, 8, m, False, visits=True)
    assert bool((visits[:, :-1] == n_chunks).all()) and int(visits[0, -1]) == 0  # a spare tile
    assert torch.equal(idx, torch.arange(8, dtype=torch.int32, device=dev).expand(1, 3000, 8))
    _assert_knn_matches_plain(q, r, 8, m, idx, d2)

    r, m = _clustered_with_duplicates(25, 2, n, [n, 5], dev)
    idx, d2, visits = geometry.knn_pruned_cuda(r, r, 8, m, True, visits=True)
    # the 5 valid queries, then the zero tail of masked ones, searched once
    # by the tile where that run starts
    assert visits[1, :2].tolist() == [1, 1] and bool((visits[1, 2:] == 0).all())
    _assert_knn_matches_plain(r, r, 8, m, idx, d2)


def _brute_edge_cases(dev):
    """The brute-force kernel's edges: (name, query, ref, k, ref_mask)."""
    r, m = _clustered_with_duplicates(26, 3, 2048, [2048, 0, 5], dev)
    dup = r[:1, torch.randperm(4096, generator=torch.Generator().manual_seed(0)) % 512]
    dup_m = torch.ones((1, 4096), dtype=torch.bool, device=dev)
    wide, wide_m = _clustered_with_duplicates(27, 1, 4096, [4096], dev)
    q = wide[:, :700].contiguous()
    return [("all-masked sample, 5 valid, k=16", r, r, 16, m),
            ("duplicates x8, k=16", dup.contiguous(), dup.contiguous(), 16, dup_m),
            ("k=32", wide, wide, 32, wide_m),
            ("k=64 cross", q, wide, 64, wide_m),
            ("k=3 cross, partly masked", q, wide, 3,
             wide_m & (torch.arange(4096, device=dev) % 3 > 0))]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_knn_brute_kernel_every_lane_count(dev, lanes):
    """Every lane count the host rule can pick gives the plain version's
    dist2 bit for bit and the same indices as one lane a query (the lower
    index wins every exact tie), at the kernel's edges."""
    for name, q, r, k, m in _brute_edge_cases(dev):
        before = geometry.KNN_BRUTE_LAUNCHES
        idx, d2 = geometry.knn_brute_cuda(q, r, k, m, lanes)
        assert geometry.KNN_BRUTE_LAUNCHES == before + 1, name
        _assert_knn_matches_plain(q, r, k, m, idx, d2)
        idx1, d21 = geometry.knn_brute_cuda(q, r, k, m, 1)
        assert torch.equal(d2, d21) and torch.equal(idx, idx1), name
    # the all-masked sample: +inf and index 0 throughout; 5 valid refs: the
    # slots past them repeat the nearest
    name, q, r, k, m = _brute_edge_cases(dev)[0]
    idx, d2 = geometry.knn_brute_cuda(q, r, k, m, lanes)
    assert torch.isinf(d2[1]).all() and (idx[1] == 0).all()
    assert torch.isinf(d2[2, :, 5:]).all()
    assert torch.equal(idx[2, :, 5:], idx[2, :, :1].expand(-1, 11))


def test_knn_lanes_rule(dev):
    """The rule's lane count: a power of two from 1 to 32, never more for a
    larger grid; 32 for one small sample, 1 for the train step's batch."""
    picks = [geometry.knn_lanes(B, M) for B, M in ((1, 256), (1, 1024), (1, 4096), (1, 16384),
                                                    (2, 16384), (16, 5120), (16, 20480))]
    assert all(g in (1, 2, 4, 8, 16, 32) for g in picks)
    assert picks == sorted(picks, reverse=True)
    assert picks[0] == 32 and picks[-1] == 1


@pytest.mark.parametrize("lanes", [0, 2, 16])
def test_knn_brute_kernel_streams_large_sets(dev, lanes):
    """Sets above what shared memory holds go through in tiles: masked
    refs inside and across tiles, k = 16 and 3."""
    r, m = _clustered_with_duplicates(28, 2, 30000, [30000, 21000], dev)
    m = m & (torch.arange(30000, device=dev) % 5 > 0)
    q = r[:, ::6].contiguous()
    for k in (16, 3):
        idx, d2 = geometry.knn_brute_cuda(q, r, k, m, lanes)
        _assert_knn_matches_plain(q, r, k, m, idx, d2)


def test_knn_brute_kernel_refuses_a_lane_count(dev):
    r, m = _cloud(9, 1, 300, [300], dev)
    with pytest.raises(ValueError):
        geometry.knn_brute_cuda(r, r, 8, m, 3)
    with pytest.raises(ValueError):
        geometry.knn_brute_cuda(r, r, 65, m)


@pytest.mark.parametrize("n,m", [(256, 64), (20000, 700)])
def test_fps_kernel_matches_plain(dev, n, m):
    """Shared-memory sets (n <= 8192) and device-memory sets."""
    c, mk = _cloud(10, 3, n, [n, n - 17, n // 3], dev)
    got = sampling.fps_sets(c, mk, m)
    with _cuda.plain_versions():
        want = sampling.fps_sets(c, mk, m)
    assert torch.equal(got, want)


def test_blocked_fps_kernel_matches_plain(dev):
    c, mk = _cloud(13, 2, 16384, [16384, 9000], dev)
    before = sampling.FPS_LAUNCHES
    got = sampling.blocked_farthest_point_sampling(c, 4096, mk, max_group_steps=64)
    assert sampling.FPS_LAUNCHES == before + 1
    with _cuda.plain_versions():
        want = sampling.blocked_farthest_point_sampling(c, 4096, mk, max_group_steps=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _sorted_windows_case(seed, B, N, valid, dev, ties=False):
    """Samples in morton order with their valid points first, as the
    blocked call hands them to ``fps_windows``; ``ties``: coordinates on a
    coarse grid, every 5th point a copy of its neighbour (exact ties and
    zero distances)."""
    rng = np.random.RandomState(seed)
    coord, mask = chip_smoke.clustered_cloud(rng, B, N, valid)
    if ties:
        coord = np.round(coord * 4) / 4
        coord[:, 1::5] = coord[:, 0:-1:5]
    coord, mask = torch.from_numpy(coord).to(dev), torch.from_numpy(mask).to(dev)
    order = sampling.morton_sort_indices(coord, mask)
    sorted_coord = coord.gather(1, order[..., None].expand(-1, -1, 3)).contiguous()
    return sorted_coord, mask.sum(1)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("g,k_g", [(256, 64), (512, 128), (1024, 128), (4096, 64)])
def test_fps_windows_kernel_matches_plain(dev, g, k_g, ties):
    """The windows kernel at the paths' window sizes (256 / 64 PT-v1, 512 and
    1,024 / 128 ST; 4,096 takes the block kernel): positions equal to the
    plain version's,
    on a full sample, one with a masked tail (overlapping last windows),
    one with fewer valid points than picks in a window, and an empty one."""
    G, B = 8, 4
    N = G * g
    sorted_coord, count = _sorted_windows_case(
        g + k_g, B, N, [N, N - g // 3 - 5, G * k_g // 2, 0], dev, ties)
    before = sampling.FPS_LAUNCHES
    pos = sampling.fps_windows(sorted_coord, count, G, g, k_g)
    assert sampling.FPS_LAUNCHES == before + 1
    with _cuda.plain_versions():
        want = sampling.fps_windows(sorted_coord, count, G, g, k_g)
    assert sampling.FPS_LAUNCHES == before + 1
    assert pos.dtype == torch.int64 and pos.shape == (B, G * k_g)
    assert torch.equal(pos, want)


def test_fps_windows_above_the_kernel_take_the_block_kernel(dev):
    """Windows above ``FPS_WINDOW_MAX`` points go to the block kernel over
    gathered windows: one launch, the plain version's positions."""
    g = 2 * sampling.FPS_WINDOW_MAX
    sorted_coord, count = _sorted_windows_case(21, 2, 2 * g, [2 * g, g + 100], dev)
    before = sampling.FPS_LAUNCHES
    pos = sampling.fps_windows(sorted_coord, count, 2, g, 40)
    assert sampling.FPS_LAUNCHES == before + 1
    with _cuda.plain_versions():
        want = sampling.fps_windows(sorted_coord, count, 2, g, 40)
    assert torch.equal(pos, want)


def _eval_attention_layer(c, k, seed):
    """An eval layer with random BatchNorm affines and running statistics."""
    gen = torch.Generator().manual_seed(seed)
    layer = PointTransformerLayer(c, c, share_planes=8, nsample=k)
    with torch.no_grad():
        for bn in layer.modules():
            if isinstance(bn, MaskedBatchNorm):
                n = bn.num_features
                bn.weight.copy_(0.5 + torch.rand(n, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(n, generator=gen))
                bn.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                bn.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
    return layer, gen


@pytest.mark.parametrize("c", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("k", [5, 8, 16])
def test_attention_kernel_matches_plain(dev, c, k):
    """Eval layer on random weights and BatchNorm statistics: K3 against
    the plain version within 1e-4 of the output's magnitude (f32 sums in
    another order).  Three samples of 1,499 rows, one with a masked tail:
    B * N = 4,497 leaves a partial last tile at every tile size (2 to 25
    queries)."""
    layer, gen = _eval_attention_layer(c, k, seed=c + k)
    layer = layer.to(dev).eval()
    coord, mask = _cloud(5, 3, 1499, [1499, 1000, 1499], dev)
    feat = torch.randn((3, 1499, c), generator=gen).to(dev)
    pts = Points(coord, feat, mask)
    before = va.ATTENTION_LAUNCHES
    with torch.inference_mode():
        out = layer(pts)
        with _cuda.plain_versions():
            ref = layer(pts)
    assert va.ATTENTION_LAUNCHES == before + 1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert (out[~mask] == 0).all()


def test_attention_layer_packs_once(dev):
    """An eval layer packs its parameters once (``packed_params``) and gives
    what the tensor entry gives on the layer's weights and folded affines,
    bit for bit; a changed running statistic repacks."""
    layer, gen = _eval_attention_layer(64, 16, seed=3)
    layer = layer.to(dev).eval()
    coord, mask = _cloud(8, 2, 2000, [2000, 1300], dev)
    feat = torch.randn((2, 2000, 64), generator=gen).to(dev)
    idx, d2 = geometry.knn(coord, coord, 16, mask)
    nmask = torch.isfinite(d2) & mask[..., None]
    mlps = (layer.linear_p, layer.linear_w)
    for step in range(2):
        with torch.inference_mode():
            if step:
                layer.linear_w[3].running_var.mul_(1.5)
            out = layer(Points(coord, feat, mask))
            packed = va.packed_params(*mlps)
            assert va.packed_params(*mlps) is packed
            assert torch.equal(packed[0], va._pack_params(*va.eval_params(*mlps)))
            want = va.vector_attention(
                layer.linear_q(feat), layer.linear_k(feat), layer.linear_v(feat),
                coord, idx, nmask, *va.eval_params(*mlps))
        assert torch.equal(out, torch.where(mask[..., None], want, 0.0)), step


def _attention_case(dev, c, k, seed, n=1500, valid=(1500, 900)):
    """``vector_attention`` inputs without gradients (``_train_case``)."""
    feats, coord, idx, nmask, params, _ = _train_case(dev, c, k, seed, n=n,
                                                      valid=valid, drop=0.1)
    return ([x.detach() for x in feats], coord, idx, nmask,
            [x.detach() for x in params])


@pytest.mark.parametrize("c,k,reps", [(512, 40, 1), (32, 26, 5)])
def test_attention_kernel_k_above_the_tile(dev, c, k, reps):
    """K above the tile's pair rows (P = 32 at C = 512; at C = 32, P = 128
    against K = 130, the kNN table of 26 slots repeated five times): a
    query's slots in row chunks merged by the online softmax, the last
    chunk partial."""
    feats, coord, idx, nmask, params = _attention_case(dev, c, k, seed=k)
    idx, nmask = idx.repeat(1, 1, reps), nmask.repeat(1, 1, reps)
    with torch.inference_mode():
        out = va.vector_attention(*feats, coord, idx, nmask, *params)
        with _cuda.plain_versions():
            ref = va.vector_attention(*feats, coord, idx, nmask, *params)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("c,k", [(64, 1), (512, 3)])
def test_attention_kernel_few_slots(dev, c, k):
    """K below 4: a tile holds at most P / 4 queries, its other rows
    unused."""
    feats, coord, idx, nmask, params = _attention_case(dev, c, k, seed=k + 30)
    with torch.inference_mode():
        out = va.vector_attention(*feats, coord, idx, nmask, *params)
        with _cuda.plain_versions():
            ref = va.vector_attention(*feats, coord, idx, nmask, *params)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("c,k", [(32, 8), (512, 40)])
def test_attention_kernel_all_masked_batch(dev, c, k):
    """No valid neighbour anywhere: exactly 0, in one row chunk or several."""
    feats, coord, idx, nmask, params = _attention_case(dev, c, k, seed=9)
    with torch.inference_mode():
        out = va.vector_attention(*feats, coord, idx, torch.zeros_like(nmask), *params)
    assert (out == 0).all()


@pytest.mark.parametrize("c,k", [(32, 8), (256, 16)])
def test_attention_kernel_query_without_neighbours(dev, c, k):
    """Queries with no valid neighbour give exactly 0; the others agree
    with the plain version."""
    feats, coord, idx, nmask, params = _attention_case(dev, c, k, seed=10)
    nmask = nmask.clone()
    nmask[:, ::7] = False
    with torch.inference_mode():
        out = va.vector_attention(*feats, coord, idx, nmask, *params)
        with _cuda.plain_versions():
            ref = va.vector_attention(*feats, coord, idx, nmask, *params)
    assert (out[:, ::7] == 0).all()
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("stage", [3, 4])
def test_attention_train_forward_at_the_train_step_shapes(dev, stage):
    """The training forward (K3's kernel under ``VectorAttentionFunction``)
    at the Seg50 train step's stages 4 and 5: B = 16 crops of the shipped
    batch in the 81,920 bucket, C = 256 / 512, K = 16."""
    rng = np.random.RandomState(20 + stage)
    crops = rng.randint(chip_smoke.TRAIN_CROP[0], chip_smoke.TRAIN_CROP[1] + 1, size=16)
    name, n, c, k, valid = chip_smoke.attention_train_shapes(crops)[stage]
    feats, coord, idx, nmask, params = chip_smoke.attention_inputs(dev, rng, n, c, k,
                                                                   valid=valid)
    before = va.ATTENTION_TRAIN_LAUNCHES
    with torch.no_grad():
        out = va.vector_attention_train(*feats, coord, idx, nmask, *params)
        with _cuda.plain_versions():
            ref = va.vector_attention_train(*feats, coord, idx, nmask, *params)
    assert va.ATTENTION_TRAIN_LAUNCHES == before + 1, name
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


def test_attention_kernel_refuses_grad(dev):
    layer = PointTransformerLayer(32, 32, nsample=8).to(dev).eval()
    coord, mask = _cloud(6, 1, 100, [100], dev)
    pts = Points(coord, torch.randn(1, 100, 32, device=dev), mask)
    with pytest.raises(RuntimeError, match="no backward"):
        layer(pts)


# -- K4: training forward + backward ----------------------------------------


def _train_case(dev, c, k, seed, n=1500, valid=(1500, 900), drop=0.05):
    """Inputs of ``vector_attention_train`` as leaf tensors: features,
    weights and affines with requires_grad, ~``drop`` of the neighbour slots
    and a tail of rows masked."""
    gen = torch.Generator().manual_seed(seed)
    g = c // 8
    coord, mask = _cloud(seed, len(valid), n, list(valid), dev)
    idx, d2 = geometry.knn(coord, coord, k, mask)
    keep = (torch.rand(idx.shape, generator=gen) >= drop).to(dev)
    nmask = torch.isfinite(d2) & mask[..., None] & keep

    def t(*shape, scale=1.0, shift=0.0):
        v = shift + scale * torch.randn(shape, generator=gen)
        return v.to(dev).requires_grad_(True)

    feats = [t(len(valid), n, c) for _ in range(3)]
    params = [t(3, 3, scale=0.5), t(3, scale=0.1), t(3, c, scale=0.5),
              t(c, scale=0.1), t(c, g, scale=c ** -0.5), t(g, scale=0.1),
              t(g, g, scale=g ** -0.5), t(g, scale=0.1),
              t(3, scale=0.1, shift=1.0), t(3, scale=0.1),
              t(c, scale=0.1, shift=1.0), t(c, scale=0.1),
              t(g, scale=0.1, shift=1.0), t(g, scale=0.1)]
    dout = torch.randn((len(valid), n, c), generator=gen).to(dev)
    return feats, coord, idx, nmask, params, dout


def _train_run(feats, coord, idx, nmask, params, dout):
    out = va.vector_attention_train(*feats, coord, idx, nmask, *params)
    grads = torch.autograd.grad(out, [*feats, *params], dout)
    return out.detach(), grads


def _off_kinks(case):
    """The case with the pairs on a ReLU kink masked off (see
    ``mask_off_relu_kinks``): about 1e-5 x (C + G + 3) of the pairs."""
    feats, coord, idx, nmask, params, dout = case
    return (feats, coord, idx,
            va.mask_off_relu_kinks(*feats, coord, idx, nmask, *params),
            params, dout)


def _assert_train_close(got, want):
    """Forward and d x_q/x_k/x_v within 1e-4, parameter and affine
    gradients (sums over all rows in another order, with atomics) within
    1e-3, each relative to the plain tensor's max magnitude, on inputs
    with no pair on a ReLU kink (``_off_kinks``).  The gradient of w2_b is
    zero in exact arithmetic (a softmax ignores a shift of its logits), so
    both sides give rounding noise there: it is held to w2_w's scale."""
    (out, grads), (ref, rgrads) = got, want
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    w2_w, w2_b = 3 + 6, 3 + 7
    for i, (a, b) in enumerate(zip(grads, rgrads)):
        assert a.shape == b.shape
        scale = float(rgrads[w2_w if i == w2_b else i].abs().max())
        tol = 1e-4 if i < 3 else 1e-3
        assert float((a - b).abs().max()) <= tol * scale + 1e-12, i


@pytest.mark.parametrize("c", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("k", [5, 8, 16])
def test_attention_train_kernel_matches_plain(dev, c, k):
    """Every width and K in {5, 8, 16} over three samples of 1,499 rows
    (one with a masked tail): many tiles of whole queries, and a last tile
    that is partial at every tile size (B * N = 4,497 is no multiple of
    any tile's count of queries, 2 to 25)."""
    case = _off_kinks(_train_case(dev, c, k, seed=c + k, n=1499,
                                  valid=(1499, 900, 1499)))
    k3, fwd, bwd = (va.ATTENTION_LAUNCHES, va.ATTENTION_TRAIN_LAUNCHES,
                    va.ATTENTION_BWD_LAUNCHES)
    got = _train_run(*case)
    with _cuda.plain_versions():
        want = _train_run(*case)
    assert (va.ATTENTION_LAUNCHES, va.ATTENTION_TRAIN_LAUNCHES,
            va.ATTENTION_BWD_LAUNCHES) == (k3, fwd + 1, bwd + 1)
    _assert_train_close(got, want)


def test_attention_train_kernel_all_masked_batch(dev):
    """No valid neighbour anywhere: output and every gradient are 0."""
    feats, coord, idx, nmask, params, dout = _train_case(dev, 64, 16, seed=1)
    out, grads = _train_run(feats, coord, idx, torch.zeros_like(nmask),
                            params, dout)
    assert (out == 0).all()
    assert all((g == 0).all() for g in grads)


def test_attention_train_kernel_query_without_neighbours(dev):
    """Queries with no valid neighbour give 0 and take no gradient; the
    others agree with the plain version."""
    feats, coord, idx, nmask, params, dout = _train_case(dev, 32, 8, seed=2)
    nmask = nmask.clone()
    nmask[:, ::7] = False
    case = _off_kinks((feats, coord, idx, nmask, params, dout))
    got = _train_run(*case)
    with _cuda.plain_versions():
        want = _train_run(*case)
    _assert_train_close(got, want)
    assert (got[0][:, ::7] == 0).all() and (got[1][0][:, ::7] == 0).all()


def test_attention_train_layer_matches_plain(dev):
    """A training layer on the card (batch-statistic affines + K3/K4)
    against the same layer on the plain versions: output, running
    statistics and parameter gradients."""
    results = []
    for plain in (False, True):
        torch.manual_seed(3)
        layer = PointTransformerLayer(64, 64, nsample=16).to(dev).train()
        coord, mask = _cloud(7, 2, 2000, [2000, 1200], dev)
        feat = torch.randn((2, 2000, 64), generator=torch.Generator().manual_seed(4)).to(dev)
        if plain:
            with _cuda.plain_versions():
                out = layer(Points(coord, feat, mask))
        else:
            out = layer(Points(coord, feat, mask))
        out.square().sum().backward()
        results.append((out.detach(), {n: p.grad for n, p in layer.named_parameters()},
                        dict(layer.named_buffers())))
    (out, grads, bufs), (ref, rgrads, rbufs) = results
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    # 1e-3 of each gradient's max, plus 1e-5 of the largest gradient: the
    # biases of linear_q / linear_k / linear_p.0 / linear_w.2 feed a
    # batch-statistic BatchNorm, so their exact gradient is 0 and both
    # sides give rounding noise
    floor = 1e-5 * max(float(g.abs().max()) for g in rgrads.values())
    for name, g in rgrads.items():
        assert float((grads[name] - g).abs().max()) <= 1e-3 * float(g.abs().max()) + floor, name
    for name, b in rbufs.items():
        torch.testing.assert_close(bufs[name], b, rtol=1e-5, atol=1e-6)


# -- K5: cRPE window attention ----------------------------------------------


def _st_case(dev, c, rel, seed, n=3000, valid=(3000, 1900), k=12,
             window=0.16, quant=0.01):
    """q/k/v, coords, a key table (the k nearest, ~20% of the slots masked,
    every 7th query with no key) and the three tables at one width."""
    gen = torch.Generator().manual_seed(seed)
    coord, mask = _cloud(seed, len(valid), n, list(valid), dev)
    key_idx, d2 = geometry.knn(coord, coord, k, mask)
    key_mask = (torch.isfinite(d2) & mask[..., None]
                & (torch.rand(key_idx.shape, generator=gen) >= 0.2).to(dev))
    key_mask[:, ::7] = False
    num_bins = 2 * int((2 * window + 1e-4) // quant)
    q, kk, v = (torch.randn((len(valid), n, c), generator=gen).to(dev)
                for _ in range(3))
    tables = [(0.3 * torch.randn((3, num_bins, c), generator=gen)).to(dev)
              if on else None for on in rel]
    return (q, kk, v, coord, key_idx, key_mask, *tables, c // 16, window,
            quant, num_bins)


@pytest.mark.parametrize("rel", [(True, True, True), (False, False, False),
                                 (True, False, False), (False, True, False),
                                 (False, False, True)])
@pytest.mark.parametrize("c", [96, 192, 384])
def test_st_attention_kernel_matches_plain(dev, c, rel):
    """K5 within 1e-4 of max |plain| (f32 sums in another order, an online
    softmax); queries without a key come out 0."""
    case = _st_case(dev, c, rel, seed=c + sum(rel))
    before = sa.ST_ATTENTION_LAUNCHES
    out = sa.st_attention(*case)
    assert sa.ST_ATTENTION_LAUNCHES == before + 1
    with _cuda.plain_versions():
        ref = sa.st_attention(*case)
    assert sa.ST_ATTENTION_LAUNCHES == before + 1
    assert float(ref.abs().max()) > 0.1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert (out[:, ::7] == 0).all()


@pytest.mark.parametrize("c", [96, 192, 384])
def test_st_attention_kernel_picks_the_plain_bins(dev, c):
    """The kernel's bins at each width of the ST path, read back through a
    value table that holds its own row number (one key slot a launch, zero
    q, k and v): equal to the plain version's at every (query, key, axis),
    on coordinates of which half sit on a 1 cm grid, where bin boundaries
    are common."""
    q, k, v, coord, key_idx, key_mask, _, _, _, h, window, quant, num_bins = (
        _st_case(dev, c, (False, False, False), seed=3))
    coord[0] = torch.round(coord[0] * 100) / 100
    got = chip_smoke.st_attention_kernel_bins(coord, key_idx, window, quant,
                                              num_bins, c)
    want = sa.st_attention_bins(coord, key_idx, window, quant, num_bins)
    assert len(torch.unique(want)) > 20
    assert int((got != want).sum()) == 0


def test_st_attention_kernel_all_masked_batch(dev):
    case = list(_st_case(dev, 96, (True, True, True), seed=4))
    case[5] = torch.zeros_like(case[5])
    assert (sa.st_attention(*case) == 0).all()


def test_st_attention_kernel_refuses_grad(dev):
    case = list(_st_case(dev, 96, (True, True, True), seed=5, n=200,
                         valid=(200, 150)))
    case[0] = case[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        sa.st_attention(*case)
    with torch.no_grad():
        assert sa.st_attention(*case).shape == (2, 200, 96)


@pytest.mark.parametrize("c,k,window,quant", [(32, 64, 0.16, 0.01), (512, 5, 0.16, 0.01),
                                             (64, 48, 0.1, 0.005), (128, 40, 0.2, 0.01)])
def test_st_attention_kernel_slots_and_bins(dev, c, k, window, quant):
    """K5 at its edges: K = 64 (the most slots), K = 5 at C = 512 (16 head
    groups), 2L = 80 at 5 mm and at 1 cm bins (the ScanNet configs; the
    most bins the kernel takes): within 1e-4 of max |plain|, queries without a key
    at 0, the bins the plain version's."""
    case = _st_case(dev, c, (True, True, True), seed=c + k, k=k, window=window,
                    quant=quant)
    out = sa.st_attention(*case)
    with _cuda.plain_versions():
        ref = sa.st_attention(*case)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert (out[:, ::7] == 0).all()
    coord, key_idx, num_bins = case[3], case[4], case[-1]
    got = chip_smoke.st_attention_kernel_bins(coord, key_idx, window, quant, num_bins, c)
    assert int((got != sa.st_attention_bins(coord, key_idx, window, quant, num_bins)).sum()) == 0


def test_st_attention_kernel_refuses_past_its_limits(dev):
    """65 key slots (one past the kernel's most) raise before any launch."""
    case = list(_st_case(dev, 96, (True, True, True), seed=8, n=300, valid=(300, 200), k=64))
    case[4] = torch.cat([case[4], case[4][..., :1]], -1)
    case[5] = torch.cat([case[5], case[5][..., :1]], -1)
    before = sa.ST_ATTENTION_LAUNCHES
    with torch.no_grad(), pytest.raises(ValueError, match="64 key slots"):
        sa.st_attention(*case)
    assert sa.ST_ATTENTION_LAUNCHES == before


def test_st_block_takes_kernel_in_eval_and_plain_in_training(dev):
    """The dispatch of the inference-only kernel: eval under no_grad
    launches K5, eval with a gradient asked of it raises (no quiet plain
    version on the card), a training block takes the plain version and
    gives a gradient."""
    torch.manual_seed(6)
    block = st.STBlock(96, 6, 0.16, 0.01, True, True, True, 0.0).to(dev)
    q, _, _, coord, key_idx, key_mask, *_ = _st_case(
        dev, 96, (False,) * 3, seed=6, n=500, valid=(500, 300))
    mask = torch.arange(500, device=dev)[None] < torch.tensor([[500], [300]], device=dev)
    before = sa.ST_ATTENTION_LAUNCHES
    block.eval()
    with torch.inference_mode():
        out = block(q, coord, key_idx, key_mask, mask)
        with _cuda.plain_versions():
            ref = block(q, coord, key_idx, key_mask, mask)
    assert sa.ST_ATTENTION_LAUNCHES == before + 1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    with pytest.raises(RuntimeError, match="no backward"):
        block(q, coord, key_idx, key_mask, mask)
    block.train()
    block(q, coord, key_idx, key_mask, mask).sum().backward()
    assert sa.ST_ATTENTION_LAUNCHES == before + 1
    assert block.attn.relative_pos_key_table.grad.abs().max() > 0


# -- K6: KPConv ---------------------------------------------------------------


def _kpconv_case(dev, c_in, c_out, seed, n=4000, valid=(4000, 2500), radius=0.1):
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(seed)
    # 40 clusters of sigma 6 cm: balls of radius 10 cm that hold from a few
    # to well over 34 points
    centers = rng.rand(40, 3) * np.array([2.0, 1.5, 1.0])
    coord = (centers[rng.randint(0, 40, (len(valid), n))]
             + rng.normal(scale=0.06, size=(len(valid), n, 3))).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    coord[~mask] = 0.0
    coord, mask = torch.from_numpy(coord).to(dev), torch.from_numpy(mask).to(dev)
    idx, nmask = geometry.ball_query(coord, coord, radius, 34, ref_mask=mask)
    nmask = nmask & mask[..., None]
    feat = torch.randn((len(valid), n, c_in), generator=gen).to(dev)
    feat = feat * mask[..., None]
    points = torch.from_numpy(st.kpconv_kernel_points() * np.float32(0.06)).to(dev)
    weight = (0.2 * torch.randn((15, c_in, c_out), generator=gen)).to(dev)
    return coord, feat, idx, nmask, points, weight, 0.04


@pytest.mark.parametrize("c_in,c_out", [(6, 48), (12, 12)])
def test_kpconv_kernel_matches_plain(dev, c_in, c_out):
    """Both stem shapes, one sample with no valid point at all, balls with
    fewer than 34 points and full ones: K6 within 1e-4 of max |plain|."""
    case = _kpconv_case(dev, c_in, c_out, seed=c_in, valid=(4000, 2500, 0))
    counts = case[3].sum(-1)
    assert int(counts.max()) == 34 and int(counts[case[3][..., 0]].min()) < 34
    before = kp.KPCONV_LAUNCHES
    out = kp.kpconv(*case)
    assert kp.KPCONV_LAUNCHES == before + 1
    with _cuda.plain_versions():
        ref = kp.kpconv(*case)
    assert kp.KPCONV_LAUNCHES == before + 1
    assert out.shape == (3, 4000, c_out) and float(ref.abs().max()) > 0.1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert (out[2] == 0).all() and (out[1, 2500:] == 0).all()


@pytest.mark.parametrize("c_in,c_out", [(16, 64), (9, 48), (1, 1)])
def test_kpconv_kernel_at_its_limits(dev, c_in, c_out):
    """C_in = 16 / C_out = 64 (the limits), the ScanNet stem's 9 -> 48 and
    1 -> 1: within 1e-4 of max |plain|, padded rows 0."""
    case = _kpconv_case(dev, c_in, c_out, seed=30 + c_in, n=3000, valid=(3000, 1700))
    out = kp.kpconv(*case)
    with _cuda.plain_versions():
        ref = kp.kpconv(*case)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert (out[1, 1700:] == 0).all()


@pytest.mark.parametrize("what", ["slots", "points", "c_in", "c_out"])
def test_kpconv_kernel_refuses_past_its_limits(dev, what):
    coord, feat, idx, nmask, points, weight, sigma = _kpconv_case(
        dev, 6, 48, seed=2, n=200, valid=(200, 120))
    if what == "slots":
        idx = torch.cat([idx, idx[..., :kp.MAX_SLOTS - 33]], -1)
        nmask = torch.cat([nmask, nmask[..., :kp.MAX_SLOTS - 33]], -1)
    elif what == "points":
        points = torch.cat([points, points[:kp.MAX_POINTS - 14]])
        weight = torch.cat([weight, weight[:kp.MAX_POINTS - 14]])
    elif what == "c_in":
        feat = feat.repeat(1, 1, 3)
        weight = weight.repeat(1, 3, 1)
    else:
        weight = weight.repeat(1, 1, 2)
    with pytest.raises(ValueError, match="kernel takes up to"):
        kp.kpconv(coord, feat, idx, nmask, points, weight, sigma)


def test_kpconv_kernel_refuses_grad(dev):
    case = list(_kpconv_case(dev, 6, 48, seed=1, n=300, valid=(300, 200)))
    case[5] = case[5].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        kp.kpconv(*case)


@pytest.mark.parametrize("residual", [False, True])
def test_kpconv_block_takes_kernel_in_eval_and_plain_in_training(dev, residual):
    torch.manual_seed(7)
    c_in = 48 if residual else 6
    block = st.KPConvBlock(c_in, 48, 0.04, 1.0, residual=residual).to(dev)
    coord, feat, *_ = _kpconv_case(dev, c_in, 48, seed=8, n=1500, valid=(1500, 900))
    mask = torch.arange(1500, device=dev)[None] < torch.tensor([[1500], [900]], device=dev)
    k1, before = geometry.KNN_LAUNCHES, kp.KPCONV_LAUNCHES
    block.eval()
    with torch.inference_mode():
        out = block(feat, coord, mask)
        with _cuda.plain_versions():
            ref = block(feat, coord, mask)
    assert (geometry.KNN_LAUNCHES, kp.KPCONV_LAUNCHES) == (k1 + 1, before + 1)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    with pytest.raises(RuntimeError, match="no backward"):
        block(feat, coord, mask)  # eval, a gradient asked of the kernel
    block.train()
    block(feat, coord, mask).sum().backward()
    assert kp.KPCONV_LAUNCHES == before + 1
    assert block.kpconv.weight.grad.abs().max() > 0


# -- K7: PT-v2 grouped vector attention ----------------------------------------


def _gva_case(dev, c, pe, seed, n=3000, valid=(3000, 1900), s=16):
    """q/k/v, coords, the s nearest as neighbours (s random valid rows past
    K1's 64; ~20% of the slots masked, every 7th query with none) and an
    eval attention module of width c with random weights and BatchNorm
    statistics."""
    gen = torch.Generator().manual_seed(seed)
    coord, mask = _cloud(seed, len(valid), n, list(valid), dev)
    if s <= 64:
        idx, d2 = geometry.knn(coord, coord, s, mask)
    else:
        idx = torch.stack([torch.randint(0, nv, (n, s), generator=gen) for nv in valid])
        idx, d2 = idx.to(dev, torch.int32), torch.zeros(idx.shape, device=dev)
    nmask = (torch.isfinite(d2) & mask[..., None]
             & (torch.rand(idx.shape, generator=gen) >= 0.2).to(dev))
    nmask[:, ::7] = False
    torch.manual_seed(seed)
    attn = ptv2.GroupedVectorAttention(c, c // 8, pe_multiplier=pe[0], pe_bias=pe[1])
    attn = chip_smoke.randomise_bn(attn, gen).to(dev).eval()
    q, k, v = (torch.randn((len(valid), n, c), generator=gen).to(dev)
               for _ in range(3))
    return (q, k, v, coord, idx, nmask, attn.linear_p_multiplier,
            attn.linear_p_bias, attn.weight_encoding, c // 8), attn


@pytest.mark.parametrize("pe", [(False, True), (True, False), (True, True), (False, False)])
@pytest.mark.parametrize("c,s,n", [(48, 16, 3000), (96, 16, 3000), (192, 16, 3000),
                                   (384, 16, 3000), (512, 16, 3000), (48, 12, 1001),
                                   (384, 12, 1001), (512, 8, 1001), (192, 70, 1001)])
def test_gva_kernel_matches_plain(dev, c, s, n, pe):
    """K7 within 1e-4 of max |plain| (f32 sums in another order, split-TF32
    products, BatchNorms folded), at every width in every branch
    combination, no positional encoding included; queries without a
    neighbour come out 0.  The ragged cases:
    S = 12 does not divide a tile's rows, S = 8 fills a tile with more
    queries, S = 70 > 64 rows takes two row chunks a query (merged by an
    online softmax), and B * N = 2,002 is no multiple of any tile's
    queries."""
    ragged = (s, n) != (16, 3000)
    case, _ = _gva_case(dev, c, pe, seed=c + 2 * pe[0] + pe[1] + ragged * s, n=n,
                        valid=(n, 2 * n // 3) if ragged else (3000, 1900), s=s)
    before = gva.GVA_LAUNCHES
    with torch.inference_mode():
        out = gva.grouped_vector_attention(*case)
        with _cuda.plain_versions():
            ref = gva.grouped_vector_attention(*case)
    assert gva.GVA_LAUNCHES == before + 1
    assert float(ref.abs().max()) > 0.1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert (out[:, ::7] == 0).all()


def test_gva_kernel_all_masked_batch(dev):
    case, _ = _gva_case(dev, 48, (False, True), seed=4)
    case = list(case)
    case[5] = torch.zeros_like(case[5])
    with torch.inference_mode():
        assert (gva.grouped_vector_attention(*case) == 0).all()


def test_gva_kernel_refuses_grad(dev):
    """A gradient asked of the inference-only kernel raises, through the
    inputs or the weights; under no_grad it runs."""
    case, _ = _gva_case(dev, 48, (False, True), seed=5, n=200, valid=(200, 150))
    case = list(case)
    with pytest.raises(RuntimeError, match="no backward"):
        gva.grouped_vector_attention(*case)      # the weights want a gradient
    case[0] = case[0].requires_grad_(True)
    with torch.no_grad():
        assert gva.grouped_vector_attention(*case).shape == (2, 200, 48)


def test_ptv2_block_takes_kernel_in_eval_and_plain_in_training(dev):
    """The dispatch of the inference-only kernel: eval under no_grad
    launches K7, eval with a gradient asked of it raises, a training block
    takes the plain version with batch statistics and gives a gradient."""
    torch.manual_seed(6)
    block = ptv2.Block(96, 12, pe_multiplier=True, pe_bias=True).to(dev)
    (q, _, _, coord, idx, nmask, *_), _ = _gva_case(
        dev, 96, (True, True), seed=6, n=500, valid=(500, 300))
    mask = torch.arange(500, device=dev)[None] < torch.tensor([[500], [300]], device=dev)
    before = gva.GVA_LAUNCHES
    block.eval()
    with torch.inference_mode():
        out = block(q, coord, idx, nmask, mask)
        with _cuda.plain_versions():
            ref = block(q, coord, idx, nmask, mask)
    assert gva.GVA_LAUNCHES == before + 1
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    with pytest.raises(RuntimeError, match="no backward"):
        block(q, coord, idx, nmask, mask)
    block.train()
    block(q, coord, idx, nmask, mask).sum().backward()
    assert gva.GVA_LAUNCHES == before + 1
    assert block.attn.linear_p_bias[3].weight.grad.abs().max() > 0


def test_grid_pool_coordinates_bit_equal_on_the_card(dev):
    """PT-v2's ``GridPool`` means its children's coordinates in row order:
    two forwards on the card and one on the CPU give the same pooled
    coordinates bit for bit (atomic adds took the children in any order,
    and a last-bit difference flipped a kNN tie at the next level in
    ``chip_smoke.py`` phase 11's kernels-against-plain check)."""
    coord, mask = _cloud(12, 2, 65536, [65536, 40000], dev)
    pool = ptv2.GridPool(16, 32, 0.06).to(dev).eval()
    feat = torch.randn(2, 65536, 16, device=dev, generator=torch.Generator(dev).manual_seed(12))
    with torch.inference_mode():
        runs = [pool(feat, coord, mask, capacity=32768)[1] for _ in range(2)]
        cpu = pool.cpu()(feat.cpu(), coord.cpu(), mask.cpu(), capacity=32768)[1]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0].cpu(), cpu)


def test_swin3d_forward_kernels_match_plain(dev):
    """A narrow five-layer Swin3D forward on the card over two surface
    samples (20,000 and 12,000 voxels): its four kNN poolings and four
    interpolations launch K1 (the level-0 pooling on the bound-pruned
    kernel), its logits within 1e-4 of max |logit| of the plain versions'
    and of the CPU's, its levels' pooled xyz and signal bit-equal to the
    CPU's (summed in row order)."""
    from pointcloudpdf_tpu_torch.models import build_model

    rng = np.random.RandomState(13)
    cells = np.array([(x, y, 0) for x in range(200) for y in range(150)]
                     + [(x, 0, z) for x in range(200) for z in range(1, 100)], np.int32)
    grid = np.zeros((2, 20480, 3), np.int32)
    counts = (20000, 12000)
    for b, c in enumerate(counts):
        grid[b, :c] = cells[rng.choice(len(cells), c, replace=False)]
    mask = np.arange(20480)[None] < np.array(counts)[:, None]
    batch = dict(grid_coord=torch.from_numpy(grid), mask=torch.from_numpy(mask),
                 feat=torch.from_numpy(rng.rand(2, 20480, 9).astype(np.float32)))
    torch.manual_seed(13)
    model = build_model(dict(type="Swin3D-v1m1", in_channels=9, num_classes=13,
                             depths=(1, 1, 1, 1, 1), channels=(16,) * 5, num_heads=(2,) * 5,
                             cRSE="XYZ_RGB_NORM", upsample="linear_attn")).eval()
    with torch.inference_mode():
        cpu_levels = model.levels(batch)
        cpu = model(batch)
        model = model.to(dev)
        on_dev = {k: v.to(dev) for k, v in batch.items()}
        launches, pruned = geometry.KNN_LAUNCHES, geometry.KNN_PRUNED_LAUNCHES
        out = model(on_dev)
        assert geometry.KNN_LAUNCHES == launches + 8
        assert geometry.KNN_PRUNED_LAUNCHES > pruned
        with _cuda.plain_versions():
            ref = model(on_dev)
        levels = model.levels(on_dev)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-4 * scale
    assert float((out.cpu() - cpu).abs().max()) <= 1e-4 * scale
    for a, b in zip(levels, cpu_levels):
        assert torch.equal(a.mask.cpu(), b.mask)
        assert torch.equal(a.xyz.cpu(), b.xyz) and torch.equal(a.signal.cpu(), b.signal)
