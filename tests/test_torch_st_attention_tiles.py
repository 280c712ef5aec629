"""K5 in the order of work of its kernel (``csrc/st_attention.cu``
``st_attention_kernel``), emulated in plain PyTorch and held against
``st_attention_plain``.

The emulation follows the kernel: head groups of ``HG`` heads, tiles of
``TQ`` queries (the last one padded with rows that hold no query), each
query's valid slots compacted in slot order with their bins computed once
for the group (f32, the plain version's operations), the query term as
the product QT = (s q) Tq^T over the 3 x 2L table rows padded to a
multiple of 8 (read back at the pair's three bins), the k row dotted pair
by pair with s q plus the sum of its three Tk rows, the softmax in two
passes (the max, then exp and the sum) over all of a query's logits, the
value term as a histogram of the unnormalised probabilities by bin times
Tv (in float32 the kernel's integer histogram, p in fixed point of 2^-24;
its k steps in two halves, as the block's warps split them), and sum_j
p_j v_j beside it, divided by the sum at the end.  In float32 each
tensor-core product runs in split TF32 as the kernel's ``mma.sync`` does
(each operand x = hi + lo, hi and lo = x - hi each rounded to TF32 by its
bits, ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` summed in f32, a k-step of 8
at a time); in float64 the products are exact, and the decomposition
itself is checked to rounding noise against the plain version in float64.
No JAX and no card.
"""

import itertools

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.ops import geometry
from pointcloudpdf_tpu_torch.ops import st_attention as sa

TOL_K5 = 1e-4   # relative to max |plain| (chip_smoke.py)
HG, TQ = 2, 32  # heads a block, queries a tile (the kernel's)
FIX = 2.0 ** 24  # the value histogram's fixed point (the kernel's kFix)
TABLES = list(itertools.product((False, True), repeat=3))


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as the kernel does on the bits of finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, split):
    """a @ b a k-step of 8 at a time, each step's product summed from 0
    and added to the f32 sum: split TF32 (``split``), one-pass TF32
    (``"one"``) or the dtype's own product."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=a.dtype)
    for k0 in range(0, a.shape[-1], 8):
        x, y = a[..., k0:k0 + 8], b[k0:k0 + 8]
        if split == "one":
            step = tf32(x) @ tf32(y)
        elif split:
            xh, yh = tf32(x), tf32(y)
            xl, yl = tf32(x - xh), tf32(y - yh)
            step = xl @ yh + xh @ yl + xh @ yh
        else:
            step = x @ y
        acc = acc + step
    return acc


def table_rows(num_bins):
    """Table rows a head in shared memory: 3 x 2L padded to mma's 8."""
    return -(-3 * num_bins // 8) * 8


def tile_lists(coord, key_idx, key_mask, window, quant, num_bins):
    """The kernel's lists, (T, TQ, K) each: a query's valid slots first, in
    slot order, with their key rows (of the flattened batch) and their three
    bins, computed once a (query, slot); the count of valid slots a query."""
    B, N, K = key_idx.shape
    M = B * N
    T = -(-M // TQ)
    m = torch.arange(T * TQ)
    live = m < M
    mc = torch.where(live, m, 0)
    valid = key_mask.reshape(M, K)[mc] & live[:, None]
    rows = (mc // N)[:, None] * N + key_idx.reshape(M, K)[mc].long()
    rows = torch.where(valid, rows, 0)
    c32 = coord.reshape(M, 3).float()
    rel = c32[mc][:, None, :] - c32[rows]
    bins = torch.floor(geometry.divide_exact(rel + 2 * window - 1e-4, quant))
    bins = torch.clamp(bins, 0, num_bins - 1).long()
    # compaction: the valid slots first, each in its slot order
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    count = valid.sum(1)
    on = torch.arange(K)[None] < count[:, None]
    rows = torch.where(on, rows.gather(1, order), 0)
    bins = torch.where(on[..., None], bins.gather(1, order[..., None].expand(-1, -1, 3)), 0)
    shape = (T, TQ)
    return (rows.reshape(*shape, K), bins.reshape(*shape, K, 3), on.reshape(*shape, K),
            count.reshape(shape))


def head_table(t, heads, num_bins, dt):
    """A group's slices of a (3, 2L, C) table as (HG, R, 16) rows a*2L + b,
    zero rows to R (or None)."""
    if t is None:
        return None
    R = table_rows(num_bins)
    C = t.shape[-1]
    out = torch.zeros(len(heads), R, 16, dtype=dt)
    for e, h in enumerate(heads):
        out[e, :3 * num_bins] = t.to(dt).reshape(3 * num_bins, C)[:, 16 * h:16 * h + 16]
    return out


def tiled_st_attention(q, k, v, coord, key_idx, key_mask, tq, tk, tv,
                       num_heads, window, quant, num_bins, split):
    """(B, N, C) as the kernel computes it, vectorised over the tiles."""
    B, N, C = q.shape
    assert C == 16 * num_heads and num_heads % HG == 0
    dt = q.dtype
    M = B * N
    rows, bins, on, count = tile_lists(coord, key_idx, key_mask, window, quant, num_bins)
    T, _, K = on.shape
    R = table_rows(num_bins)
    b = bins + torch.arange(3) * num_bins                     # table rows by axis
    xq, xk, xv = (torch.cat([t.reshape(M, C), torch.zeros(T * TQ - M, C, dtype=dt)])
                  for t in (q, k, v))
    out = torch.zeros(T, TQ, C, dtype=dt)
    for g in range(num_heads // HG):
        heads = range(HG * g, HG * g + HG)
        Tq, Tk, Tv = (head_table(t, heads, num_bins, dt) for t in (tq, tk, tv))
        for e, h in enumerate(heads):
            ch = slice(16 * h, 16 * h + 16)
            qs = (xq[:, ch] * 0.25).reshape(T, TQ, 16)        # s = 16 ** -0.5
            kr, vr = xk[rows, ch], xv[rows, ch]                # (T, TQ, K, 16)
            # k . (s q + the pair's three Tk rows)
            t = qs[:, :, None, :]
            if Tk is not None:
                t = t + Tk[e][b].sum(-2)
            logit = (kr * t).sum(-1)
            if Tq is not None:
                qt = product(qs, Tq[e].T, split)               # (T, TQ, R)
                logit = logit + qt.gather(2, b.reshape(T, TQ, 3 * K)).reshape(T, TQ, K, 3).sum(-1)
            # the softmax in two passes over the compacted slots
            mx = torch.where(on, logit, -torch.inf).amax(-1, keepdim=True)
            p = torch.where(on, torch.exp(logit - torch.where(count[..., None] > 0, mx, 0.0)),
                            0.0)
            total = p.sum(-1)
            acc = (p[..., None] * vr).sum(-2)
            if Tv is not None:
                # float64: exact sums; float32: the kernel's integer
                # histogram, p in fixed point of 2^-24
                w = p if not split else torch.round(p * FIX).to(torch.int64)
                hist = torch.zeros(T, TQ, R, dtype=w.dtype)
                hist.scatter_add_(2, b.reshape(T, TQ, 3 * K),
                                  w[..., None].expand(-1, -1, -1, 3).reshape(T, TQ, 3 * K))
                hist = hist.to(dt) / FIX if split else hist
                half = 8 * -(-(R // 8) // 2)
                acc = (acc + product(hist[..., :half], Tv[e][:half], split)
                       + product(hist[..., half:], Tv[e][half:], split))
            out[..., ch] = torch.where(total[..., None] > 0,
                                       acc / torch.where(total > 0, total, 1.0)[..., None], 0.0)
    return out.reshape(T * TQ, C)[:M].reshape(B, N, C)


def _case(C, tables, seed, B=2, N=40, K=48, window=0.16, quant=0.01, grid=False):
    """Seeded inputs at width C: points in a 30 cm cube, a masked tail in
    sample 1, its K nearest points as keys with ~20% of the slots masked,
    every 7th query without a key; ``grid``: coordinates on a 1 cm grid,
    where bin boundaries are common."""
    rng = np.random.RandomState(seed)
    valid = [N, N - 9][:B] + [N] * max(B - 2, 0)
    coord = (rng.rand(B, N, 3) * 0.3).astype(np.float32)
    if grid:
        coord = (np.round(coord * 100) / 100).astype(np.float32)
    mask = np.arange(N)[None] < np.array(valid)[:, None]
    coord[~mask] = 0
    coord, mask = torch.from_numpy(coord), torch.from_numpy(mask)
    key_idx, d2 = geometry.knn(coord, coord, min(K, N), mask)
    if K > N:  # more slots than points: the extra slots masked
        key_idx = torch.cat([key_idx, key_idx[..., :K - N]], -1)
        d2 = torch.cat([d2, torch.full_like(d2[..., :K - N], torch.inf)], -1)
    key_mask = (torch.isfinite(d2) & mask[..., None]
                & torch.from_numpy(rng.rand(B, N, K) >= 0.2))
    key_mask[:, ::7] = False
    num_bins = 2 * int((2 * window + 1e-4) // quant)
    qkv = [torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32))
           for _ in range(3)]
    tabs = [torch.from_numpy((0.3 * rng.standard_normal((3, num_bins, C))).astype(np.float32))
            if on else None for on in tables]
    return (*qkv, coord, key_idx, key_mask, *tabs, C // 16, window, quant, num_bins)


def _run(case, dtype, split):
    """(the emulation in ``dtype``, st_attention_plain in float64)."""
    def cast(x):
        return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x

    c64 = [x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in case]
    c64[3] = case[3]  # coordinates stay f32: the bins are the f32 ones
    want = sa.st_attention_plain(*c64)
    args = [cast(x) for x in case]
    args[3] = case[3]
    return tiled_st_attention(*args, split=split), want


def _err(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


def _check(case, dtype):
    got, want = _run(case, dtype, split=dtype == torch.float32)
    err = _err(got, want)
    # float64: the decomposition is exact algebra, rounding noise only
    assert err <= (1e-12 if dtype == torch.float64 else TOL_K5), err
    return got


@pytest.mark.parametrize("tables", TABLES, ids=lambda t: "".join("qkv"[i] if on else "-" for i, on in enumerate(t)))
@pytest.mark.parametrize("C", [32, 96, 384])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_st_attention_matches_plain(C, tables, dtype):
    """Every on/off combination of the three tables at three widths (one,
    three and twelve head groups); the queries without a key and the
    masked tail come out 0."""
    case = _case(C, tables, seed=C + 4 * tables[0] + 2 * tables[1] + tables[2])
    got = _check(case, dtype)
    assert (got[:, ::7] == 0).all() and (got[1, -9:] == 0).all()


@pytest.mark.parametrize("K", [5, 48, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_slot_counts(K, dtype):
    """K = 5 (one partial round of slots), 48 (the ST path's 32 + 16) and 64
    (the kernel's most: two full rounds of a warp's lanes); at K = 64 with
    40 points a sample the slots past the cloud are masked."""
    _check(_case(96, (True, True, True), seed=K, K=K), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_all_masked_sample_and_partial_tiles(dtype):
    """Three samples of 29 points (87 queries: the last tile holds 23, the
    rest padding); sample 1 with every slot masked comes out 0."""
    case = list(_case(192, (True, True, True), seed=11, B=3, N=29))
    case[5] = case[5].clone()
    case[5][1] = False
    got = _check(case, dtype)
    assert (got[1] == 0).all() and (got[0].abs().amax(-1) > 0).sum() > 20


@pytest.mark.parametrize("window,quant", [(0.16, 0.01), (0.1, 0.005)])
def test_bins_on_grid_coordinates(window, quant):
    """Coordinates on a 1 cm grid put many pairs near a bin boundary: the
    bins computed once a (query, slot) are the plain version's at every
    (query, slot, axis), at 2L = 64 (S3DIS) and 80 (ScanNet: 96 rows a
    table, 12 k-steps, split 6 + 6), and the output agrees."""
    case = _case(64, (True, True, True), seed=5, grid=True, window=window, quant=quant)
    coord, key_idx, key_mask, num_bins = case[3], case[4], case[5], case[-1]
    rows, bins, on, count = tile_lists(coord, key_idx, key_mask, window, quant, num_bins)
    want = sa.st_attention_bins(coord, key_idx, window, quant, num_bins)
    B, N, K = key_idx.shape
    want = want.reshape(B * N, K, 3)
    flat_mask = key_mask.reshape(B * N, K)
    for m in range(B * N):
        t, i = divmod(m, TQ)
        n = int(count[t, i])
        assert n == int(flat_mask[m].sum())
        assert torch.equal(bins[t, i, :n], want[m][flat_mask[m]])
    assert len(torch.unique(want)) > 20
    _check(case, torch.float32)
    _check(case, torch.float64)


def test_one_pass_tf32_is_not_enough():
    """What the split buys: the same order of work with one-pass TF32
    products (10-bit mantissas) misses TOL_K5 (1.9e-4 of max |plain| on
    these inputs) where split TF32 meets it (1.9e-7)."""
    case = _case(96, (True, False, True), seed=3)
    one = _err(*_run(case, torch.float32, split="one"))
    three = _err(*_run(case, torch.float32, split=True))
    assert three <= TOL_K5 / 10, three
    assert one > TOL_K5, one


def test_kernel_limits_raise():
    """Every width the wrapper takes has an even number of heads (the
    kernel's head groups); more than 64 slots or 80 bins is refused
    before any launch."""
    assert all((c // sa.HEAD_DIM) % HG == 0 for c in sa._WIDTHS)
    case = list(_case(32, (True, True, True), seed=1, N=70, K=65))
    with torch.no_grad(), pytest.raises(ValueError, match="64 key slots"):
        sa._st_attention_cuda(*case)
    case = list(_case(32, (True, True, True), seed=1, window=0.22, quant=0.01))
    assert case[-1] == 88
    with torch.no_grad(), pytest.raises(ValueError, match="80 bins"):
        sa._st_attention_cuda(*case)
