"""K4's backward in the order of work of its kernel
(``csrc/vector_attention_bwd.cu`` ``attn_bwd_kernel``), emulated in plain
PyTorch and held against ``torch.autograd`` of
``vector_attention_train_plain``.

The emulation follows the kernel: tiles of ``P // K`` whole queries
(``P`` pair rows, masked slots and the rows past the last query as rows
with a 0 flag), C in chunks of 64 channels, the three products
(``u = h2 W_w1``, ``dh2 = du W_w1^T``, ``d W_w1 = h2^T du``) and the
small ones (``h3 W_w2``, ``ds W_w2^T``, ``h3^T ds``) chunk by chunk, every
parameter cotangent summed per tile and then over the tiles.  In float32
each product runs in split TF32 as the kernel's ``mma.sync`` does: each
operand x = hi + lo, hi and lo = x - hi each rounded to TF32 by its bits,
and ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` summed in f32; in float64 the products are exact, and the decomposition
itself is checked to rounding noise.  No JAX and no card: the kernel's order of work, checked here on
the CPU, is what the card tests check on the card.
"""

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.ops import geometry
from pointcloudpdf_tpu_torch.ops import vector_attention as va

TOL_K4_X = 1e-4      # d x_q / x_k / x_v, relative to max |plain| (chip_smoke.py)
TOL_K4_PARAM = 1e-3  # parameter cotangents, relative to max |plain|
CHUNK = 64           # channels a chunk (Tile::CC)


def tile_rows(C):
    """Pair rows a tile (Tile::P)."""
    return 32 if C >= 512 else 64 if C >= 128 else 128


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as the kernel does on the bits of finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, split):
    """a @ b over the last two dims: split TF32 (``split``), one-pass TF32
    (``"one"``) or the dtype's own product."""
    if split == "one":
        return tf32(a) @ tf32(b)
    if not split:
        return a @ b
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def chunks_of(C):
    """The 64-channel chunks of C (Tile::CC), in the kernels' order."""
    return [slice(c0, min(C, c0 + CHUNK)) for c0 in range(0, C, CHUNK)]


def tile_pairs(idx, nmask, N, P, SS, s0=0, TQ=None):
    """The pair rows of every tile, both kernels' layout: TQ (P // SS unless
    given) whole queries a tile, row p of tile t is query t TQ + p // SS and
    slot s0 + p % SS (SS = K, or a row chunk of a query's slots where
    K > P); rows past the last query or the last slot, and masked slots,
    have a 0 flag.  Returns (query rows, flags, gathered rows), each
    (T, P)."""
    K = idx.shape[-1]
    M = nmask.numel() // K
    TQ = P // SS if TQ is None else TQ
    T = -(-M // TQ)
    p = torch.arange(P)
    q = torch.arange(T)[:, None] * TQ + p // SS              # (T, P)
    slot = (s0 + p % SS).expand(T, P)
    live = (p < TQ * SS) & (q < M) & (slot < K)
    qc = torch.where(live, q, torch.zeros_like(q))
    slot = torch.where(live, slot, torch.zeros_like(slot))
    flag = live & nmask.reshape(M, K)[qc, slot]
    j = torch.where(flag, (qc // N) * N + idx.reshape(M, K)[qc, slot].long(), 0)
    return qc, flag, j


def positional_hidden(xyz, qc, j, flag, p1_w, p1_b, s_p, t_p):
    """The positional MLP's first layer of every pair row: p_rel, z1, pre1
    and h (0-flag rows see p_rel = 0)."""
    prel = (xyz[j] - xyz[qc]) * flag[..., None].to(xyz.dtype)
    z1 = prel @ p1_w + p1_b
    pre1 = z1 * s_p + t_p
    return prel, z1, pre1, torch.relu(pre1)


def relation(xq, xk, qc, j, flag, h, p2_w, p2_b, cs):
    """r = x_k[j] - x_q + p_r of a chunk (0 on 0-flag rows), and p_r."""
    pr = p2_b[cs] + h @ p2_w[:, cs]
    return (xk[j, cs] - xq[qc, cs] + pr) * flag[..., None].to(xq.dtype), pr


def h2_of(r, s1, t1, cs):
    return torch.relu(r * s1[cs] + t1[cs])


def pass_a(xq, xk, qc, j, flag, h, p2_w, p2_b, w1_w, w1_b, s1, t1, split,
           each_chunk=None):
    """U = h2 W_w1 + b_w1 of every pair row as both kernels form it: C in
    64-channel chunks, each chunk's product added to the sum in order.
    ``each_chunk(cs, r, p_r)`` sees every chunk's relation."""
    u = 0
    for cs in chunks_of(xq.shape[-1]):
        r, pr = relation(xq, xk, qc, j, flag, h, p2_w, p2_b, cs)
        if each_chunk is not None:
            each_chunk(cs, r, pr)
        u = u + product(h2_of(r, s1, t1, cs), w1_w[cs], split)
    return u + w1_b


def tiled_backward(x_q, x_k, x_v, coord, idx, nmask, params, dout, split):
    """(d x_q, d x_k, d x_v, *d params in signature order), as the tiled
    kernel computes them, vectorised over the tiles."""
    (p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
     s_p, t_p, s1, t1, s2, t2) = params
    B, N, C = x_q.shape
    K = idx.shape[-1]
    G, P = C // 8, tile_rows(C)
    TQ = P // K
    M = B * N
    T = -(-M // TQ)
    dt = x_q.dtype
    xq, xk, xv, do = (t.reshape(M, C) for t in (x_q, x_k, x_v, dout))
    qc, flag, j = tile_pairs(idx, nmask, N, P, K)
    f = flag[..., None].to(dt)
    prel, z1, pre1, h = positional_hidden(coord.reshape(M, 3), qc, j, flag,
                                          p1_w, p1_b, s_p, t_p)

    # pass A: u over the chunks, dw
    dw = torch.zeros(T, P, G, dtype=dt)

    def add_dw(cs, r, pr):
        c = torch.arange(C)[cs]
        dw.index_add_(2, c % G, do[qc, cs] * (xv[j, cs] + pr) * f)

    u = pass_a(xq, xk, qc, j, flag, h, p2_w, p2_b, w1_w, w1_b, s1, t1, split,
               add_dw)
    pre3 = u * s2 + t2
    h3 = torch.relu(pre3)
    logit = product(h3, w2_w, split) + w2_b
    # the masked softmax of each query (K rows) and its backward
    lq = logit[:, :TQ * K].reshape(T, TQ, K, G)
    fq = flag[:, :TQ * K].reshape(T, TQ, K, 1)
    mx = torch.where(fq, lq, torch.full_like(lq, -torch.inf)).amax(2, keepdim=True)
    e = torch.where(fq, torch.exp(lq - torch.where(torch.isinf(mx), 0.0, mx)), 0.0)
    den = e.sum(2, keepdim=True)
    w = e / torch.where(den > 0, den, 1.0)
    dwq = dw[:, :TQ * K].reshape(T, TQ, K, G)
    ds = w * (dwq - (w * dwq).sum(2, keepdim=True))
    pad = torch.zeros(T, P - TQ * K, G, dtype=dt)
    w = torch.cat([w.reshape(T, TQ * K, G), pad], 1)
    ds = torch.cat([ds.reshape(T, TQ * K, G), pad], 1)

    # per-tile partials, summed over the tiles at the end
    part = {"w2_w": product(h3.transpose(1, 2), ds, split), "w2_b": ds.sum(1)}
    dh3 = product(ds, w2_w.t(), split)
    dpre3 = torch.where(pre3 > 0, dh3, 0.0)
    du = dpre3 * s2
    part.update(s2=(dpre3 * u).sum(1), t2=dpre3.sum(1), w1_b=du.sum(1))

    # pass B, chunk by chunk
    d_q = torch.zeros(M, C, dtype=dt)
    d_k = torch.zeros(M, C, dtype=dt)
    d_v = torch.zeros(M, C, dtype=dt)
    dw1 = torch.zeros(T, C, G, dtype=dt)
    dp2w = torch.zeros(T, 3, C, dtype=dt)
    dp2b, ds1, dt1 = (torch.zeros(T, C, dtype=dt) for _ in range(3))
    dh1 = torch.zeros(T, P, 3, dtype=dt)
    for cs in chunks_of(C):
        r, pr = relation(xq, xk, qc, j, flag, h, p2_w, p2_b, cs)
        c = torch.arange(C)[cs]
        dh2 = product(du, w1_w[cs].t(), split)
        dw1[:, cs] = product(h2_of(r, s1, t1, cs).transpose(1, 2), du, split)
        dpre2 = torch.where(r * s1[cs] + t1[cs] > 0, dh2, 0.0) * f
        dr = dpre2 * s1[cs]
        dv = do[qc, cs] * w[:, :, c % G] * f
        d_k[:, cs] += torch.zeros(M, c.numel(), dtype=dt).index_add_(
            0, j.reshape(-1), dr.reshape(-1, c.numel()))
        d_v[:, cs] += torch.zeros(M, c.numel(), dtype=dt).index_add_(
            0, j.reshape(-1), dv.reshape(-1, c.numel()))
        rows = dr[:, :TQ * K].reshape(T, TQ, K, -1).sum(2).reshape(T * TQ, -1)
        d_q[:, cs] = -rows[:M]
        dpr = dv + dr
        dp2w[:, :, cs] = h.transpose(1, 2) @ dpr
        dp2b[:, cs] = dpr.sum(1)
        ds1[:, cs] = (dpre2 * r).sum(1)
        dt1[:, cs] = dpre2.sum(1)
        dh1 = dh1 + dpr @ p2_w[:, cs].t()
    part.update(w1_w=dw1, p2_w=dp2w, p2_b=dp2b, s1=ds1, t1=dt1)
    # the positional MLP's first layer, row by row
    dpre1 = torch.where(pre1 > 0, dh1, 0.0) * f
    dz1 = dpre1 * s_p
    part.update(s_p=(dpre1 * z1).sum(1), t_p=dpre1.sum(1), p1_b=dz1.sum(1),
                p1_w=prel.transpose(1, 2) @ dz1)
    total = {k: v.sum(0) for k, v in part.items()}
    return (d_q.reshape(B, N, C), d_k.reshape(B, N, C), d_v.reshape(B, N, C),
            total["p1_w"], total["p1_b"], total["p2_w"], total["p2_b"],
            total["w1_w"], total["w1_b"], total["w2_w"], total["w2_b"],
            total["s_p"], total["t_p"], total["s1"], total["t1"],
            total["s2"], total["t2"])


def _case(C, K, seed, B=2, N=37):
    """Seeded inputs: a masked tail in every odd sample, ~10% of the slots
    masked, one query with no valid slot; N * B is no multiple of the
    tile's queries."""
    rng = np.random.RandomState(seed)
    G = C // 8
    valid = [N - 9 * (b % 2) for b in range(B)]
    coord = (rng.rand(B, N, 3) * 2).astype(np.float32)
    mask = np.arange(N)[None] < np.array(valid)[:, None]
    coord[~mask] = 0
    coord, mask = torch.from_numpy(coord), torch.from_numpy(mask)
    idx, d2 = geometry.knn(coord, coord, K, mask)
    nmask = (torch.isfinite(d2) & mask[..., None]
             & torch.from_numpy(rng.rand(B, N, K) >= 0.1))
    nmask[0, 3] = False

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (shift + scale * rng.standard_normal(shape)).astype(np.float32))

    feats = [t(B, N, C) for _ in range(3)]
    params = [t(3, 3, scale=0.5), t(3, scale=0.1), t(3, C, scale=0.5),
              t(C, scale=0.1), t(C, G, scale=C ** -0.5), t(G, scale=0.1),
              t(G, G, scale=G ** -0.5), t(G, scale=0.1),
              t(3, scale=0.1, shift=1.0), t(3, scale=0.1),
              t(C, scale=0.1, shift=1.0), t(C, scale=0.1),
              t(G, scale=0.1, shift=1.0), t(G, scale=0.1)]
    nmask = va.mask_off_relu_kinks(*feats, coord, idx, nmask, *params)
    return feats, coord, idx, nmask, params, t(B, N, C)


def _plain_grads(feats, coord, idx, nmask, params, dout):
    leaves = [x.double().requires_grad_() for x in (*feats, *params)]
    out = va.vector_attention_train_plain(*leaves[:3], coord.double(), idx,
                                          nmask, *leaves[3:])
    return torch.autograd.grad(out, leaves, dout.double())


def _worst(got, want):
    """Worst error of d x and of d params, each relative to the plain
    tensor's max; w2_b's exact gradient is 0 (a softmax ignores a shift of
    its logits), so it is held to w2_w's scale."""
    worst = [0.0, 0.0]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        scale = float(want[3 + 6 if i == 3 + 7 else i].abs().max())
        err = float((a.double() - b).abs().max()) / scale
        worst[i >= 3] = max(worst[i >= 3], err)
    return worst


@pytest.mark.parametrize("C,K", [(32, 8), (64, 8), (64, 16), (512, 8), (512, 16)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_backward_matches_autograd(C, K, dtype):
    feats, coord, idx, nmask, params, dout = _case(C, K, seed=C + K)
    want = _plain_grads(feats, coord, idx, nmask, params, dout)
    got = tiled_backward(*(x.to(dtype) for x in feats), coord.to(dtype), idx,
                         nmask, [x.to(dtype) for x in params], dout.to(dtype),
                         split=dtype == torch.float32)
    err_x, err_p = _worst(got, want)
    if dtype == torch.float64:
        # the decomposition is exact algebra: float64 rounding noise only
        assert err_x <= 1e-10 and err_p <= 1e-10, (err_x, err_p)
    else:
        assert err_x <= TOL_K4_X and err_p <= TOL_K4_PARAM, (err_x, err_p)
    # the query with no valid slot takes no gradient
    assert (got[0][0, 3] == 0).all()


def test_tiles_hold_whole_queries_and_pad():
    """K = 5 leaves P % K rows of padding in every tile; K = 16 at C = 512
    fills each tile with two queries; B * N = 74 is no multiple of either."""
    for C, K in ((64, 5), (512, 16)):
        feats, coord, idx, nmask, params, dout = _case(C, K, seed=3)
        want = _plain_grads(feats, coord, idx, nmask, params, dout)
        got = tiled_backward(*(x.double() for x in feats), coord.double(), idx,
                             nmask, [x.double() for x in params],
                             dout.double(), split=False)
        assert max(_worst(got, want)) <= 1e-10


def test_one_pass_tf32_misses_the_tolerance():
    """The reason for the split: the same order of work with one-pass TF32
    products (10-bit mantissas) misses the f32 tolerances that split TF32
    meets on the same inputs."""
    feats, coord, idx, nmask, params, dout = _case(256, 16, seed=4)
    want = _plain_grads(feats, coord, idx, nmask, params, dout)
    one = _worst(tiled_backward(*feats, coord, idx, nmask, params, dout,
                                split="one"), want)
    three = _worst(tiled_backward(*feats, coord, idx, nmask, params, dout,
                                  split=True), want)
    assert three[0] <= TOL_K4_X and three[1] <= TOL_K4_PARAM, three
    assert one[0] > TOL_K4_X, one
