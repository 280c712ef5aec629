"""K7 in the order of work of its kernel (``csrc/gva.cu`` ``gva_kernel``),
emulated in plain PyTorch and held against ``gva_plain`` in eval mode.

The emulation follows the kernel: tiles of ``TQ`` whole queries x ``SS``
slots in ``P`` pair rows (masked slots, slots past S and rows past the last
query as rows with a 0 flag; where S > P a query's slots come in row chunks
merged by an online softmax), each positional encoding's ``H W2`` over
Y's column chunks of ``NC`` channels and W2's k-slabs of ``KS`` rows, rel
and peb formed chunk by chunk and ``rel W_e1`` accumulated over the chunks,
then the G -> G layer, the masked softmax and the aggregation closed in the
tile; each positional encoding's first layer has its BatchNorm folded into
its weights, as the kernel's.  In float32 each tensor-core product runs in split TF32 as the
kernel's ``mma.sync`` does (each operand x = hi + lo, hi and lo = x - hi
each rounded to TF32 by its bits, ``a_lo b_hi + a_hi b_lo + a_hi b_hi``
summed in f32); in float64 the products are exact, and the decomposition
itself is checked to rounding noise.  No JAX and no card.
"""

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.models.norm import MaskedBatchNorm
from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2
from pointcloudpdf_tpu_torch.ops import geometry, gva

TOL_K7 = 1e-4   # relative to max |plain| (chip_smoke.py)
BRANCHES = [(False, True), (True, False), (True, True), (False, False)]


def tile_shape(C):
    """(P, NC, KS): pair rows a tile, channels a chunk, W2 rows a slab
    (the kernel's Tile<C>)."""
    P = 128 if C <= 96 else 64
    wc = 8 // (P // 16)
    wn = 6 if C == 48 else 8 if C == 384 else 4
    return P, 8 * wn * wc, 16


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as the kernel does on the bits of finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, split):
    """a @ b: split TF32 (``split``), one-pass TF32 (``"one"``) or the
    dtype's own product."""
    if split == "one":
        return tf32(a) @ tf32(b)
    if not split:
        return a @ b
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def tiled_gva(q, k, v, coord, idx, nmask, pe_multiplier, pe_bias,
              weight_encoding, split):
    """(B, N, C) as the tiled kernel computes it, vectorised over the
    tiles."""
    B, N, C = q.shape
    S = idx.shape[-1]
    G = C // 8
    P, NC, KS = tile_shape(C)
    SS = min(S, P)
    TQ = min(P // SS, P // 8)
    M = B * N
    T = -(-M // TQ)
    dt = q.dtype
    dev = q.device
    xq, xk, xv = (t.reshape(M, C) for t in (q, k, v))
    xyz = coord.reshape(M, 3)
    branches = [gva._folded(seq, (3, C), dev) for seq in (pe_multiplier, pe_bias)
                if seq is not None]
    mul_on, bias_on = pe_multiplier is not None, pe_bias is not None
    e1w, e1b, es, et, e2w, e2b = gva._folded(weight_encoding, (C, G), dev)
    out = torch.zeros(T * TQ, C, dtype=dt)
    run_max = torch.full((T, TQ, G), -torch.inf, dtype=dt)
    run_sum = torch.zeros(T, TQ, G, dtype=dt)
    p = torch.arange(P)
    qi, si = p // SS, p % SS
    m = torch.arange(T)[:, None] * TQ + qi                    # (T, P)
    mc = torch.where(m < M, m, torch.zeros_like(m))
    for s0 in range(0, S, SS):
        s = s0 + si
        live = (qi < TQ) & (m < M) & (s < S)
        sc = torch.where(s < S, s, torch.zeros_like(s)).expand(T, P)
        flag = live & nmask.reshape(M, S)[mc, sc]
        j = torch.where(flag, (mc // N) * N + idx.reshape(M, S)[mc, sc].long(), 0)
        f = flag[..., None]
        rp = (xyz[j] - xyz[mc]) * f.to(dt)
        ea = torch.zeros(T, P, G, dtype=dt)
        peb = torch.zeros(T, P, C, dtype=dt)
        for c0 in range(0, C, NC):
            cs = slice(c0, c0 + NC)
            ys = []
            for w1, b1, s1, t1, w2, _ in branches:
                acc = torch.zeros(T, P, NC, dtype=dt)
                for k0 in range(0, C, KS):
                    kk = slice(k0, k0 + KS)
                    # the first layer with its BatchNorm folded in
                    h = torch.relu(b1[kk] * s1[kk] + t1[kk] + rp @ (w1[:, kk] * s1[kk]))
                    acc = acc + product(h, w2[kk, cs], split)
                ys.append(acc)
            x = xk[j, cs] - xq[mc, cs]
            if mul_on:
                x = x * (ys[0] + branches[0][5][cs])
            if bias_on:
                pb = ys[-1] + branches[-1][5][cs]
                x = x + pb
                peb[..., cs] = pb
            rel = torch.where(f, x, 0.0)
            ea = ea + product(rel, e1w[cs], split)
        a = torch.relu((ea + e1b) * es + et)
        logit = a @ e2w + e2b                                 # CUDA cores
        # the masked softmax of each (query, group) over this row chunk,
        # merged into the running max and sum
        lq = logit[:, :TQ * SS].reshape(T, TQ, SS, G)
        fq = flag[:, :TQ * SS].reshape(T, TQ, SS, 1)
        mx = torch.where(fq, lq, -torch.inf).amax(2)
        nm = torch.maximum(run_max, mx)
        scale = torch.where(torch.isinf(nm), 1.0, torch.exp(run_max - nm))
        e = torch.where(fq, torch.exp(lq - torch.where(torch.isinf(nm), 0.0, nm)[:, :, None]), 0.0)
        run_sum = run_sum * scale + e.sum(2)
        run_max = nm
        ve = xv[j[:, :TQ * SS]] + peb[:, :TQ * SS]
        ve = torch.where(fq.reshape(T, TQ * SS, 1), ve, 0.0).reshape(T, TQ, SS, G, 8)
        contrib = (e[..., None] * ve).sum(2).reshape(T * TQ, C)
        out = out * scale.repeat_interleave(8, -1).reshape(T * TQ, C) + contrib
    den = run_sum.repeat_interleave(8, -1).reshape(T * TQ, C)
    out = torch.where(den > 0, out / torch.where(den > 0, den, 1.0), 0.0)
    return out[:M].reshape(B, N, C)


def _case(C, pe, S, seed, B=2, N=40):
    """Seeded inputs and an eval attention module of width C (random
    weights, BatchNorm affines and running statistics): a masked tail in
    sample 1, ~10% of the slots masked, one query with no valid slot."""
    rng = np.random.RandomState(seed)
    valid = [N, N - 9]
    coord = (rng.rand(B, N, 3) * 2).astype(np.float32)
    mask = np.arange(N)[None] < np.array(valid)[:, None]
    coord[~mask] = 0
    coord, mask = torch.from_numpy(coord), torch.from_numpy(mask)
    idx, d2 = geometry.knn(coord, coord, S, mask)
    nmask = (torch.isfinite(d2) & mask[..., None]
             & torch.from_numpy(rng.rand(B, N, S) >= 0.1))
    nmask[0, 3] = False
    torch.manual_seed(seed)
    attn = ptv2.GroupedVectorAttention(C, C // 8, pe_multiplier=pe[0], pe_bias=pe[1])
    with torch.no_grad():
        for bn in attn.modules():
            if isinstance(bn, MaskedBatchNorm):
                n = bn.num_features
                bn.weight.copy_(torch.from_numpy(0.5 + rng.rand(n)))
                bn.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(n)))
                bn.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(n)))
                bn.running_var.copy_(torch.from_numpy(0.5 + 1.5 * rng.rand(n)))
    attn.eval()
    qkv = [torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32))
           for _ in range(3)]
    return qkv, coord, idx, nmask, attn


def _run(case, dtype, split):
    """(the emulation in ``dtype``, gva_plain in float64)."""
    qkv, coord, idx, nmask, attn = case
    with torch.no_grad():
        attn.double()
        want = gva.gva_plain(*(t.double() for t in qkv), coord.double(), idx,
                             nmask, attn.linear_p_multiplier, attn.linear_p_bias,
                             attn.weight_encoding, attn.groups)
        attn.to(dtype)
        got = tiled_gva(*(t.to(dtype) for t in qkv), coord.to(dtype), idx, nmask,
                        attn.linear_p_multiplier, attn.linear_p_bias,
                        attn.weight_encoding, split)
    return got, want


def _err(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("pe", BRANCHES, ids=["bias", "mul", "both", "none"])
@pytest.mark.parametrize("C", [48, 192, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_gva_matches_plain(C, pe, dtype):
    case = _case(C, pe, 16, seed=C + 2 * pe[0] + pe[1])
    got, want = _run(case, dtype, split=dtype == torch.float32)
    err = _err(got, want)
    if dtype == torch.float64:
        # the decomposition is exact algebra: float64 rounding noise only
        assert err <= 1e-12, err
    else:
        assert err <= TOL_K7, err
    # the query with no valid slot, and the masked tail, come out 0
    assert (got[0, 3] == 0).all() and (got[1, -9:] == 0).all()


@pytest.mark.parametrize("C,S", [(48, 12), (192, 24), (192, 70), (512, 8)])
def test_tiles_hold_whole_queries_and_pad(C, S):
    """S = 12 and 24 leave P % S rows of padding in every tile; S = 70 > P
    = 64 takes two row chunks a query, merged by the online softmax; S = 8
    at C = 512 fills a tile with 8 queries.  B * N is no multiple of any
    tile's queries."""
    case = _case(C, (True, True), S, seed=S, N=80 if S > 40 else 40)
    got, want = _run(case, torch.float64, split=False)
    assert _err(got, want) <= 1e-12
    got32, want32 = _run(case, torch.float32, split=True)
    assert _err(got32, want32) <= TOL_K7


def test_one_pass_tf32_at_c384():
    """What the split buys: at C = 384 (pe_bias, as PT-v2m2) the same
    order of work with one-pass TF32 products (10-bit mantissas) misses
    TOL_K7 (1.6e-4 of max |plain| on these inputs) where split TF32 meets
    it (1.9e-7)."""
    case = _case(384, (False, True), 16, seed=7)
    one = _err(*_run(case, torch.float32, split="one"))
    three = _err(*_run(case, torch.float32, split=True))
    assert three <= TOL_K7, three
    assert one > TOL_K7, one


def test_split_pairs_are_the_kernels():
    """The wrapper's split of W2 into (hi, lo) is the kernel's rule (the
    emulation's ``tf32``), and hi + lo holds x to ~2^-21."""
    x = torch.from_numpy(np.random.RandomState(1).standard_normal((6, 10)).astype(np.float32))
    pairs = gva.split_tf32(x).reshape(6, 10, 2)
    assert torch.equal(pairs[..., 0], tf32(x))
    assert torch.equal(pairs[..., 1], tf32(x - tf32(x)))
    err = (pairs.double().sum(-1) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21


def test_packing_once_a_module_and_again_on_change():
    """``packed_params`` packs once a set of eval modules, packs again when a
    weight or a running statistic changes in place, refuses a module in
    training mode, and packs modules made under inference mode anew."""
    *_, attn = _case(48, (True, True), 8, seed=3, N=12)
    mlps = (attn.linear_p_multiplier, attn.linear_p_bias, attn.weight_encoding)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    first = gva.packed_params(*mlps, 48, 6)
    assert gva.packed_params(*mlps, 48, 6) is first
    assert same(first, gva.pack_params(*mlps, 48, 6))
    with torch.no_grad():
        attn.linear_p_bias[3].weight.add_(1.0)
    second = gva.packed_params(*mlps, 48, 6)
    assert second is not first and not same(second, first)
    assert same(second, gva.pack_params(*mlps, 48, 6))
    attn.weight_encoding[1].norm.running_var.mul_(2.0)
    third = gva.packed_params(*mlps, 48, 6)
    assert third is not second and same(third, gva.pack_params(*mlps, 48, 6))
    attn.train()
    with pytest.raises(ValueError, match="eval mode"):
        gva.packed_params(*mlps, 48, 6)
    # modules made under inference mode (no version counters) pack anew
    with torch.inference_mode():
        fresh = ptv2.GroupedVectorAttention(48, 6, pe_multiplier=True).eval()
        mlps = (fresh.linear_p_multiplier, fresh.linear_p_bias, fresh.weight_encoding)
        assert same(gva.packed_params(*mlps, 48, 6), gva.pack_params(*mlps, 48, 6))
