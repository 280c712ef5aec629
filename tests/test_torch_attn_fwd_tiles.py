"""K3, the vector attention's forward, in the order of work of its kernel
(``csrc/vector_attention.cu`` ``attn_kernel``), emulated in plain PyTorch
and held against ``vector_attention_plain``.

The emulation follows the kernel: a warp's task of 16 pair rows, TQ whole
queries of K slots (at most two; masked slots and the rows past the last
query as rows with a 0 flag), or, where K > 16, one query with its slots in
row chunks of 16 merged by an online softmax; U = h2 W_w1 over C as the
backward forms it (``test_torch_attn_bwd_tiles.pass_a``, split-TF32
products in float32), the logits, the masked softmax closed in the task
with the sums of w and of w h over each (query, group), and the
aggregation: the weighted x_v rows, plus the weighted p_r from those sums
(sum_j w p_r[j][c] = b_p2[c] sum_j w + sum_a W_p2[a][c] sum_j w h_a).  In
float64 the products are exact, and the order of work itself is checked to
rounding noise.  No JAX and no card.  Also here: the packing of an eval
layer's parameters, made once a layer.
"""

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.models.norm import MaskedBatchNorm
from pointcloudpdf_tpu_torch.models.point_transformer import PointTransformerLayer
from pointcloudpdf_tpu_torch.models.utils.structure import Points
from pointcloudpdf_tpu_torch.ops import geometry
from pointcloudpdf_tpu_torch.ops import vector_attention as va
from test_torch_attn_bwd_tiles import (_case, pass_a, positional_hidden,
                                       product, tf32, tile_pairs)

TOL_K3 = 1e-4   # relative to max |plain| (chip_smoke.py)
ROWS = 16       # pair rows a task (the kernel's kRows)
TQW = 2         # whole queries a task, at most (kTQW)


def tiled_forward(x_q, x_k, x_v, coord, idx, nmask, params, split):
    """(B, N, C) as the kernel computes it, vectorised over the tasks."""
    (p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
     s_p, t_p, s1, t1, s2, t2) = params
    B, N, C = x_q.shape
    K = idx.shape[-1]
    G = C // 8
    SS = min(K, ROWS)           # slots a task
    TQ = min(ROWS // SS, TQW)   # whole queries a task
    M = B * N
    T = -(-M // TQ)
    dt = x_q.dtype
    xq, xk, xv = (t.reshape(M, C) for t in (x_q, x_k, x_v))
    xyz = coord.reshape(M, 3)
    acc = torch.zeros(T, TQ, C, dtype=dt)       # sum of w x_v
    sums = torch.zeros(T, TQ, G, 4, dtype=dt)   # sum of w, w h_0, w h_1, w h_2
    run_max = torch.full((T, TQ, G), -torch.inf, dtype=dt)
    for s0 in range(0, K, SS):
        qc, flag, j = tile_pairs(idx, nmask, N, ROWS, SS, s0, TQ)
        h = positional_hidden(xyz, qc, j, flag, p1_w, p1_b, s_p, t_p)[-1]
        u = pass_a(xq, xk, qc, j, flag, h, p2_w, p2_b, w1_w, w1_b, s1, t1, split)
        logit = product(torch.relu(u * s2 + t2), w2_w, split) + w2_b
        lq = logit[:, :TQ * SS].reshape(T, TQ, SS, G)
        fq = flag[:, :TQ * SS].reshape(T, TQ, SS, 1)
        hq = h[:, :TQ * SS].reshape(T, TQ, SS, 1, 3)
        mx = torch.where(fq, lq, torch.full_like(lq, -torch.inf)).amax(2)
        nm = torch.maximum(run_max, mx)
        scale = torch.where(torch.isinf(nm), 1.0, torch.exp(run_max - nm))
        x = torch.where(fq, torch.exp(lq - torch.where(
            torch.isinf(nm), 0.0, nm)[:, :, None]), 0.0)
        run_max = nm
        part = torch.cat([x.sum(2)[..., None], (x[..., None] * hq).sum(2)], -1)
        if SS == K:
            # every slot of the task's queries is here: the weights themselves
            inv = torch.where(part[..., :1] > 0, 1 / part[..., :1], 0.0)
            x, part = x * inv.squeeze(-1)[:, :, None], part * inv
        vq = (xv[j[:, :TQ * SS]] * fq.reshape(T, TQ * SS, 1)).reshape(T, TQ, SS, 8, G)
        acc = acc * scale.repeat(1, 1, 8) + (vq * x[:, :, :, None, :]).sum(2).reshape(T, TQ, C)
        sums = sums * scale[..., None] + part
    # the weighted p_r: b_p2 sum w + W_p2^T sum w h, channel c of group c % G
    pr = (torch.einsum("tqg,sg->tqsg", sums[..., 0], p2_b.reshape(8, G))
          + torch.einsum("tqga,asg->tqsg", sums[..., 1:], p2_w.reshape(3, 8, G)))
    out = acc + pr.reshape(T, TQ, C)
    if SS < K:
        den = sums[..., 0].repeat(1, 1, 8)
        out = torch.where(den > 0, out / torch.where(den > 0, den, 1.0), 0.0)
    return out.reshape(T * TQ, C)[:M].reshape(B, N, C)


def _plain(feats, coord, idx, nmask, params):
    return va.vector_attention_plain(*(x.double() for x in feats), coord.double(),
                                     idx, nmask, *(x.double() for x in params))


def _rel_err(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


def _run(case, dtype, split):
    feats, coord, idx, nmask, params, _ = case
    return tiled_forward(*(x.to(dtype) for x in feats), coord.to(dtype), idx,
                         nmask, [x.to(dtype) for x in params], split)


@pytest.mark.parametrize("C", [32, 64, 256, 512])
@pytest.mark.parametrize("K", [3, 5, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tiled_forward_matches_plain(C, K, dtype):
    """B * N = 74 rows leave a partial last task at K = 3 / 5 / 8 (two
    queries a task; at K = 3 and 5 a task leaves rows unused); one query has
    no valid slot and comes out exactly 0."""
    case = _case(C, K, seed=C + K)
    want = _plain(*case[:5])
    got = _run(case, dtype, split=dtype == torch.float32)
    err = _rel_err(got, want)
    assert err <= (1e-10 if dtype == torch.float64 else TOL_K3), err
    assert (got[0, 3] == 0).all() and (want[0, 3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_row_chunks_merged_where_k_exceeds_the_tile(dtype):
    """K = 40 > 16: each query's slots in three row chunks, the last
    partial, merged by the online softmax."""
    case = _case(512, 40, seed=11, B=3, N=45)
    want = _plain(*case[:5])
    err = _rel_err(_run(case, dtype, split=dtype == torch.float32), want)
    assert err <= (1e-10 if dtype == torch.float64 else TOL_K3), err


@pytest.mark.parametrize("C,K", [(32, 8), (512, 40)])
def test_all_masked_batch_gives_zero(C, K):
    """No valid slot anywhere, in one row chunk or several: exactly 0."""
    feats, coord, idx, nmask, params, dout = _case(C, K, seed=5, N=45)
    got = _run((feats, coord, idx, torch.zeros_like(nmask), params, dout),
               torch.float32, split=True)
    assert (got == 0).all()


def test_one_pass_tf32_misses_the_tolerance():
    """The reason for the split: the same order of work with one-pass TF32
    products (10-bit mantissas) misses 1e-4 at C = 512, where split TF32
    meets it on the same inputs."""
    case = _case(512, 16, seed=4)
    want = _plain(*case[:5])
    one = _rel_err(_run(case, torch.float32, split="one"), want)
    three = _rel_err(_run(case, torch.float32, split=True), want)
    assert three <= TOL_K3 < one, (three, one)


# -- the packing of an eval layer, once a layer ------------------------------


def _eval_layer(C=32, K=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    layer = PointTransformerLayer(C, C, share_planes=8, nsample=K)
    with torch.no_grad():
        for bn in layer.modules():
            if isinstance(bn, MaskedBatchNorm):
                n = bn.num_features
                bn.weight.copy_(0.5 + torch.rand(n, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(n, generator=gen))
                bn.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                bn.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
    return layer.eval()


def _fresh_pack(layer):
    params = va._pack_params(*va.eval_params(layer.linear_p, layer.linear_w))
    return params, va._split_w1(params, layer.linear_w[2].in_features)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_packing_once_a_layer_and_again_on_change():
    """``packed_params`` packs once an eval layer, packs again when a
    weight or a running statistic changes in place, refuses a layer in
    training mode, and packs modules made under inference mode anew."""
    layer = _eval_layer()
    mlps = (layer.linear_p, layer.linear_w)
    first = va.packed_params(*mlps)
    assert va.packed_params(*mlps) is first
    assert _same(first, _fresh_pack(layer))
    with torch.no_grad():
        layer.linear_w[2].weight.add_(1.0)
    second = va.packed_params(*mlps)
    assert second is not first and not _same(second, first)
    assert _same(second, _fresh_pack(layer))
    layer.linear_p[1].running_var.mul_(2.0)
    third = va.packed_params(*mlps)
    assert third is not second and _same(third, _fresh_pack(layer))
    layer.train()
    with pytest.raises(ValueError, match="eval mode"):
        va.packed_params(*mlps)
    with torch.inference_mode():
        fresh = _eval_layer(seed=1)
        assert _same(va.packed_params(fresh.linear_p, fresh.linear_w),
                     _fresh_pack(fresh))


def test_w1_pairs_are_the_kernels_split():
    """W_w1's pairs for the forward kernel: (C, 2 G), hi the TF32 rounding
    of each weight and lo that of the rest, hi + lo within 2^-21 of it."""
    layer = _eval_layer(C=64)
    params, w1s = va.packed_params(layer.linear_p, layer.linear_w)
    w1 = layer.linear_w[2].weight.detach().t()
    pairs = w1s.reshape(64, 8, 2)
    assert w1s.shape == (64, 16) and w1s.is_contiguous()
    assert torch.equal(pairs[..., 0], tf32(w1))
    assert torch.equal(pairs[..., 1], tf32(w1 - tf32(w1)))
    err = (pairs.double().sum(-1) - w1.double()).abs() / w1.double().abs()
    assert float(err.max()) <= 2.0 ** -21


def test_cached_packing_gives_the_layers_output():
    """The cached buffer, unpacked, runs the plain version to the eval
    layer's own output, bit for bit, before and after a repack."""
    layer = _eval_layer(C=64, K=16, seed=2)
    rng = np.random.RandomState(2)
    coord = torch.from_numpy((rng.rand(1, 60, 3) * 2).astype(np.float32))
    feat = torch.from_numpy(rng.standard_normal((1, 60, 64)).astype(np.float32))
    mask = torch.ones(1, 60, dtype=torch.bool)
    idx, d2 = geometry.knn(coord, coord, 16, ref_mask=mask)
    nmask = torch.isfinite(d2) & mask[..., None]
    for step in range(2):
        with torch.no_grad():
            if step:
                layer.linear_w[5].bias.add_(0.5)
            want = layer(Points(coord, feat, mask))
            packed, _ = va.packed_params(layer.linear_p, layer.linear_w)
            got = va.vector_attention_plain(
                layer.linear_q(feat), layer.linear_k(feat), layer.linear_v(feat),
                coord, idx, nmask, *va._unpack_params(packed, 64, 8))
        assert torch.equal(got, want), step
