"""K6 in the order of work of its kernel (``csrc/kpconv.cu``
``kpconv_kernel``), emulated in plain PyTorch and held against
``kpconv_plain``.

The emulation follows the kernel: tiles of ``TILE`` points (the last one
padded with rows that hold no point), each point's valid slots compacted
in slot order, the influences of a (pair, kernel point) written as 0 where
the squared distance is at least the smallest float >= sigma_r^2 and
computed in full (root, division) below it, the point's product A_i = I_i
F_i over its valid slots padded to a multiple of 8 (F's padding rows 0),
the P x C_in row of A padded to a multiple of 8, and the tile's product Y
= A W.  In float32 each tensor-core product runs in split TF32 as the
kernel's ``mma.sync`` does (each operand x = hi + lo, hi and lo = x - hi
each rounded to TF32 by its bits, ``a_lo b_hi + a_hi b_lo + a_hi b_hi``
summed from 0, a k-step of 8 at a time, each step added to the f32 sum);
in float64 the products are exact, and the decomposition itself is
checked to rounding noise against the plain version in float64.  No JAX
and no card.
"""

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.models.stratified_transformer.st import kpconv_kernel_points
from pointcloudpdf_tpu_torch.ops import geometry
from pointcloudpdf_tpu_torch.ops import kpconv as kp

TOL_K6 = 1e-4  # relative to max |plain| (chip_smoke.py)
TILE = 16      # points a tile (the kernel's kTile)
SIGMA = 0.04   # the S3DIS ST stem's sigma_r


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as the kernel does on the bits of finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, split):
    """a @ b (batched over leading dims) a k-step of 8 at a time, each
    step's product summed from 0 and added to the sum: split TF32
    (``split``) or the dtype's own product."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=a.dtype)
    for k0 in range(0, a.shape[-1], 8):
        x, y = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        if split:
            xh, yh = tf32(x), tf32(y)
            xl, yl = tf32(x - xh), tf32(y - yh)
            step = xl @ yh + xh @ yl + xh @ yh
        else:
            step = x @ y
        acc = acc + step
    return acc


def skip_threshold(sigma):
    """The smallest float32 >= sigma^2 (the kernel's __fmul_ru)."""
    s = np.float64(np.float32(sigma))
    t = np.float32(s * s)
    if np.float64(t) < s * s:
        t = np.nextafter(t, np.float32(np.inf))
    return float(t)


def kernel_influence(d2, sigma):
    """The kernel's rule: 0 at or above the threshold, else the plain
    version's operations."""
    dt = d2.dtype
    full = torch.clamp(1.0 - torch.sqrt(d2) / torch.full((), sigma, dtype=dt), min=0.0)
    return torch.where(d2 >= skip_threshold(sigma), torch.zeros((), dtype=dt), full)


def pair_distances(coord, idx, points):
    """Squared distances (B, N, S, P) of every pair to every kernel point,
    as the kernel forms them: (dx*dx + dy*dy) + dz*dz, no contraction."""
    rel = geometry.gather_rows(coord, idx) - coord[:, :, None, :]
    dx, dy, dz = (rel[..., None, :] - points).unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def tiled_kpconv(coord, feat, idx, nmask, points, weight, sigma, split):
    """(B, N, C_out) as the kernel computes it, vectorised over the points."""
    dt = coord.dtype
    B, N, S = idx.shape
    P, c_in, c_out = weight.shape
    M = B * N
    T = -(-M // TILE)
    Mp = T * TILE
    live = torch.arange(Mp) < M
    mc = torch.where(live, torch.arange(Mp), 0)
    valid = nmask.reshape(M, S)[mc] & live[:, None]
    infl = kernel_influence(pair_distances(coord, idx, points), sigma).reshape(M, S, P)[mc]
    rows = geometry.gather_rows(feat, idx).reshape(M, S, c_in)[mc]
    # a point's valid slots first, in slot order
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    count = valid.sum(1)
    SK = -(-S // 8) * 8
    on = torch.arange(SK)[None] < count[:, None]
    ordp = torch.cat([order, order[:, :SK - S]], 1) if SK > S else order
    I = torch.zeros(Mp, 16, SK, dtype=dt)
    I[:, :P] = torch.where(on[:, None, :], infl.gather(1, ordp[..., None].expand(-1, -1, P))
                           .transpose(1, 2), torch.zeros((), dtype=dt))
    F = torch.zeros(Mp, SK, 8 * -(-c_in // 8), dtype=dt)
    F[..., :c_in] = torch.where(on[..., None], rows.gather(
        1, ordp[..., None].expand(-1, -1, c_in)), torch.zeros((), dtype=dt))
    # k-steps over the valid slots only: zero columns past the count add 0
    A = product(I, F, split)[:, :P, :c_in].reshape(Mp, P * c_in)
    PCK = -(-P * c_in // 8) * 8
    A = torch.cat([A, torch.zeros(Mp, PCK - P * c_in, dtype=dt)], 1)
    W = torch.zeros(PCK, 8 * -(-c_out // 8), dtype=dt)
    W[:P * c_in, :c_out] = weight.to(dt).reshape(P * c_in, c_out)
    Y = product(A.reshape(T, TILE, PCK), W, split).reshape(Mp, -1)[:M, :c_out]
    return Y.reshape(B, N, c_out)


def plain_f64(coord, feat, idx, nmask, points, weight, sigma):
    """``kpconv_plain``'s operations in the inputs' dtype (it casts to
    float32)."""
    rel = geometry.gather_rows(coord, idx) - coord[:, :, None, :]
    dx, dy, dz = (rel[..., None, :] - points).unbind(-1)
    dist = torch.sqrt((dx * dx + dy * dy) + dz * dz)
    infl = torch.clamp(1.0 - geometry.divide_exact(dist, sigma), min=0.0)
    infl = infl * nmask[..., None].to(infl.dtype)
    per_kp = torch.einsum("bnsp,bnsc->bnpc", infl, geometry.gather_rows(feat, idx))
    return torch.einsum("bnpc,pcd->bnd", per_kp, weight)


def kpconv_case(seed, B, N, valid, c_in, c_out, S=34, empty=0, sigma=SIGMA):
    """A clustered cloud at a stem's scale (balls of 2.5 sigma_r that hold
    up to 34 points, kernel points 1.5 sigma_r out; sigma_r 0.04 is the
    S3DIS ST stem's, 0.02 the ScanNet one's) with a masked tail, ``empty``
    valid points of sample 0 whose tables are all masked."""
    rng = np.random.RandomState(seed)
    scale = sigma / 0.04
    centers = rng.rand(12, 3) * np.array([1.0, 0.8, 0.5]) * scale
    coord = (centers[rng.randint(0, 12, (B, N))]
             + rng.normal(scale=0.05 * scale, size=(B, N, 3))).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(valid)[:, None]
    coord[~mask] = 0.0
    coord, mask = torch.from_numpy(coord), torch.from_numpy(mask)
    idx, nmask = geometry.ball_query(coord, coord, 2.5 * sigma, S, ref_mask=mask)
    nmask = nmask & mask[..., None]
    nmask[0, :empty] = False
    feat = torch.from_numpy(rng.standard_normal((B, N, c_in)).astype(np.float32))
    points = torch.from_numpy(kpconv_kernel_points() * np.float32(1.5 * sigma))
    weight = torch.from_numpy((rng.standard_normal((15, c_in, c_out)) * 0.2).astype(np.float32))
    return coord, feat, idx, nmask, points, weight


# the S3DIS ST stem's two shapes, scaled down, and the kernel's limits
SHAPES = [(6, 48), (12, 12), (16, 64)]


@pytest.mark.parametrize("sigma", [0.04, 0.02, 0.03])
def test_influences_equal_plain(sigma):
    """The kernel's rule gives the plain version's influences bit for bit,
    at the S3DIS and ScanNet stems' sigma_r and one between."""
    coord, feat, idx, nmask, points, weight = kpconv_case(
        3, 2, 700, [700, 433], 6, 48, sigma=sigma)
    d2 = pair_distances(coord, idx, points)
    plain = torch.clamp(1.0 - geometry.divide_exact(torch.sqrt(d2), sigma), min=0.0)
    got = kernel_influence(d2, sigma)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    near = (d2 < skip_threshold(sigma)) & nmask[..., None]
    assert 0.01 < float(near.sum()) / float(nmask.sum() * 15) < 0.2


def test_skip_threshold_at_the_boundary():
    """Pairs whose squared distance to the centre kernel point is the
    threshold, one ulp below and one above: the rule gives the plain
    version's influences (0 at and above, computed in full below)."""
    t = np.float32(skip_threshold(SIGMA))
    below, above = np.nextafter(t, np.float32(0)), np.nextafter(t, np.float32(1))
    targets = {float(below): None, float(t): None, float(above): None}
    # neighbours (x, y, 0) of a point at the origin whose computed squared
    # distance x*x + y*y hits each target
    for x in np.float32(SIGMA) + np.arange(-400, 400, dtype=np.float32) * np.float32(1e-9):
        for y in np.float32([0.0, 1e-4, 2e-4, 3e-4, 5e-4, 7e-4]):
            d2 = np.float32(np.float32(x * x) + np.float32(y * y))
            if float(d2) in targets and targets[float(d2)] is None:
                targets[float(d2)] = (x, y)
    assert all(v is not None for v in targets.values()), targets
    nbrs = np.array([[x, y, 0.0] for x, y in targets.values()], np.float32)
    coord = torch.from_numpy(np.concatenate([np.zeros((1, 3), np.float32), nbrs]))[None]
    idx = torch.tensor([[[1, 2, 3]] * 4], dtype=torch.int64)
    points = torch.zeros(1, 3)
    d2 = pair_distances(coord, idx, points)[0, 0, :, 0]
    assert d2.tolist() == [float(below), float(t), float(above)]
    plain = torch.clamp(1.0 - geometry.divide_exact(torch.sqrt(d2), SIGMA), min=0.0)
    got = kernel_influence(d2, SIGMA)
    assert torch.equal(got, plain)
    assert float(plain[1]) == 0 and float(plain[2]) == 0


@pytest.mark.parametrize("c_in,c_out", SHAPES)
def test_tiled_kpconv_matches_plain_f32(c_in, c_out):
    """Split-TF32 products a k-step of 8 at a time: within TOL_K6 of max
    |plain|, over tiles with a padded last one (2 x 700 points); padded
    points and points with no valid slot give 0."""
    coord, feat, idx, nmask, points, weight = kpconv_case(
        c_in + c_out, 2, 700, [700, 433], c_in, c_out, empty=9)
    assert (2 * 700) % TILE != 0
    got = tiled_kpconv(coord, feat, idx, nmask, points, weight, SIGMA, split=True)
    want = kp.kpconv_plain(coord, feat, idx, nmask, points, weight, SIGMA)
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got - want).abs().max()) <= TOL_K6 * scale
    assert (got[1, 433:] == 0).all() and (got[0, :9] == 0).all()
    assert int(nmask.sum(-1).max()) == 34


@pytest.mark.parametrize("c_in,c_out", SHAPES)
def test_tiled_kpconv_matches_plain_f64(c_in, c_out):
    """In float64 with exact products the decomposition (compacted slots,
    padding, tiles) is the plain version's sum up to rounding noise."""
    coord, feat, idx, nmask, points, weight = (
        t.double() if t.is_floating_point() else t
        for t in kpconv_case(5, 2, 500, [500, 300], c_in, c_out, empty=4))
    sigma = float(np.float32(SIGMA))  # the kernel's sigma_r, a float32
    got = tiled_kpconv(coord, feat, idx, nmask, points, weight, sigma, split=False)
    want = plain_f64(coord, feat, idx, nmask, points, weight, sigma)
    assert want.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_limits_are_the_wrappers():
    """The wrapper's limits are the kernel's (csrc/kpconv.cu kMaxS, kMaxP,
    kMaxCin, kMaxCout) and cover the shipped ST configs' KPConvs."""
    assert (kp.MAX_SLOTS, kp.MAX_POINTS, kp.MAX_C_IN, kp.MAX_C_OUT) == (40, 16, 16, 64)
    assert len(kpconv_kernel_points()) <= kp.MAX_POINTS
