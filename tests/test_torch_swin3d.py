"""The port's Swin3D-v1m1 against the JAX package on the CPU: the window sort,
cRSE window attention with each signal group (values and gradients), its
binned value term against the gather form, ``GridKNNDownsample`` with its kNN
tables, ``Upsample``, the whole small Swin3D through ``DefaultSegmentor``
in eval (``linear_attn``, ``XYZ_RGB_NORM``, ``stem_transformer`` both ways),
one ``DefaultTrainer`` AdamW step (its training-mode forward and gradient),
compacted levels against full-length ones, the bridge and the shipped
configs' shapes.

Reductions from the shipped S3DIS Swin3D-small config (five layers of widths
48 to 384, windows of 5 and 7, quantisation 4, patches of 48, 204,800-point
crops, batch 12): three layers of widths (8, 16, 16), depths (1, 2, 1), two
heads, windows of 3, quantisation 2, patches of 16; two samples of 128 and
96 voxels padded to 256 (the JAX module needs a whole number of patches).
The voxels lie in 4 x 4 x 1 clusters at even corners, at least 10 cells
apart: a parent's 16 nearest children are its cluster's, and the 3-NN of an
interpolation have no tie at the third place.  On a denser lattice the JAX
kNN (the matmul identity, ~1e-7 of noise) breaks the exact ties the port's
K1 orders by index, and picks other sets; the parity tests assert on each of
their inputs that the JAX exact kNN's tables equal the port's.

Tolerances: sorts and tables bit-equal; a module rtol 1e-4 / atol 1e-5
(``Upsample`` atol 3e-4); a whole forward 1e-4 x max |logit|; whole-network
gradients as ``test_torch_cac_losses.assert_gradient_triple`` holds them.
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models.swin3d import swin3d as jswin
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.parallel.mesh import create_mesh
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.swin3d import swin3d as port
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_cac_losses import assert_gradient_triple, float64_gradients
from test_torch_layer import randomise_bn
from test_torch_ptv3 import assert_logits_close, inputs, set_leaf, tree_shapes
from test_torch_st import japply, jinit, knn_tie_gap, tt
from test_torch_train import CFG, port_gradients, record_gradients, recorded_gradients

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
BACKBONE = dict(type="Swin3D-v1m1", in_channels=9, num_classes=5, depths=(1, 2, 1),
                channels=(8, 16, 16), num_heads=(2, 2, 2), window_sizes=(3, 3, 3),
                quant_size=2, num_layers=3, stem_transformer=True, upsample="linear_attn",
                cRSE="XYZ_RGB_NORM", patch_cap=16, drop_path_rate=0.0)
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
SEGMENTOR = dict(type="DefaultSegmentor", backbone=BACKBONE, criteria=CRITERIA)
# the stem's conv, residual block and downsample; interpolating upsamples
STEM_DOWN = dict(SEGMENTOR, backbone=dict(BACKBONE, stem_transformer=False,
                                          upsample="linear", cRSE="XYZ_RGB"))
# the JAX Swin3D names its blocks ``layer{i}_block{d}`` and ``up{i}_attn``:
# the config's "blocks" matches none of them, where the reference's (and the
# port's) ``layers.{l}.blocks.{d}`` and ``upsamples.{u}.block.blocks.0`` are
# all in the low-rate group.  The JAX step is given the keywords that pick
# the same parameters.
JAX_BLOCK_KEYWORDS = ("_block", "_attn")


@pytest.fixture(autouse=True)
def exact_jax_knn():
    old = jgeo.FORCE_KNN_PATH
    jgeo.FORCE_KNN_PATH = "exact"
    yield
    jgeo.FORCE_KNN_PATH = old


def cluster_cells(rng, clusters, size=4, spacing=10, extent=60):
    """``clusters`` blocks of size x size x 1 voxels at even corners, at
    least ``spacing`` cells apart in x or y."""
    corners = []
    while len(corners) < clusters:
        c = np.append(rng.randint(0, extent // 2, 2) * 2, rng.randint(0, 6))
        if all(np.abs(c - o)[:2].max() >= spacing for o in corners):
            corners.append(c)
    return np.asarray([c + (x, y, 0) for c in corners for x in range(size)
                       for y in range(size)], np.int32)


def scene(seed, counts=(128, 96), n=256, channels=9, classes=5):
    """A padded batch of clustered voxel sets: features (colour, normal,
    coordinates at random) and labels."""
    rng = np.random.RandomState(seed)
    grid = np.zeros((len(counts), n, 3), np.int32)
    for i, c in enumerate(counts):
        grid[i, :c] = cluster_cells(rng, c // 16)
    mask = np.arange(n)[None, :] < np.array(counts)[:, None]
    feat = (rng.rand(len(counts), n, channels) * mask[..., None]).astype(np.float32)
    segment = np.where(mask, rng.randint(0, classes, mask.shape), -1).astype(np.int64)
    return dict(grid_coord=grid, feat=feat, mask=mask, segment=segment)


def weights(cfg, seed):
    """A segmentor's JAX tree made on the port's side: every kernel of unit
    gain, the cRSE tables at 0.3, norm scales and statistics randomised."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    tree = randomise_bn(state_dict_to_jax(build_model(dict(cfg)).state_dict()), rng)
    for path, a in flatten_tree(tree["params"]).items():
        if path.endswith("_table"):
            value = 0.3 * rng.standard_normal(a.shape)
        elif path.endswith("kernel"):
            value = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        else:
            continue
        set_leaf(tree["params"], path, value.astype(np.float32))
    return tree


def models(cfg, seed):
    tree = weights(cfg, seed)
    model = build_model(dict(cfg))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    return jax_build_model(dict(cfg)), model, tree


@functools.lru_cache(maxsize=None)
def _jax_knn_fn(k):
    return jax.jit(jax.vmap(lambda q, r, m: jgeo.knn(q, r, k, ref_mask=m)))


def recorded_knn(monkeypatch):
    """The port's kNN calls from here on, as (query, ref, k, ref_mask, idx,
    dist2) numpy arrays."""
    calls = []

    def recording(query, ref, k, ref_mask=None):
        idx, dist2 = port_knn(query, ref, k, ref_mask=ref_mask)
        calls.append(tuple(t.detach().numpy() if torch.is_tensor(t) else t
                           for t in (query, ref, k, ref_mask, idx, dist2)))
        return idx, dist2

    port_knn = port.knn
    monkeypatch.setattr(port, "knn", recording)
    return calls


def assert_knn_matches_jax(calls):
    """Each recorded kNN's table equals the JAX exact kNN's on the same
    inputs: the same valid neighbours of every query (as sets: the JAX kNN
    orders exact ties by its rounding noise, which neither the max-pool nor,
    beyond rounding, the interpolation sees) and the same distances."""
    assert calls
    for query, ref, k, ref_mask, idx, dist2 in calls:
        jidx, jd2 = (np.asarray(a) for a in _jax_knn_fn(k)(query, ref, ref_mask))
        finite = np.isfinite(dist2)
        np.testing.assert_array_equal(np.isfinite(jd2), finite)
        np.testing.assert_array_equal(np.sort(np.where(finite, jidx, -1), -1),
                                      np.sort(np.where(finite, idx, -1), -1))
        np.testing.assert_allclose(np.where(finite, jd2, 0), np.where(finite, dist2, 0),
                                   atol=1e-4)


def valid_gap(query, query_mask, ref, ref_mask, k):
    """``knn_tie_gap`` over the valid queries of each sample."""
    return min(knn_tie_gap(q[qm][None], r[None], k, rm[None])
               for q, qm, r, rm in zip(query, query_mask, ref, ref_mask))


def jax_shapes(cfg, batch):
    """The JAX model's parameter and statistics shapes by path on ``batch``
    (traced, not compiled)."""
    batch = {k: jnp.asarray(v) for k, v in batch.items() if k != "segment"}
    shapes = jax.eval_shape(lambda: jax_build_model(dict(cfg)).init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))
    return {coll: {k: tuple(v.shape) for k, v in flatten_tree(dict(shapes[coll])).items()}
            for coll in ("params", "batch_stats")}


def assert_gradients_with_zeros(port_grads, jax_grads, f64_grads, what):
    """``assert_gradient_triple`` over the tensors whose float64 gradient is
    not zero; the others (within 1e-7 of the network's largest float64
    gradient: biases whose uniform shift of every row the classifier's
    batch-statistic BatchNorm takes out, the last upsample's LayerNorms' and
    linears' and ``cls_fc1``'s) within 1e-5 of it in both packages."""
    flat = [flatten_tree(jax.tree_util.tree_map(np.asarray, t))
            for t in (port_grads, jax_grads, f64_grads)]
    top = max(np.abs(g).max() for g in flat[2].values())
    zero = {p for p, g in flat[2].items() if np.abs(g).max() <= 1e-7 * top}
    assert {f"backbone_module/up1/{n}/bias" for n in ("norm1", "norm2")} <= zero
    assert all(p.endswith("/bias") for p in zero), zero
    for path in zero:
        assert max(np.abs(f[path]).max() for f in flat[:2]) <= 1e-5 * top, path
    assert_gradient_triple(*({p: g for p, g in f.items() if p not in zero} for f in flat),
                           what)


def copy_linear(linear, params):
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy(np.asarray(params["kernel"]).T))
        if linear.bias is not None:
            linear.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))


def copy_ln(norm, params):
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(np.asarray(params["scale"])))
        norm.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))


def random_params(v, rng, scale=0.3):
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), v)


# -- windows and attention --------------------------------------------------------------


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "shifted"])
def test_window_sort_matches_jax(shift):
    """``window_sort``: order, inverse and sorted window ids bit-equal to the
    JAX ``_window_sort`` (its two stable sorts) on repeated cells, ties in
    window and code, and masked rows, which sort last."""
    rng = np.random.RandomState(1)
    grid = rng.randint(0, 9, (2, 160, 3)).astype(np.int32)
    grid[:, 40:60] = grid[:, :20]
    mask = np.ones((2, 160), bool)
    mask[0, 130:] = False
    mask[1, ::4] = False
    ref = jax.jit(jswin._window_sort, static_argnums=(2, 3))(grid, mask, 3, shift)
    got = port.window_sort(*tt(grid, mask), 3, shift)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    np.testing.assert_array_equal(np.sort(got[0][1, -40:].numpy()), np.nonzero(~mask[1])[0])


def attention_case(seed, crse, b=2, n=96, c=16, heads=2):
    """A level of two samples (the second with a third of its rows padded),
    its signal (voxel xyz, colour and normal), features, the JAX module on
    random weights and its outputs and gradients against ``g`` (one
    compile)."""
    rng = np.random.RandomState(seed)
    grid = rng.randint(0, 7, (b, n, 3)).astype(np.int32)
    mask = np.arange(n)[None, :] < np.array([n, 2 * n // 3])[:, None]
    signal = np.concatenate([grid.astype(np.float32), rng.rand(b, n, 6).astype(np.float32)],
                            -1)
    feat = rng.standard_normal((b, n, c)).astype(np.float32)
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    jmod = jswin.WindowAttentionCRSE(c, 3, 2, heads, 16, crse)
    order, inverse, win = jswin._window_sort(jnp.asarray(grid), jnp.asarray(mask), 3, False)
    args = (signal, order, inverse, win, mask, False)
    v = random_params(jinit(jmod, feat, *args), rng)
    ref, grads = jax_value_and_grads(jmod, v["params"], feat, args, g)
    return grid, mask, signal, feat, g, v["params"], ref, grads


def jax_value_and_grads(jmod, params, x, args, g, out=lambda y: y):
    """The JAX module's output ``out(apply(x, *args))`` and the gradients of
    its sum against ``g`` w.r.t. (params, x), in one compile."""
    def jloss(p, xx):
        y = out(jmod.apply({"params": p}, xx, *args))
        return jnp.sum(y * g), y

    (_, y), grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(params, x)
    return np.asarray(y), grads


@pytest.mark.parametrize("crse", ["XYZ", "XYZ_RGB_NORM"])
def test_window_attention_matches_jax(crse):
    """``WindowAttention`` with the xyz group alone and with all three,
    against the JAX
    ``WindowAttentionCRSE`` on its weights (tables at 0.3): the output rtol
    1e-4 / atol 1e-5, padded rows 0; the gradients of the input, qkv, proj
    and every table at the same tolerances (the written-out backward of
    ``CRSEAttention`` against JAX's autodiff of the gather form)."""
    grid, mask, signal, feat, g, p, ref, (ref_gp, ref_gx) = attention_case(3, crse)
    mod = port.WindowAttention(16, 3, 2, 2, crse)
    copy_linear(mod.qkv, p["qkv"])
    copy_linear(mod.proj, p["proj"])
    tables = [k for k in p if k.endswith("_table")]
    assert len(tables) == 3 * len(mod.groups)
    with torch.no_grad():
        for name in tables:
            getattr(mod, name).copy_(torch.from_numpy(np.asarray(p[name])))
    level = port.SwinLevel(*tt(grid, mask), torch.from_numpy(grid).float(),
                           torch.from_numpy(signal))
    x = torch.from_numpy(feat).requires_grad_(True)
    out = mod(x, level, level.windows(3, False, mod.groups, 16))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    assert (out[~torch.from_numpy(mask)] == 0).all()
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=RTOL, atol=ATOL)
    for name in ("qkv", "proj"):
        np.testing.assert_allclose(getattr(mod, name).weight.grad.numpy().T,
                                   np.asarray(ref_gp[name]["kernel"]), rtol=RTOL, atol=1e-4)
    for name in tables:
        np.testing.assert_allclose(getattr(mod, name).grad.numpy(),
                                   np.asarray(ref_gp[name]), rtol=RTOL, atol=ATOL, err_msg=name)


def test_binned_value_term_equals_gather_form():
    """``CRSEAttention`` against the JAX module's form written in PyTorch
    with autograd, in float64: the value table gathered at every pair's bin,
    (B, P, H, K, M, hd), and contracted with the attention; the q and k
    terms as gathers of the full tables.  Outputs and the gradients of q,
    k, v and the three tables within 1e-12; the pairs of other windows and
    padded rows masked."""
    rng = np.random.RandomState(4)
    b, p, h, k, hd = 2, 3, 2, 12, 4
    parts = [(0, 10), (10, 10), (20, 10), (30, 8), (38, 8), (46, 8)]
    nb = 54
    q, kk, v = (torch.from_numpy(rng.standard_normal((b, p, h, k, hd))).requires_grad_(True)
                for _ in range(3))
    tq, tk, tv = (torch.from_numpy(rng.standard_normal((nb, h, hd))).requires_grad_(True)
                  for _ in range(3))
    bins = torch.from_numpy(np.stack([rng.randint(0, w, (b, p, k, k)) for _, w in parts],
                                     -1).astype(np.int16))
    win = rng.randint(0, 3, (b, p, k))
    valid = rng.rand(b, p, k) > 0.2
    pair_valid = torch.from_numpy((win[..., :, None] == win[..., None, :])
                                  & valid[..., :, None] & valid[..., None, :])[:, :, None]
    g = torch.from_numpy(rng.standard_normal((b, p, h, k, hd)))
    got = port.CRSEAttention.apply(q, kk, v, 1.0, tq, tk, tv, bins, pair_valid, parts)
    (got * g).sum().backward()
    grads = [t.grad.clone() for t in (q, kk, v, tq, tk, tv)]
    for t in (q, kk, v, tq, tk, tv):
        t.grad = None
    logits = q @ kk.transpose(-1, -2)
    rows = [(bins[..., i].long() + o) for i, (o, _) in enumerate(parts)]
    for r in rows:
        logits = logits + torch.einsum("bphkd,bpkmhd->bphkm", q, tq[r])
        logits = logits + torch.einsum("bphmd,bpkmhd->bphkm", kk, tk[r])
    attn = torch.softmax(logits.masked_fill(~pair_valid, -1e9), -1)
    ref = attn @ v
    for r in rows:
        ref = ref + torch.einsum("bphkm,bpkmhd->bphkd", attn, tv[r])
    (ref * g).sum().backward()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
    for a, t in zip(grads, (q, kk, v, tq, tk, tv)):
        torch.testing.assert_close(a, t.grad, rtol=0, atol=1e-12)


# -- downsample and upsample ------------------------------------------------------------


def jittered_level(seed, n=96, count=(96, 70), channels=9):
    """A level of lattice voxels whose kNN coordinates are jittered off the
    lattice (tie-free: a module test may take any xyz), with a signal."""
    rng = np.random.RandomState(seed)
    grid = np.stack([rng.permutation(np.array(np.meshgrid(*[np.arange(6)] * 3)).reshape(3, -1)
                                     .T)[:n] for _ in count]).astype(np.int32)
    mask = np.arange(n)[None, :] < np.array(count)[:, None]
    xyz = (grid + rng.uniform(-0.3, 0.3, grid.shape)).astype(np.float32)
    signal = rng.rand(len(count), n, channels).astype(np.float32)
    return grid, mask, xyz, signal


def test_grid_knn_downsample_matches_jax(monkeypatch):
    """``GridKNNDownsample`` (stride-2 parents, means of their children's
    xyz and signal, K1's 16 nearest children, LayerNorm, linear, max) in
    training mode against the JAX module: the parents bit-equal, the kNN
    tables equal to the JAX exact kNN's (tie-free coordinates, gap asserted),
    the pooled xyz and signal rtol 1e-6, the output and the gradients of the
    input, norm and linear rtol 1e-4 / atol 1e-5."""
    grid, mask, xyz, signal = jittered_level(5)
    rng = np.random.RandomState(6)
    feat = rng.standard_normal((2, 96, 8)).astype(np.float32)
    jmod = jswin.GridKNNDownsample(16)
    args = (grid, xyz, signal, mask, True)
    v = jinit(jmod, feat, *args)
    v = {"params": {"norm": random_params(v["params"]["norm"], rng),
                    "linear": random_params(v["params"]["linear"], rng, 1.0)}}
    ref = [np.asarray(a) for a in japply(jmod, v, feat, *args)]
    g = rng.standard_normal(ref[0].shape).astype(np.float32)
    _, (ref_gp, ref_gx) = jax_value_and_grads(jmod, v["params"], feat, args, g,
                                              out=lambda y: y[0])
    calls = recorded_knn(monkeypatch)
    level = port.SwinLevel(*tt(grid, mask), *tt(xyz, signal))
    parent = build_model(dict(BACKBONE)).parent(level)
    cap = parent.mask.shape[1]
    np.testing.assert_array_equal(parent.grid.numpy(), ref[1][:, :cap])
    np.testing.assert_array_equal(parent.mask.numpy(), ref[4][:, :cap])
    assert not ref[4][:, cap:].any()
    np.testing.assert_allclose(parent.xyz.numpy(), ref[2][:, :cap], rtol=1e-6)
    halved = ref[3][:, :cap].copy()
    halved[..., :3] /= 2
    np.testing.assert_allclose(parent.signal.numpy(), halved, rtol=1e-6)
    mod = port.GridKNNDownsample(8, 16)
    copy_ln(mod.norm, v["params"]["norm"])
    copy_linear(mod.linear, v["params"]["linear"])
    x = torch.from_numpy(feat).requires_grad_(True)
    out = mod(x, level, parent)
    assert valid_gap(parent.xyz.numpy(), parent.mask.numpy(), xyz, mask, 16) >= 5e-7
    assert_knn_matches_jax(calls)
    np.testing.assert_allclose(out.detach().numpy(), ref[0][:, :cap], rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(g[:, :cap])).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mod.linear.weight.grad.numpy().T,
                               np.asarray(ref_gp["linear"]["kernel"]), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(mod.norm.weight.grad.numpy(),
                               np.asarray(ref_gp["norm"]["scale"]), rtol=RTOL, atol=1e-4)


def test_upsample_matches_jax(monkeypatch):
    """``Upsample`` (linear of the skip plus the 3-NN interpolation of a
    linear of the coarse level, K1) against the JAX module: the kNN tables
    equal to the JAX exact kNN's, the output atol 3e-4, padded rows 0."""
    grid, mask, xyz, _ = jittered_level(7)
    rng = np.random.RandomState(8)
    coarse_mask = np.arange(40)[None, :] < np.array([40, 25])[:, None]
    coarse_xyz = rng.uniform(0, 5, (2, 40, 3)).astype(np.float32)
    coarse = rng.standard_normal((2, 40, 16)).astype(np.float32)
    skip = rng.standard_normal((2, 96, 8)).astype(np.float32)
    jmod = jswin.Upsample(8)
    args = (coarse_xyz, coarse_mask, skip, xyz, mask, False)
    v = random_params(jinit(jmod, coarse, *args), rng, 1.0)
    ref = np.asarray(japply(jmod, v, coarse, *args))
    calls = recorded_knn(monkeypatch)
    mod = port.Upsample(16, 8)
    p = v["params"]
    copy_ln(mod.linear1[0], p["norm1"])
    copy_linear(mod.linear1[1], p["linear1"])
    copy_ln(mod.linear2[0], p["norm2"])
    copy_linear(mod.linear2[1], p["linear2"])
    src = port.SwinLevel(torch.zeros(2, 40, 3, dtype=torch.int32), *tt(coarse_mask, coarse_xyz),
                         torch.zeros(2, 40, 6))
    dst = port.SwinLevel(*tt(grid, mask, xyz), torch.zeros(2, 96, 6))
    with torch.no_grad():
        got = mod(torch.from_numpy(coarse), src, torch.from_numpy(skip), dst).numpy()
    assert valid_gap(xyz, mask, coarse_xyz, coarse_mask, 3) >= 5e-7
    assert_knn_matches_jax(calls)
    np.testing.assert_allclose(got, ref, atol=3e-4)
    assert (got[~mask] == 0).all()


# -- the network ------------------------------------------------------------------------


_JAX_EVAL = {}


def jax_forward(jmodel, tree, batch):
    key = id(jmodel)
    if key not in _JAX_EVAL:
        _JAX_EVAL[key] = jax.jit(functools.partial(jmodel.apply, train=False))
    out = _JAX_EVAL[key](tree, {k: v for k, v in batch.items() if k != "segment"})
    return np.asarray(out["seg_logits"])


@pytest.mark.parametrize("cfg", [SEGMENTOR, STEM_DOWN], ids=["stem-transformer", "stem-down"])
def test_eval_forward_matches_jax(cfg, monkeypatch):
    """The small Swin3D through ``DefaultSegmentor`` in eval, against the JAX
    module: ``linear_attn`` upsampling and the ``XYZ_RGB_NORM`` signal with
    the transformer from the stem, interpolating upsampling and ``XYZ_RGB``
    after the stem's residual block and downsample (whose logits are the
    stem-down level's rows, as the JAX module's are); the kNN tables of every
    downsample and interpolation equal to the JAX exact kNN's; logits within
    1e-4 x max |logit|."""
    jmodel, model, tree = models(cfg, 10)
    batch = scene(11)
    ref = jax_forward(jmodel, tree, batch)
    calls = recorded_knn(monkeypatch)
    with torch.inference_mode():
        got = model.eval()(inputs(batch))["seg_logits"].numpy()
    assert got.shape == (2, 256, 5)
    assert len(calls) == (4 if cfg is SEGMENTOR else 3)
    assert_knn_matches_jax(calls)
    assert_logits_close(got, ref, batch["mask"])


def test_compacted_levels_equal_full_length():
    """Levels held at the batch's largest valid count rounded up to a patch
    compute what full-length levels (the JAX module's) compute on their
    valid rows: every level's voxels, masks, pooled xyz and signal equal on
    the shorter length and padding past it, and the logits of a training
    forward (batch statistics) equal."""
    cfg = dict(SEGMENTOR, backbone=dict(BACKBONE, drop_path_rate=0.0))
    model = build_model(cfg)
    batch = inputs(scene(12))
    backbone = model.backbone
    compact = backbone.levels(batch)
    backbone.compact_levels = False
    full = backbone.levels(batch)
    assert [lv.mask.shape[1] for lv in full] == [256, 256, 256]
    assert all(lv.mask.shape[1] % 16 == 0 and lv.mask.shape[1] < 256 for lv in compact[1:])
    for a, b in zip(compact, full):
        n = a.mask.shape[1]
        for key in ("grid", "mask", "xyz", "signal"):
            torch.testing.assert_close(getattr(a, key), getattr(b, key)[:, :n], rtol=0, atol=0)
        assert not b.mask[:, n:].any()
    # the up-attention blocks' drop path (0.1, as the JAX module fixes it)
    # draws the same samples from one seed
    ref = model.train()(batch, generator=torch.Generator().manual_seed(0))["seg_logits"]
    backbone.compact_levels = True
    got = model(batch, generator=torch.Generator().manual_seed(0))["seg_logits"]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_default_trainer_step_matches_jax(tmp_path, monkeypatch):
    """One ``DefaultTrainer`` step through both packages of the shipped S3DIS
    Swin3D-small config at the reduced width (AdamW, MultiStepLR, the
    ``blocks`` group at a tenth of the rate, the JAX step given
    ``JAX_BLOCK_KEYWORDS``), f32 without autocast, Mix3D off and drop path
    0 (so interpolating upsampling: the JAX module fixes the up-attention
    blocks' drop path at 0.1, and draws from its own generator): the
    training-mode forward's loss rtol 1e-4, its gradient as
    ``assert_gradient_triple`` holds it, the running statistics rtol 1e-5 /
    atol 1e-5, both groups' rates, the parameters after the step within 1e-4
    of max(1, max |value|) where the gradient is clear of f32 noise, and the
    two groups holding the same parameters in both packages."""
    shipped = Config.fromfile(os.path.join(ROOT, "configs", "s3dis",
                                           "semseg-swin3d-v1m1-0-small.py"))
    model = dict(shipped.model)
    model["backbone"] = dict(model["backbone"], **dict(
        {k: v for k, v in BACKBONE.items() if k != "type"}, upsample="linear"))
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=model,
               optimizer=dict(shipped.optimizer), scheduler=dict(shipped.scheduler),
               param_dicts=[dict(p) for p in shipped.param_dicts],
               data=dict(CFG["data"], num_classes=5))
    assert cfg["param_dicts"] == [dict(keyword="blocks", lr=0.0001)]
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(copy.deepcopy(cfg))))
    jcfg = dict(cfg, param_dicts=[dict(keyword=k, lr=0.0001) for k in JAX_BLOCK_KEYWORDS])
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(jcfg)))
    jtrainer.mesh = create_mesh(1)
    record_gradients(jtrainer)
    batch = scene(21)
    np_batch = dict(coord=batch["grid_coord"] * np.float32(0.02),
                    grid_coord=batch["grid_coord"], feat=batch["feat"],
                    segment=batch["segment"], count=batch["mask"].sum(1).astype(np.int32))
    start = weights(model, 22)
    jtrainer._init_variables = lambda batch, rng: (start["params"], start["batch_stats"])
    jbatch = jtrainer.device_batch(np_batch)
    jtrainer.initialize_state(jbatch)
    trainer.model.load_state_dict(jax_to_state_dict(start), strict=True)
    in_group = sorted(n for n, _ in trainer.model.named_parameters() if "blocks" in n)
    jax_in_group = sorted(p for p in flatten_tree(start["params"])
                          if any(k in p for k in JAX_BLOCK_KEYWORDS))
    assert len(in_group) == len(jax_in_group) > 0
    assert set(flatten_tree(state_dict_to_jax(
        {n: p for n, p in trainer.model.named_parameters() if "blocks" in n})["params"])
    ) == set(jax_in_group)
    truth = float64_gradients(
        trainer.model, trainer.device_batch(np_batch),
        lambda out, b: trainer.model.loss(out["seg_logits"], b["segment"]))
    rng = jax.random.fold_in(jtrainer._base_rng, 1)
    jtrainer.state, jout = jtrainer._train_step(jtrainer.state, jbatch, rng)
    calls = recorded_knn(monkeypatch)
    trainer.comm_info["input_dict"] = np_batch
    grads = port_gradients(trainer, trainer.run_step)
    assert_knn_matches_jax(calls)
    out = trainer.comm_info["model_output_dict"]
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4)
    assert trainer.comm_info["lr"] == pytest.approx(float(jtrainer.scheduler(0)), rel=1e-6)
    assert [g["lr"] for g in trainer.optimizer.param_groups] == pytest.approx(
        [trainer.comm_info["lr"], trainer.comm_info["lr"] * 0.1])
    assert_gradients_with_zeros(grads, recorded_gradients(jtrainer), truth, "Swin3D step")
    state = state_dict_to_jax(trainer.model.state_dict())
    got, ref = (flatten_tree(jax.tree_util.tree_map(np.asarray, t["batch_stats"])) for t in (
        state, {"batch_stats": jtrainer.state.batch_stats}))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=1e-5, atol=1e-5, err_msg=path)
    got, ref = (flatten_tree(jax.tree_util.tree_map(np.asarray, t)) for t in (
        state["params"], jtrainer.state.params))
    jgrad = flatten_tree(jax.tree_util.tree_map(np.asarray, recorded_gradients(jtrainer)))
    noise = 1e-5 * max(np.abs(g).max() for g in jgrad.values())
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        err = np.abs(got[path] - r)
        clear = np.abs(jgrad[path]) > noise
        assert err[clear].max(initial=0) <= 1e-4 * max(np.abs(r).max(), 1.0), path
        assert err.max() <= 2 * trainer.comm_info["lr"] + 1e-4 * max(np.abs(r).max(), 1.0)


def test_drop_path_draws_from_the_generator():
    """Training with drop path 0.5: one generator seed gives bit-equal
    outputs, another seed other ones; the global RNG is untouched; a
    training forward without a generator raises."""
    model = build_model(dict(SEGMENTOR, backbone=dict(BACKBONE, drop_path_rate=0.5))).train()
    batch = inputs(scene(15))
    state = torch.get_rng_state()
    outs = [model(batch, generator=torch.Generator().manual_seed(s))["seg_logits"].detach()
            for s in (1, 1, 2)]
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="generator"):
        model(batch)


# -- bridge and configs -----------------------------------------------------------------


@pytest.mark.parametrize("cfg", [SEGMENTOR, STEM_DOWN], ids=["stem-transformer", "stem-down"])
def test_bridge_round_trip_bit_equal(cfg):
    """The port's tree has the JAX model's names and shapes (the cRSE tables
    (3, 2L, H, hd), the stem conv (27, C_in, C_out)); the state_dict holds
    the reference's names; JAX tree -> state_dict -> JAX tree is bit-equal
    and loads with strict=True."""
    tree = weights(cfg, 19)
    assert tree_shapes(tree) == jax_shapes(cfg, batch=scene(20, counts=(48, 32), n=64))
    model = build_model(dict(cfg))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    sd = model.state_dict()
    if cfg is SEGMENTOR:
        assert sd["backbone.layers.0.blocks.0.attn.query_xyz_table"].shape == (3, 12, 2, 4)
        assert sd["backbone.layers.1.blocks.1.attn.value_norm_table"].shape == (3, 16, 2, 8)
        for key in ("backbone.stem_layer.conv.weight", "backbone.stem_layer.norm.running_var",
                    "backbone.layers.1.downsample.linear.weight",
                    "backbone.upsamples.0.block.blocks.0.mlp.fc2.bias",
                    "backbone.upsamples.1.linear2.0.weight", "backbone.classifier.1.running_mean"):
            assert key in sd, key
    else:
        for key in ("backbone.stem_layer.0.conv.weight", "backbone.stem_layer.1.bn2.bias",
                    "backbone.downsample.norm.weight", "backbone.layers.0.blocks.1.norm2.weight",
                    "backbone.upsamples.0.linear1.1.bias"):
            assert key in sd, key
        assert not any(".block." in k for k in sd)
    back = state_dict_to_jax(sd)
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("path,params", [("s3dis/semseg-swin3d-v1m1-0-small.py", 28.23)])
def test_shipped_config_builds(path, params):
    """The shipped S3DIS Swin3D-small config builds at full width (millions
    of parameters as stated, on the meta device), every parameter and
    statistic's shape, named through the bridge, equal to the JAX init
    tree's (traced by ``jax.eval_shape``, not compiled)."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", path))
    with torch.device("meta"):
        model = build_model(dict(cfg.model))
    assert sum(p.numel() for p in model.parameters()) / 1e6 == pytest.approx(params, abs=0.01)
    want = {coll: {f"backbone_module/{k}": v for k, v in shapes.items()}
            for coll, shapes in jax_shapes(dict(cfg.model.backbone), batch=scene(
                20, counts=(48, 32), n=96)).items()}
    assert tree_shapes(state_dict_to_jax(
        {k: torch.empty(v.shape, dtype=v.dtype) for k, v in model.state_dict().items()})) == want
