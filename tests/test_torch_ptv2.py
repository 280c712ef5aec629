"""The port's PT-v2 slice against the JAX package on the CPU:
``unique_parents``, the grouped vector attention in its three branch
combinations (eval and training mode, gradients), the block, grid pooling,
map unpooling, the whole PT-v2m2 and PT-v2m1 forward at a per-level
capacity, the weight bridge and the shipped S3DIS config at full width.

Inputs come from a numpy seed; parameters are made on the JAX side
(BatchNorm scales and running statistics randomised) and carried over by
the bridge.  The JAX side runs unfused (``FUSED_GVA = "off"``) with the
exact kNN, in f32.  Tolerances: a module rtol 1e-4 / atol 1e-5, the whole
forward 1e-4 x max |logit|, gradients 1e-3 of each tensor's max (f32 sums
over all the batch's slots in another order).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models.point_transformer_v2 import ptv2 as jptv2
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.ops.voxel import unique_parents as jax_unique_parents
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2 as port
from pointcloudpdf_tpu_torch.ops.gva import gva_plain
from pointcloudpdf_tpu_torch.ops.voxel import unique_parents
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_layer import randomise_bn
from test_torch_st import (grads_as_jax, japply, jinit, knn_tie_gap,
                           load_from_jax, tt)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = dict(
    type="PT-v2m2", in_channels=6, num_classes=13, patch_embed_depth=1,
    patch_embed_channels=16, patch_embed_groups=2, patch_embed_neighbours=8,
    enc_depths=(1, 2, 1), enc_channels=(16, 32, 32), enc_groups=(2, 4, 4),
    enc_neighbours=(8, 8, 8), dec_depths=(1, 1, 1), dec_channels=(16, 16, 32),
    dec_groups=(2, 2, 4), dec_neighbours=(8, 8, 8), grid_sizes=(0.15, 0.3, 0.6),
    attn_qkv_bias=True, pe_multiplier=False, pe_bias=True, drop_path_rate=0.0,
    level_capacity_factor=0.5)
BRANCHES = [(False, True), (True, False), (True, True)]
TOL = 1e-4                # x max |logit|
RTOL, ATOL = 1e-4, 1e-5   # single modules


def model_cfg(**backbone):
    return dict(type="DefaultSegmentor", backbone=dict(BACKBONE, **backbone),
                criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0,
                               ignore_index=-1)])


@pytest.fixture(scope="module", autouse=True)
def exact_jax_paths():
    old = (jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA)
    jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA = "exact", "off"
    yield
    jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA = old


def cloud(seed, b=2, n=2048, extent=(1.6, 1.2, 0.8), tail=405, c=6):
    """A padded batch: uniform coords in a box, the second sample with a
    masked tail of zeros."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(b, n, 3) * np.array(extent)).astype(np.float32)
    feat = rng.rand(b, n, c).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n] + [n - tail] * (b - 1))[:, None]
    coord[~mask] = 0.0
    feat[~mask] = 0.0
    return coord, feat, mask


def attention_inputs(seed, b=2, n=160, s=8, c=32):
    """Random neighbour rows (any row of the sample), ~20% of the slots and
    ~10% of the queries masked, one query with no valid slot."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(b, n, 3) * 0.5).astype(np.float32)
    feat = (rng.rand(b, n, c) - 0.5).astype(np.float32)
    idx = rng.randint(0, n, (b, n, s)).astype(np.int32)
    rmask = rng.rand(b, n, s) > 0.2
    mask = rng.rand(b, n) > 0.1
    rmask[:, 3] = False
    return feat, coord, idx, rmask, mask


def assert_param_grads_close(got, ref, tol):
    """Every parameter gradient within ``tol`` of its max |value| in
    ``ref``.  A bias right ahead of a batch-statistic BatchNorm, or of the
    softmax over the slots, has an exact gradient of 0 (the normalisation
    and the softmax remove a shift): both sides hold rounding noise there,
    which is held to the scale of the same layer's weight gradient."""
    got, ref = flatten_tree(got), flatten_tree(jax.tree_util.tree_map(np.asarray, ref))
    assert set(got) == set(ref)
    for path, r in ref.items():
        scale = np.abs(r).max()
        kernel = path[:-len("bias")] + "kernel"
        if path.endswith("/bias") and kernel in ref:
            scale = max(scale, np.abs(ref[kernel]).max())
        err = np.abs(got[path] - r).max()
        assert err <= tol * max(scale, 1e-30), (path, err)


# -- unique_parents -----------------------------------------------------------


@pytest.mark.parametrize("stride,capacity", [(1, None), (2, None), (1, 100)])
def test_unique_parents_matches_jax_slot_by_slot(stride, capacity):
    """Parent grids, masks and the child -> parent map equal slot for slot;
    at capacity 100 the parents of the largest keys overflow and their
    children map to -1 on both sides."""
    rng = np.random.RandomState(stride + (capacity or 0))
    grid = rng.randint(0, 7, (2, 300, 3)).astype(np.int32)
    mask = np.arange(300)[None, :] < np.array([[300], [220]])
    ref = jax.jit(jax.vmap(functools.partial(
        jax_unique_parents, stride=stride, capacity=capacity)))(grid, mask)
    got = unique_parents(*tt(grid, mask), stride, capacity)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    c2p = got[2].numpy()
    assert (c2p[~mask] == -1).all()
    if capacity is not None:
        assert got[1].numpy().all() and (c2p[mask] == -1).any()


# -- grouped vector attention --------------------------------------------------


def build_attention(pe, c=32, groups=4):
    kwargs = dict(pe_multiplier=pe[0], pe_bias=pe[1])
    return (jptv2.GroupedVectorAttention(c, groups, **kwargs),
            port.GroupedVectorAttention(c, groups, **kwargs))


ATTN = ("backbone_module/enc0_blocks/block0/attn",
        "backbone.enc_stages.0.blocks.blocks.0.attn.")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("pe", BRANCHES)
def test_grouped_vector_attention_matches_jax(pe, train):
    """Eval (running statistics: the wrapper, here the plain version) and
    training mode (``gva_plain``, batch statistics over the valid slots):
    output rtol 1e-4 / atol 1e-5; in training also every running statistic
    within 1e-6 and the gradient of a weighted sum of the output in every
    parameter and in the input within 1e-3 of each tensor's max."""
    args = attention_inputs(1 + 2 * pe[0] + pe[1])
    jattn, attn = build_attention(pe)
    v = randomise_bn(jinit(jattn, *args, train=False), np.random.RandomState(2))
    load_from_jax(attn, v, *ATTN)
    if not train:
        ref = np.asarray(japply(jattn, v, *args, train=False))
        with torch.inference_mode():
            got = attn.eval()(*tt(*args)).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        assert np.abs(got[~args[4]]).max() == 0.0 and np.abs(ref).max() > 0.1
        return
    ref, mut = japply(jattn, v, *args, train=True, mutable=["batch_stats"])
    x = torch.from_numpy(args[0]).requires_grad_(True)
    out = attn.train()(x, *tt(*args[1:]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    stats = flatten_tree(state_dict_to_jax(
        {ATTN[1] + k: t for k, t in attn.state_dict().items()})["batch_stats"])
    for path, r in flatten_tree(jax.tree_util.tree_map(
            np.asarray, {"backbone_module": {"enc0_blocks": {"block0": {
                "attn": mut["batch_stats"]}}}})).items():
        np.testing.assert_allclose(stats[path], r, rtol=0, atol=1e-6, err_msg=path)

    weight = np.random.RandomState(3).standard_normal(args[0].shape).astype(np.float32)

    def loss(params, feat):
        y, _ = jattn.apply({"params": params, "batch_stats": v["batch_stats"]},
                           feat, *args[1:], train=True, mutable=["batch_stats"])
        return jnp.sum(y * weight)

    ref_p, ref_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], args[0])
    (out * torch.from_numpy(weight)).sum().backward()
    assert_param_grads_close(grads_as_jax(attn, ATTN[1], ATTN[0]), ref_p, 1e-3)
    assert np.abs(x.grad.numpy() - np.asarray(ref_x)).max() <= 1e-3 * np.abs(ref_x).max()


def test_gva_plain_group_aggregation_matches_a_hand_loop():
    """``gva_plain`` in eval against the formula written out per query,
    slot and channel in float64: channel ch takes the softmax weight of
    group ch // (C / G), the bias encoding enters both the relation and the
    value, masked slots weigh 0."""
    rng = np.random.RandomState(4)
    b, n, s, c, g = 1, 6, 4, 16, 2
    torch.manual_seed(4)
    attn = port.GroupedVectorAttention(c, g, pe_multiplier=True, pe_bias=True)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.5)
    attn.eval()
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
               for _ in range(3))
    coord = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, n, (b, n, s)).astype(np.int32))
    nmask = torch.from_numpy(rng.rand(b, n, s) > 0.3)
    nmask[0, 2] = False
    with torch.no_grad():
        got = gva_plain(q, k, v, coord, idx, nmask, attn.linear_p_multiplier,
                        attn.linear_p_bias, attn.weight_encoding, g).numpy()

    def mlp(seq, x):
        lin1, bn, _, lin2 = seq
        d = lambda t: t.detach().double().numpy()  # noqa: E731
        h = x @ d(lin1.weight).T + d(lin1.bias)
        h = (h - d(bn.norm.running_mean)) / np.sqrt(d(bn.norm.running_var) + 1e-5)
        h = np.maximum(h * d(bn.norm.weight) + d(bn.norm.bias), 0.0)
        return h @ d(lin2.weight).T + d(lin2.bias)

    qd, kd, vd, cd = (t.double().numpy()[0] for t in (q, k, v, coord))
    want = np.zeros((n, c))
    for i in range(n):
        logits, values = [], []
        for slot in range(s):
            j = int(idx[0, i, slot])
            p = cd[j] - cd[i]
            peb = mlp(attn.linear_p_bias, p)
            rel = (kd[j] - qd[i]) * mlp(attn.linear_p_multiplier, p) + peb
            logits.append(mlp(attn.weight_encoding, rel))
            values.append(vd[j] + peb)
        valid = nmask[0, i].numpy()
        for ch in range(c):
            grp = ch // (c // g)
            w = np.array([logits[t][grp] for t in range(s)])
            e = np.where(valid, np.exp(w - w[valid].max()), 0.0) if valid.any() else 0 * w
            e = e / max(e.sum(), 1e-12)
            want[i, ch] = sum(e[t] * values[t][ch] for t in range(s))
    assert np.abs(want).max() > 0.5 and (want[2] == 0).all()
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-5)


# -- block, pooling, unpooling -------------------------------------------------------


@pytest.mark.parametrize("pe", BRANCHES)
def test_block_matches_jax(pe):
    """Eval, rtol 1e-4 / atol 1e-5."""
    args = attention_inputs(5, c=32)
    kwargs = dict(pe_multiplier=pe[0], pe_bias=pe[1])
    jblock, block = jptv2.Block(32, 4, **kwargs), port.Block(32, 4, **kwargs)
    v = randomise_bn(jinit(jblock, *args, train=False), np.random.RandomState(6))
    ref = np.asarray(japply(jblock, v, *args, train=False))
    load_from_jax(block, v, "backbone_module/enc1_blocks/block1",
                  "backbone.enc_stages.1.blocks.blocks.1.")
    with torch.inference_mode():
        got = block.eval()(*tt(*args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.abs(ref).max() > 0.1


def test_grid_pool_matches_jax():
    """Voxel ids equal at every point (0 differ: both divide), parent masks
    and the child -> parent map equal slot for slot, pooled features rtol
    1e-4 / atol 1e-5, parent coordinates (means) atol 1e-6."""
    coord, feat, mask = cloud(7, n=1024, tail=200, c=16)
    jpool = jptv2.GridPool(16, 32, 0.15, capacity=512)
    v = randomise_bn(jinit(jpool, feat, coord, mask, train=False),
                     np.random.RandomState(8))
    ref = japply(jpool, v, feat, coord, mask, train=False)
    pool = load_from_jax(port.GridPool(16, 32, 0.15), v, "backbone_module/enc0_pool",
                         "backbone.enc_stages.0.down.")
    with torch.inference_mode():
        got = pool.eval()(*tt(feat, coord, mask), capacity=512)
    start = np.where(mask[..., None], coord, np.inf).min(1, keepdims=True)
    want_grid = np.asarray(jax.jit(lambda c, s: jnp.floor((c - s) / 0.15))(coord, start))
    grid = torch.floor(port.divide_exact(torch.from_numpy(coord - start), 0.15)).numpy()
    assert int((grid[mask] != want_grid[mask]).sum()) == 0
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert (got[3].numpy()[mask] >= 0).all() and got[2].numpy().sum() > 100
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-6)


def test_unpool_with_skip_matches_jax():
    coord, feat, mask = cloud(9, n=256, tail=60, c=32)
    _, s_feat, s_mask = cloud(10, n=1024, tail=200, c=16)
    c2p = np.random.RandomState(11).randint(-1, 256, (2, 1024)).astype(np.int32)
    args = (feat, mask, s_feat, s_mask, c2p)
    jup = jptv2.UnpoolWithSkip(32, 16, 16)
    v = randomise_bn(jinit(jup, *args, train=False), np.random.RandomState(12))
    ref = np.asarray(japply(jup, v, *args, train=False))
    up = load_from_jax(port.UnpoolWithSkip(32, 16, 16), v,
                       "backbone_module/dec0_unpool", "backbone.dec_stages.0.up.")
    with torch.inference_mode():
        got = up.eval()(*tt(*args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# -- the whole model ---------------------------------------------------------------


def port_tree(cfg, seed):
    """Weights made on the port's side (torch init, BatchNorm scales and
    statistics randomised) as a JAX tree: the JAX model is then compiled
    for its forward only."""
    torch.manual_seed(seed)
    tree = state_dict_to_jax(build_model(cfg).state_dict())
    return randomise_bn(tree, np.random.RandomState(seed))


def jax_shapes(cfg, n=1024):
    """The JAX model's variable shapes by name (traced, not compiled)."""
    batch = dict(coord=jnp.zeros((1, n, 3)), feat=jnp.zeros((1, n, 6)),
                 mask=jnp.ones((1, n), bool))
    shapes = jax.eval_shape(functools.partial(jax_build_model(cfg).init, train=False),
                            {"params": jax.random.PRNGKey(0)}, batch)
    return {coll: {k: tuple(s.shape) for k, s in flatten_tree(dict(shapes[coll])).items()}
            for coll in ("params", "batch_stats")}


@pytest.mark.parametrize("kind", ["PT-v2m2", "PT-v2m1"])
def test_ptv2_forward_matches_jax(kind):
    """The whole forward in eval, at level capacity 0.5 of the padded
    length: logits within 1e-4 x max |logit|, no point dropped by the
    capacity on either side, and no kNN of the port's run with a near-tie
    (the JAX kNN's matmul-identity distances would order it otherwise: on
    seed 13 two neighbours of one query lie 9.9e-8 apart in d^2)."""
    cfg = model_cfg(type=kind, pe_multiplier=kind == "PT-v2m1",
                    pe_bias=kind == "PT-v2m2")
    coord, feat, mask = cloud(40)
    batch = dict(coord=jnp.asarray(coord), feat=jnp.asarray(feat),
                 mask=jnp.asarray(mask))
    tree = port_tree(cfg, 14)
    ref, diag = japply(jax_build_model(cfg), tree, batch, train=False,
                       mutable=["diagnostics"])
    dropped = [int(x) for x in jax.tree_util.tree_leaves(diag)]
    assert len(dropped) == 3 and sum(dropped) == 0
    ref = np.asarray(ref["seg_logits"])

    model = build_model(cfg).eval()
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    port_knn, gaps = port.knn, []

    def recording_knn(query, ref_pts, k, ref_mask=None):
        gaps.append(knn_tie_gap(query, ref_pts, k, ref_mask))
        return port_knn(query, ref_pts, k, ref_mask)

    port.capacity_dropped_points(reset=True)
    port.knn = recording_knn
    try:
        with torch.inference_mode():
            got = model(dict(zip(("coord", "feat", "mask"),
                                 tt(coord, feat, mask))))["seg_logits"].numpy()
    finally:
        port.knn = port_knn
    assert len(gaps) == 4 and min(gaps) >= 5e-7, gaps
    assert port.capacity_dropped_points(reset=True) == 0
    assert got.shape == ref.shape == (2, 2048, 13)
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    assert (got[1, 2048 - 405:] == 0).all()


def test_ptv2_bridge_round_trip_bit_equal():
    """A model with both positional encodings: its tree has the JAX model's
    names and shapes; JAX tree -> state_dict -> JAX tree is bit-equal, and
    the module loads it with strict=True."""
    cfg = model_cfg(pe_multiplier=True)
    tree = port_tree(cfg, 16)
    got = {coll: {k: a.shape for k, a in flatten_tree(tree[coll]).items()}
           for coll in ("params", "batch_stats")}
    assert got == jax_shapes(cfg)
    sd = jax_to_state_dict(tree)
    module = build_model(cfg)
    module.load_state_dict(sd, strict=True)
    back = state_dict_to_jax(module.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back) > 400
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)
        assert flat_back[path].dtype == leaf.dtype
    assert sd["backbone.enc_stages.1.blocks.blocks.1.attn.linear_q.1.norm.running_mean"
              ].shape == (32,)
    assert sd["backbone.patch_embed.blocks.blocks.0.attn.q_fc1.weight"].shape == (16, 16)
    assert sd["backbone.dec_stages.2.up.proj_skip.0.weight"].shape == (32, 32)
    assert sd["backbone.seg_head.1.norm.weight"].shape == (16,)


@pytest.mark.parametrize("name", ["semseg-pt-v2m2-0-base", "semseg-pt-v2m1-0-base"])
def test_s3dis_ptv2_config_builds_at_full_width(name):
    """The shipped S3DIS configs build at their real widths (no forward):
    the same parameter and statistics shapes as the JAX tree's, names and
    all, and so the same parameter count."""
    path = os.path.join(ROOT, "configs", "s3dis", f"{name}.py")
    cfg = Config.fromfile(path)
    model = build_model(dict(cfg.model))
    backbone = model.backbone
    assert [len(s.blocks.blocks) for s in backbone.enc_stages] == [2, 6, 2]
    attn = backbone.enc_stages[2].blocks.blocks[0].attn
    assert attn.groups == 48 and attn.linear_q[0].in_features == 384
    assert (attn.linear_p_multiplier is None) == name.endswith("v2m2-0-base")
    tree = state_dict_to_jax(model.state_dict())
    ref = jax_shapes(JaxConfig.fromfile(path).model)
    for coll in ("params", "batch_stats"):
        got = {k: tuple(a.shape) for k, a in flatten_tree(tree[coll]).items()}
        assert got == ref[coll] and len(got) > 100
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in ref["params"].values())
