"""The port's PT-v3m1 slice against the JAX package on the CPU: the z-order
and Hilbert codes of the four curve orders and the per-level sorts
(``_sort_orders``), serialized patch attention with and without RPE,
grid pooling with tied children, the whole small PT-v3 through
``DefaultSegmentorV2`` (eval logits, the voxel maps, the level capacities'
drop count, PDNorm BatchNorm and LayerNorm banks by condition, ``cls_mode``),
one ``DefaultTrainer`` step (its training-mode forward and gradient), the
drop path's generator, the bridge, the shipped configs' shapes, the options
the port rejects, and the collation of a fragment past the largest bucket.

Reductions from the shipped S3DIS ``-rpe`` config (five stages of widths 32
to 512, patches of 128, 204,800-point crops, batch 12): two stages of
widths (8, 16), encoder depths (1, 2), decoder (1,), two heads, patches of
16 (RPE offsets clipped at 7), orders ("hilbert", "z-trans") so that a
stage of two blocks reads both, level capacity 0.5 with a floor of 64 (two
stages keep the JAX compiles short: the step's takes ~14 s); two samples of
500 and 430 voxels padded to 512 on a small room's planes (a surface: a level keeps about a third of its children's voxels).
Weights are made on the port's side (kernels of unit gain, norm scales and
statistics randomised, RPE tables at 0.3) and carried over by the bridge.
Three JAX compiles of a PT-v3 in all (module-scope caches): the eval
forward, the trainer's step, and the PDNorm ``cls_mode`` model under two
conditions in one.

Tolerances: codes, sorts and maps bit-equal; a module rtol 1e-4 / atol
1e-5; a whole forward 1e-4 x max |logit|; whole-network gradients as
``test_torch_cac_losses.assert_gradient_triple`` holds them (port and JAX
each against the port's float64 gradient too).
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as jnn

from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from pointcloudpdf_tpu.models.point_transformer_v3 import ptv3 as jptv3
from pointcloudpdf_tpu.ops import serialization as jser
from pointcloudpdf_tpu.ops import voxel as jvox
from pointcloudpdf_tpu.parallel.mesh import create_mesh
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.norm import _bn_factory
from pointcloudpdf_tpu_torch.models.point_transformer_v3 import ptv3 as port
from pointcloudpdf_tpu_torch.ops import serialization as ser
from pointcloudpdf_tpu_torch.ops import voxel
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_cac_losses import assert_gradient_triple, float64_gradients
from test_torch_layer import randomise_bn
from test_torch_spunet import _jax_maps_fn, volume_cells
from test_torch_st import japply, jinit, tt
from test_torch_train import CFG, port_gradients, record_gradients, recorded_gradients

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4                # x max |logit|
RTOL, ATOL = 1e-4, 1e-5   # single modules
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
BACKBONE = dict(type="PT-v3m1", in_channels=6, order=("hilbert", "z-trans"),
                stride=(2,), enc_depths=(1, 2), enc_channels=(8, 16),
                enc_num_head=(2, 2), enc_patch_size=(16, 16), dec_depths=(1,),
                dec_channels=(8,), dec_num_head=(2,), dec_patch_size=(16,),
                drop_path=0.0, enable_rpe=True, enable_flash=False,
                level_capacity_factor=0.5, min_level_capacity=64)
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
SEGMENTOR = dict(type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=8,
                 backbone=BACKBONE, criteria=CRITERIA)
CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")
PD_CLS = dict(SEGMENTOR, num_classes=7, backbone_out_channels=16, backbone=dict(
    BACKBONE, cls_mode=True, enable_rpe=False, enc_depths=(1, 1), pdnorm_bn=True,
    pdnorm_ln=True, pdnorm_adaptive=True, pdnorm_conditions=CONDITIONS))


def surface_cells(rng, count):
    """``count`` distinct voxels of a small room's floor, two walls and a
    table top, most of its cells: each 2^3 parent holds several."""
    cells = [(x, y, 0) for x in range(16) for y in range(16)]
    cells += [(0, y, z) for y in range(16) for z in range(1, 10)]
    cells += [(x, 0, z) for x in range(1, 16) for z in range(1, 10)]
    cells += [(x, y, 6) for x in range(4, 12) for y in range(4, 12)]
    pick = rng.choice(len(cells), count, replace=False)
    return np.asarray(cells, np.int32)[pick]


def scene(seed, counts=(500, 430), n=512, cells=surface_cells):
    """A padded batch of voxel sets, features and labels."""
    rng = np.random.RandomState(seed)
    grid = np.zeros((len(counts), n, 3), np.int32)
    for i, c in enumerate(counts):
        grid[i, :c] = cells(rng, c)
    mask = np.arange(n)[None, :] < np.array(counts)[:, None]
    feat = (rng.rand(len(counts), n, 6) * mask[..., None]).astype(np.float32)
    segment = np.where(mask, rng.randint(0, 13, mask.shape), -1).astype(np.int64)
    return dict(grid_coord=grid, feat=feat, mask=mask, segment=segment)


def set_leaf(tree, path, value):
    node = tree
    for part in path.split("/")[:-1]:
        node = node[part]
    node[path.rsplit("/", 1)[1]] = value


def weights(cfg, seed):
    """A segmentor's JAX tree made on the port's side: every kernel of unit
    gain (a PD norm's modulation at 0.3), the RPE tables at 0.3, norm
    scales and statistics randomised."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    tree = randomise_bn(state_dict_to_jax(build_model(dict(cfg)).state_dict()), rng)
    for path, a in flatten_tree(tree["params"]).items():
        if "modulation" in path or path.endswith("rpe_table"):
            set_leaf(tree["params"], path, (0.3 * rng.standard_normal(a.shape)).astype(
                np.float32))
        elif path.endswith("kernel"):
            fan_in = int(np.prod(a.shape[:-1]))
            set_leaf(tree["params"], path, (rng.standard_normal(a.shape) / np.sqrt(fan_in)
                                            ).astype(np.float32))
    return tree


def models(cfg, seed):
    """The JAX and port segmentors of ``cfg`` on one set of weights."""
    tree = weights(cfg, seed)
    model = build_model(dict(cfg))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    return jax_build_model(dict(cfg)), model, tree


def inputs(batch):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items() if k != "segment"}


@functools.lru_cache(maxsize=None)
def _jax_orders_fn(orders):
    return jax.jit(functools.partial(jptv3._sort_orders, orders=orders))


def assert_maps_match_jax(model, batch):
    """The port's maps (``PointTransformerV3.index_maps``) equal the JAX
    functions' chained as the JAX module chains them, bit for bit: the 5^3
    and 3^3 tables, parents at the level capacities, child -> parent maps,
    and each level's sorts and inverses.  On a parity input this also
    asserts that the JAX hash tables were exact there (ROADMAP: the JAX
    hash is lossy and may find keys that are not in the set)."""
    backbone = model.backbone
    got = backbone.index_maps(*tt(batch["grid_coord"], batch["mask"]))
    caps = tuple(m.shape[1] for m in got["mask"][1:])
    ref = _jax_maps_fn(caps)(batch["grid_coord"], batch["mask"])
    np.testing.assert_array_equal(got["nbr5"].numpy(), np.asarray(ref["nbr5"]))
    for key in ("nbr3", "grid", "mask", "c2p"):
        assert len(got[key]) == len(ref[key])
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    for s, (g, m) in enumerate(zip(ref["grid"], ref["mask"])):
        perm, inv = _jax_orders_fn(backbone.order)(g, m)
        np.testing.assert_array_equal(got["order"][s].numpy(), np.asarray(perm))
        np.testing.assert_array_equal(got["inverse"][s].numpy(), np.asarray(inv))
    return got


_JAX_EVAL = {}


def jax_forward(jmodel, tree, batch, **kwargs):
    """The JAX eval logits and the summed drop diagnostic (one compile a
    model and call options)."""
    key = (id(jmodel), tuple(sorted(kwargs.items())))
    if key not in _JAX_EVAL:
        _JAX_EVAL[key] = jax.jit(functools.partial(
            jmodel.apply, train=False, mutable=["diagnostics"], **kwargs))
    out, diag = _JAX_EVAL[key](tree, {k: v for k, v in batch.items() if k != "segment"})
    dropped = sum(int(x) for x in jax.tree_util.tree_leaves(diag.get("diagnostics", {})))
    return np.asarray(out["seg_logits"]), dropped


def assert_logits_close(got, ref, mask=None):
    ref = np.asarray(ref)
    err = np.abs(got - ref).max()
    assert np.abs(ref).max() > 0.1
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())
    if mask is not None:
        assert np.isfinite(got).all() and got.shape[:2] == mask.shape


# -- serialization --------------------------------------------------------------------


def tied_grid(seed, shape=(2, 300)):
    """Grid coordinates up to 1,300 (past the 10-bit clip: 1023 and
    anything larger tie), with repeated cells."""
    rng = np.random.RandomState(seed)
    grid = rng.randint(0, 1300, shape + (3,)).astype(np.int32)
    grid[:, 50:80] = grid[:, :30]
    grid[:, 80:90, 0] = 1023
    grid[:, 90:100] = grid[:, 80:90] + np.array([200, 0, 0], np.int32)
    return grid


@pytest.mark.parametrize("order", [*ORDERS, "hilbert_trans", "z_trans"])
def test_serialize_code_matches_jax(order):
    """Every order's codes (and the ``_`` spelling) bit-equal to JAX's,
    int64 holding the uint32 values, on coordinates past 1023 (clipped, so
    tied) and repeated cells; the Hilbert curve's unit steps on a 4^3 cube."""
    grid = tied_grid(1)
    got = ser.serialize_code(torch.from_numpy(grid), order)
    assert got.dtype == torch.int64
    ref = np.asarray(jser.serialize_code(jnp.asarray(grid), order)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got[:, 80:90] == got[:, 90:100]).all()        # clipped: tied
    cube = np.array([[x, y, z] for x in range(4) for y in range(4) for z in range(4)])
    codes = ser.hilbert_encode(torch.from_numpy(cube), bits=2).numpy()
    np.testing.assert_array_equal(
        codes, np.asarray(jser.hilbert_encode(jnp.asarray(cube), bits=2)).astype(np.int64))
    path = cube[np.argsort(codes)]
    assert (np.abs(np.diff(path, axis=0)).sum(1) == 1).all()


def test_sort_orders_match_jax():
    """``_sort_orders`` over the four orders: permutations and inverses
    equal to JAX's (its stable argsort) with tied codes and masked rows,
    which sort last in row order; the inverse undoes the permutation."""
    grid = tied_grid(2)
    mask = np.ones(grid.shape[:2], bool)
    mask[0, 250:] = False
    mask[1, ::3] = False
    got_p, got_i = port._sort_orders(*tt(grid, mask), ORDERS)
    ref_p, ref_i = _jax_orders_fn(ORDERS)(grid, mask)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    rows = torch.arange(300).expand(2, 300)
    for p, i in zip(got_p, got_i):
        assert torch.equal(p.gather(1, i), rows)
    np.testing.assert_array_equal(got_p[0, 1, 200:].numpy(),
                                  np.nonzero(~mask[1])[0][-100:])


# -- attention and pooling ------------------------------------------------------------


def attention_case(seed, n=100, counts=(100, 40), c=16, heads=2):
    """Two samples at N = 100 (patches of 16: padded to 112); the second
    holds 40 valid rows, so its last patches are fully masked."""
    rng = np.random.RandomState(seed)
    grid = np.stack([surface_cells(rng, n) for _ in counts])
    mask = np.arange(n)[None, :] < np.array(counts)[:, None]
    feat = rng.standard_normal((len(counts), n, c)).astype(np.float32)
    order, inverse = port._sort_orders(*tt(grid, mask), ("hilbert",))
    g = rng.standard_normal((len(counts), n, c)).astype(np.float32)
    return grid, mask, feat, order, inverse, g


@pytest.mark.parametrize("rpe", [False, True], ids=["no-rpe", "rpe"])
def test_serialized_attention_matches_jax(rpe):
    """``SerializedAttention`` at N = 100 not a multiple of K = 16, with a
    fully masked patch, against JAX's on its weights: the output rtol 1e-4
    / atol 1e-5, padded rows 0; the gradients of the input, qkv, proj and
    the RPE table at the same tolerances."""
    grid, mask, feat, order, inverse, g = attention_case(3)
    jmod = jptv3.SerializedAttention(16, 2, 16, enable_rpe=rpe)
    args = (order[0].numpy().astype(np.int32), inverse[0].numpy().astype(np.int32), mask)
    v = jinit(jmod, feat, *args, False, grid)
    rng = np.random.RandomState(4)
    v = jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(
        np.float32), v)
    ref = np.asarray(japply(jmod, v, feat, *args, False, grid))

    def jloss(params, x):
        return jnp.sum(jmod.apply({"params": params}, x, *args, False, grid) * g)

    ref_gp, ref_gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(v["params"], feat)
    mod = port.SerializedAttention(16, 2, 16, enable_rpe=rpe)
    p = v["params"]
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(mod, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T))
            getattr(mod, name).bias.copy_(torch.from_numpy(p[name]["bias"]))
        if rpe:
            mod.rpe.rpe_table.copy_(torch.from_numpy(p["rpe"]["rpe_table"]))
    nbr = voxel.neighbor_table(*tt(grid, mask), voxel.kernel_offsets(3))
    level = port.Level(torch.from_numpy(grid), torch.from_numpy(mask), nbr, order, inverse)
    x = torch.from_numpy(feat).requires_grad_(True)
    out = mod(x, level, 0)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    assert (out[~torch.from_numpy(mask)] == 0).all()
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=RTOL, atol=ATOL)
    for name in ("qkv", "proj"):
        np.testing.assert_allclose(getattr(mod, name).weight.grad.numpy().T,
                                   np.asarray(ref_gp[name]["kernel"]), rtol=RTOL, atol=1e-4)
        np.testing.assert_allclose(getattr(mod, name).bias.grad.numpy(),
                                   np.asarray(ref_gp[name]["bias"]), rtol=RTOL, atol=1e-4)
    if rpe:
        np.testing.assert_allclose(mod.rpe.rpe_table.grad.numpy(),
                                   np.asarray(ref_gp["rpe"]["rpe_table"]),
                                   rtol=RTOL, atol=1e-4)


class JaxPool(jnn.Module):
    """The JAX module's grid pooling, which it writes inline
    (``pointcloudpdf_tpu/models/point_transformer_v3/ptv3.py:433-459``):
    projection, a segment max in f32 (empty parents 0), BatchNorm, ReLU."""

    channels: int

    @jnn.compact
    def __call__(self, feat, c2p, p_mask, train):
        b, child_n = c2p.shape
        cap = p_mask.shape[1]
        proj = jnn.Dense(self.channels, name="proj")(feat)
        flat_c2p = jvox.flatten_slot_map(c2p, slot_count=cap)
        valid = (flat_c2p >= 0)[:, None]
        pooled = jnp.full((b * cap, self.channels), -jnp.inf, jnp.float32).at[
            jnp.maximum(flat_c2p, 0)].max(jnp.where(
                valid, proj.reshape(b * child_n, -1).astype(jnp.float32), -jnp.inf))
        pooled = jnp.where(jnp.isfinite(pooled), pooled, 0.0)
        flat_p_mask = p_mask.reshape(b * cap)
        pooled = JaxMaskedBatchNorm(self.channels, momentum=0.01, epsilon=1e-3,
                                    name="bn")(pooled, flat_p_mask, train)
        pooled = jnn.relu(pooled)
        return jnp.where(flat_p_mask[:, None], pooled, 0.0).reshape(b, cap, -1)


def test_pooling_with_tied_children_matches_jax():
    """``SerializedPooling`` in training mode at a capacity that drops
    children, with children of one parent given equal features (their
    projections tie, and the max's gradient is shared among them): the
    output and the gradients of the input and the projection rtol 1e-4 /
    atol 1e-5; the tied children's input gradients equal."""
    batch = scene(5)
    grid, mask = tt(batch["grid_coord"], batch["mask"])
    cap = 128
    _, p_mask, c2p = voxel.unique_parents(grid, mask, 2, capacity=cap)
    assert int((mask & (c2p < 0)).sum()) > 0
    rng = np.random.RandomState(5)
    feat = rng.standard_normal((2, 512, 8)).astype(np.float32)
    first = {}
    for b in range(2):
        for i in range(512):
            key = (b, int(c2p[b, i]))
            if key[1] >= 0:
                feat[b, i] = feat[b, first.setdefault(key, i)]
    ties = [(b, i) for b in range(2) for i in range(512)
            if c2p[b, i] >= 0 and first[(b, int(c2p[b, i]))] != i]
    assert len(ties) > 300
    g = rng.standard_normal((2, cap, 16)).astype(np.float32)
    jmod = JaxPool(16)
    args = (c2p.numpy(), p_mask.numpy())
    v = jinit(jmod, feat, *args, train=False)
    ref = np.asarray(jax.jit(lambda v_, x: jmod.apply(v_, x, *args, True,
                                                      mutable=["batch_stats"])[0])(v, feat))

    def jloss(params, x):
        out, _ = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, x, *args,
                            True, mutable=["batch_stats"])
        return jnp.sum(out * g)

    ref_gp, ref_gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(v["params"], feat)
    mod = port.SerializedPooling(8, 16, _bn_factory())
    with torch.no_grad():
        mod.proj.weight.copy_(torch.from_numpy(v["params"]["proj"]["kernel"].T))
        mod.proj.bias.copy_(torch.from_numpy(v["params"]["proj"]["bias"]))
    x = torch.from_numpy(feat).requires_grad_(True)
    out = mod.train()(x, c2p, p_mask)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mod.proj.weight.grad.numpy().T,
                               np.asarray(ref_gp["proj"]["kernel"]), rtol=RTOL, atol=1e-4)
    for b, i in ties:
        j = first[(b, int(c2p[b, i]))]
        np.testing.assert_array_equal(x.grad[b, i].numpy(), x.grad[b, j].numpy())


# -- the network ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def main_models():
    return models(SEGMENTOR, 10)


def test_eval_forward_matches_jax(main_models):
    """The small PT-v3 through ``DefaultSegmentorV2`` in eval: the maps and
    sorts bit-equal, logits within 1e-4 x max |logit|, no point dropped on
    either side."""
    jmodel, model, tree = main_models
    batch = scene(11)
    got_maps = assert_maps_match_jax(model, batch)
    assert [m.shape[1] for m in got_maps["mask"]] == [512, 256]
    assert all(0 < int(m.sum(1).max()) < m.shape[1] for m in got_maps["mask"][1:])
    ref, jdropped = jax_forward(jmodel, tree, batch)
    voxel.capacity_dropped_points(reset=True)
    with torch.inference_mode():
        got = model.eval()(inputs(batch))["seg_logits"].numpy()
    assert got.shape == (2, 512, 13)
    assert_logits_close(got, ref, batch["mask"])
    assert voxel.capacity_dropped_points(reset=True) == jdropped == 0


def test_capacity_overflow_drop_count_matches_jax(main_models):
    """A volume filled at random keeps about one child a parent: the half
    capacity drops children at the stride.  The drop count equals the
    JAX diagnostic's sum, and the logits still agree."""
    jmodel, model, tree = main_models
    batch = scene(12, cells=volume_cells)
    assert_maps_match_jax(model, batch)
    ref, jdropped = jax_forward(jmodel, tree, batch)
    voxel.capacity_dropped_points(reset=True)
    with torch.inference_mode():
        got = model.eval()(inputs(batch))["seg_logits"].numpy()
    assert voxel.capacity_dropped_points(reset=True) == jdropped > 100
    assert_logits_close(got, ref, batch["mask"])


@pytest.fixture(scope="module")
def pd_models():
    """The PDNorm ``cls_mode`` segmentor: the JAX backbone alone (the JAX
    segmentor passes no condition on), its tree, and the port's segmentor."""
    _, model, tree = models(PD_CLS, 13)
    backbone_tree = {coll: tree[coll]["backbone_module"] for coll in tree}
    return jax_build_model(dict(PD_CLS["backbone"])), model, tree, backbone_tree


@pytest.mark.parametrize("condition", ["ScanNet", "S3DIS"])
def test_pdnorm_cls_mode_matches_jax(pd_models, condition):
    """``cls_mode`` (a masked mean over the deepest level, then the head:
    (B, classes)) with PDNorm BatchNorms and LayerNorms, decoupled and
    adaptive on a context, under two conditions named by the call: within
    1e-4 x max |logit| of JAX's, and apart from the other condition's
    (named by the batch's ``condition_name``)."""
    jbackbone, model, tree, backbone_tree = pd_models
    batch = scene(14)
    batch["context"] = np.random.RandomState(14).rand(256).astype(np.float32)
    key = id(jbackbone)
    if key not in _JAX_EVAL:
        # both conditions in one compile
        _JAX_EVAL[key] = jax.jit(lambda v, b: {c: jbackbone.apply(v, b, train=False,
                                                                  condition=c)
                                               for c in ("ScanNet", "S3DIS")})
    feat = _JAX_EVAL[key](backbone_tree, {k: v for k, v in batch.items()
                                          if k != "segment"})[condition]
    head = tree["params"]["seg_head"]
    ref = np.asarray(feat) @ head["kernel"] + head["bias"]
    other = "S3DIS" if condition == "ScanNet" else "ScanNet"
    model.eval()
    with torch.inference_mode():
        got = model.backbone(inputs(batch), condition=condition)
        got = model.seg_head(got).numpy()
        named = model(dict(inputs(batch), condition_name=other))["seg_logits"].numpy()
    assert got.shape == (2, 7)
    assert_logits_close(got, ref)
    assert np.abs(got - named).max() > 0.05 * np.abs(got).max()


def test_default_trainer_step_matches_jax(tmp_path):
    """One ``DefaultTrainer`` step through both packages of the shipped
    S3DIS ``-rpe`` config at the reduced width (AdamW, OneCycleLR, the
    ``block`` group at a tenth of the rate, CE + Lovasz), f32 without
    autocast, Mix3D off and drop path 0 (the JAX trainer runs neither
    autocast nor Mix3D on the CPU, and its drop path draws from JAX's RNG):
    the training-mode forward's loss rtol 1e-4, its gradient as
    ``assert_gradient_triple`` holds it, the running statistics rtol 1e-5 /
    atol 1e-5, both groups' rates equal, the parameters after the step
    within 1e-4 of max(1, max |value|), and ``block`` selecting the same
    parameters in both packages."""
    shipped = Config.fromfile(os.path.join(ROOT, "configs", "s3dis",
                                           "semseg-pt-v3m1-0-rpe.py"))
    model = dict(shipped.model)
    model["backbone"] = dict(model["backbone"], **{k: v for k, v in BACKBONE.items()
                                                   if k != "type"})
    model["backbone_out_channels"] = 8
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=model,
               optimizer=dict(shipped.optimizer), scheduler=dict(shipped.scheduler),
               param_dicts=[dict(p) for p in shipped.param_dicts],
               data=dict(CFG["data"], num_classes=13))
    assert cfg["param_dicts"] == [dict(keyword="block", lr=0.0006)]
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(copy.deepcopy(cfg))))
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    # a batch of 2 is replicated over the tests' 8 virtual devices, not
    # sharded: the step is the same on one, and compiles sooner
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
    assert_maps_match_jax(trainer.model, batch)
    in_block = sorted(n for n, _ in trainer.model.named_parameters() if "block" in n)
    jax_in_block = sorted(p for p in flatten_tree(start["params"]) if "block" in p)
    assert len(in_block) == len(jax_in_block) > 0
    assert {k for k in flatten_tree(state_dict_to_jax(
        {n: p for n, p in trainer.model.named_parameters() if "block" in n})["params"])
    } == set(jax_in_block)
    truth = float64_gradients(
        trainer.model, trainer.device_batch(np_batch),
        lambda out, b: trainer.model.loss(out["seg_logits"], b["segment"]))
    rng = jax.random.fold_in(jtrainer._base_rng, 1)
    jtrainer.state, jout = jtrainer._train_step(jtrainer.state, jbatch, rng)
    trainer.comm_info["input_dict"] = np_batch
    grads = port_gradients(trainer, trainer.run_step)
    out = trainer.comm_info["model_output_dict"]
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4)
    # the JAX schedule is f32 arithmetic
    assert trainer.comm_info["lr"] == pytest.approx(float(jtrainer.scheduler(0)), rel=1e-6)
    assert [g["lr"] for g in trainer.optimizer.param_groups] == pytest.approx(
        [trainer.comm_info["lr"], trainer.comm_info["lr"] * 0.1])
    assert_gradient_triple(grads, recorded_gradients(jtrainer), truth, "PT-v3 step")
    state = state_dict_to_jax(trainer.model.state_dict())
    got, ref = (flatten_tree(jax.tree_util.tree_map(np.asarray, t["batch_stats"])) for t in (
        state, {"batch_stats": jtrainer.state.batch_stats}))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=1e-5, atol=1e-5, err_msg=path)
    # AdamW's first step moves a parameter by lr g / (|g| + eps): where the
    # gradient is at the f32 noise of the whole network (the k bias, which
    # the softmax cancels), the two packages' steps point anywhere in
    # [-lr, lr]; elsewhere they agree
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
    model = build_model(dict(SEGMENTOR, backbone=dict(BACKBONE, drop_path=0.5))).train()
    batch = inputs(scene(15))
    state = torch.get_rng_state()
    outs = [model(batch, generator=torch.Generator().manual_seed(s))["seg_logits"].detach()
            for s in (1, 1, 2)]
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="generator"):
        model(batch)


# -- bridge, configs, options -----------------------------------------------------------


def jax_shapes(cfg, condition=None):
    """The JAX model's parameter and statistics shapes by path (traced, not
    compiled); a PDNorm model's under ``condition`` (the batch's
    ``condition_name``: the JAX segmentor passes no condition on)."""
    batch = {k: jnp.asarray(v) for k, v in scene(20, counts=(60, 50), n=64).items()
             if k != "segment"}
    batch["context"] = jnp.zeros((256,), jnp.float32)
    if condition is not None:
        batch["condition_name"] = condition
    shapes = jax.eval_shape(lambda: jax_build_model(dict(cfg)).init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))
    return {coll: {k: tuple(v.shape) for k, v in flatten_tree(dict(shapes[coll])).items()}
            for coll in ("params", "batch_stats")}


def tree_shapes(tree):
    return {coll: {k: a.shape for k, a in flatten_tree(tree[coll]).items()}
            for coll in ("params", "batch_stats")}


PD_SHARED = dict(SEGMENTOR, backbone=dict(
    BACKBONE, pdnorm_bn=True, pdnorm_ln=True, pdnorm_decouple=False,
    pdnorm_conditions=CONDITIONS))


@pytest.mark.parametrize("cfg", [SEGMENTOR, PD_CLS, PD_SHARED],
                         ids=["v3m1", "pdnorm-cls", "pdnorm-shared"])
def test_bridge_round_trip_bit_equal(cfg):
    """The port's tree has the JAX model's names and shapes (PD banks
    stacked (3, C) or (1, C), LayerNorms under ``ln`` or as PD banks, the
    RPE tables (3 rpe_num, H), the convs (K, C_in, C_out)); the state_dict
    holds the reference's names; JAX tree -> state_dict -> JAX tree is
    bit-equal and loads with strict=True."""
    tree = weights(cfg, 19)
    assert tree_shapes(tree) == jax_shapes(
        cfg, "S3DIS" if cfg["backbone"].get("pdnorm_bn") else None)
    model = build_model(dict(cfg))
    sd = jax_to_state_dict(tree)
    model.load_state_dict(sd, strict=True)
    sd = model.state_dict()
    assert sd["backbone.embedding.stem.conv.weight"].shape == (125, 6, 8)
    assert sd["backbone.enc.enc0.block0.cpe.0.weight"].shape == (27, 8, 8)
    assert "backbone.enc.enc0.block0.cpe.0.bias" in sd
    assert "backbone.enc.enc1.down.proj.weight" in sd
    assert "seg_head.weight" in sd
    for key in ("attn.qkv.weight", "attn.proj.bias", "mlp.0.fc1.weight", "mlp.0.fc2.bias"):
        assert f"backbone.enc.enc1.block0.{key}" in sd
    if cfg is SEGMENTOR:
        assert sd["backbone.enc.enc0.block0.attn.rpe.rpe_table"].shape == (3 * 15, 2)
        for key in ("backbone.embedding.stem.norm.running_var",
                    "backbone.enc.enc1.down.norm.0.running_mean",
                    "backbone.dec.dec0.up.proj.1.weight",
                    "backbone.dec.dec0.up.proj_skip.1.bias",
                    "backbone.dec.dec0.block0.norm2.0.weight",
                    "backbone.enc.enc0.block0.cpe.2.bias", "backbone.enc.enc0.block0.norm1.0.weight"):
            assert key in sd, key
    elif cfg is PD_CLS:
        assert "backbone.dec.dec0.up.proj.0.weight" not in sd
        for key in ("backbone.embedding.stem.norm.bns.2.running_mean",
                    "backbone.enc.enc1.down.norm.0.bns.1.weight",
                    "backbone.enc.enc0.block0.cpe.2.norm.1.weight",
                    "backbone.enc.enc0.block0.norm1.0.modulation.1.weight",
                    "backbone.enc.enc0.block0.norm2.0.norm.2.bias"):
            assert key in sd, key
    else:
        assert "backbone.enc.enc0.block0.norm1.0.norm.weight" in sd
        assert "backbone.embedding.stem.norm.bn.running_mean" in sd
    back = state_dict_to_jax(sd)
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


_BACKBONE_SHAPES = {}


@pytest.mark.parametrize("path,params", [
    ("s3dis/semseg-pt-v3m1-0-rpe.py", 46.19), ("scannet/semseg-pt-v3m1-0-base.py", 46.16),
    ("scannet200/semseg-pt-v3m1-0-base.py", 46.17)])
def test_shipped_configs_build(path, params):
    """The shipped PT-v3 configs build at full width (millions of
    parameters as stated; on the meta device: the shapes without their
    46 M initial values, which ``chip_smoke.py`` phase 14 makes and runs),
    every parameter and statistic's shape, named through the bridge, equal
    to the JAX init tree's: the backbone's traced by ``jax.eval_shape``
    (not compiled; once for the ScanNet and ScanNet200 configs, which share
    it), the segmentor's ``seg_head`` (C, classes)."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", path))
    with torch.device("meta"):
        model = build_model(dict(cfg.model))
    assert sum(p.numel() for p in model.parameters()) / 1e6 == pytest.approx(params, abs=0.01)
    key = repr(sorted(cfg.model.backbone.items()))
    if key not in _BACKBONE_SHAPES:
        _BACKBONE_SHAPES[key] = jax_shapes(dict(cfg.model.backbone))
    want = {coll: {f"backbone_module/{k}": v for k, v in shapes.items()}
            for coll, shapes in _BACKBONE_SHAPES[key].items()}
    want["params"].update({"seg_head/kernel": (cfg.model.backbone_out_channels,
                                               cfg.model.num_classes),
                           "seg_head/bias": (cfg.model.num_classes,)})
    assert tree_shapes(state_dict_to_jax(
        {k: torch.empty(v.shape, dtype=v.dtype) for k, v in model.state_dict().items()})) == want


@pytest.mark.parametrize("key,value", [
    ("dense_extent", (64, 64, 32)), ("conv_window", 1024), ("conv_coverage_check", True),
    ("qk_scale", 0.5), ("attn_drop", 0.1), ("proj_drop", 0.1), ("pre_norm", False),
    ("stride", (2, 4))])
def test_rejected_options_name_themselves(key, value):
    """The dense-extent path is not ported, and values the JAX module
    ignores but that would change the result raise, each named; the
    config-parity switches pass."""
    with pytest.raises(NotImplementedError, match=key):
        build_model(dict(BACKBONE, **{key: value}))
    build_model(dict(BACKBONE, enable_flash=True, upcast_attention=False,
                     upcast_softmax=False, shuffle_orders=True))


def test_collate_keeps_fragments_past_the_largest_bucket():
    """A 270,664-point test fragment (a room at 2 cm) pads to a multiple of
    65,536 past the largest bucket (262,144) and keeps every point: the
    JAX collation truncates it there, and the tester's vote then fails."""
    coord = np.zeros((270664, 3), np.float32)
    out = padded_collate_fn([dict(coord=coord, segment=np.zeros(270664, np.int64))])
    assert out["coord"].shape == (1, 327680, 3)
    assert int(out["count"][0]) == 270664
    out = padded_collate_fn([dict(coord=coord[:1000])])
    assert out["coord"].shape == (1, 1024, 3)
