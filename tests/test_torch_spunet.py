"""The port's SpUNet slice against the JAX package on the CPU: kernel
offsets, the exact neighbour table (against the JAX ``build_table`` +
``lookup`` and the JAX hash ``neighbor_table``), the parent maps and their
flattening, ``gather_conv``, ``scatter_mean_to_parent`` and the strided
convs, the SpUNet-v1m1 forward
in eval mode, ``cls_mode``, a MinkUNet50
(bottleneck) forward, SpUNet-v1m3's condition banks, the level capacities'
drop count, the voxel-key bound, the bridge, the shipped configs and one
``DefaultTrainer`` step of the shipped S3DIS SpUNet config (its
training-mode forward and gradient).

Reductions from the shipped S3DIS SpUNet config (channels (32, 64, 128,
256, 256, 128, 96, 96), layers (2, 3, 4, 6, 2, 2, 2, 2), 80,000-point
crops, batch 12): two samples of 2,000 and 1,700 voxels padded to 2,048,
channels (16, 16, 32, 32, 32, 16, 16, 16), one block a stage, base channels
16, level capacity 0.5 as shipped.  ``cls_mode``, MinkUNet50, the
features and SpUNet-v1m3 run one stage (channels (16, 16), one block each)
to keep the JAX compiles short.  Inputs are seeded voxel sets on a room's
planes (floor, two walls, a table top): surfaces, on which a level keeps
fewer than half its children's voxels, as on real scans.  Weights are made
on the port's side (kernels of unit gain, BatchNorm scales and statistics
randomised) and carried over by the bridge.

Tolerances: tables and maps bit-equal; a module rtol 1e-4 / atol 1e-5; a
whole forward 1e-4 x max |logit|; whole-network gradients as
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

from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models.losses import build_criteria as jax_build_criteria
from pointcloudpdf_tpu.models.sparse_unet import spconv_unet as jsp
from pointcloudpdf_tpu.ops import voxel as jvox
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import (backbone_state_dict_to_jax,
                                            jax_to_backbone_state_dict,
                                            jax_to_state_dict, state_dict_to_jax)
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.losses import build_criteria
from pointcloudpdf_tpu_torch.models.norm import PDMaskedBatchNorm
from pointcloudpdf_tpu_torch.models.sparse_unet import spconv_unet as port
from pointcloudpdf_tpu_torch.ops import voxel
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_cac_losses import assert_gradient_triple, float64_gradients, grad_tree
from test_torch_layer import randomise_bn
from test_torch_st import japply, jinit, tt
from test_torch_train import CFG, port_gradients, record_gradients, recorded_gradients

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4                # x max |logit|
RTOL, ATOL = 1e-4, 1e-5   # single modules
BACKBONE = dict(type="SpUNet-v1m1", in_channels=6, num_classes=13, base_channels=16,
                channels=(16, 16, 32, 32, 32, 16, 16, 16), layers=(1,) * 8,
                level_capacity_factor=0.5)
ONE_STAGE = dict(BACKBONE, channels=(16, 16), layers=(1, 1))
CE = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]


def room_cells(rng, count, size=(48, 40, 30)):
    """``count`` distinct voxels of a room's surfaces, in random order."""
    cells = set()
    while len(cells) < count:
        u, v, w = rng.randint(size[0]), rng.randint(size[1]), rng.randint(size[2])
        cells.add([(u, v, 0), (u, 0, w), (0, v, w),
                   (10 + u % 12, 8 + v % 10, 12 + w % 2)][rng.randint(4)])
    return np.array(sorted(cells), np.int32)[rng.permutation(count)]


def scene(seed, counts=(2000, 1700), n=2048, cells=room_cells):
    """A padded batch of voxel sets, features and labels."""
    rng = np.random.RandomState(seed)
    grid = np.zeros((len(counts), n, 3), np.int32)
    for i, c in enumerate(counts):
        grid[i, :c] = cells(rng, c)
    mask = np.arange(n)[None, :] < np.array(counts)[:, None]
    feat = (rng.rand(len(counts), n, 6) * mask[..., None]).astype(np.float32)
    segment = np.where(mask, rng.randint(0, 13, mask.shape), -1).astype(np.int64)
    return dict(grid_coord=grid, feat=feat, mask=mask, segment=segment)


def volume_cells(rng, count, side=40):
    """``count`` distinct voxels filling a cube at random: most parents
    keep one child, so a half capacity overflows."""
    flat = rng.choice(side ** 3, count, replace=False)
    return np.stack(np.unravel_index(flat, (side,) * 3), -1).astype(np.int32)


def weights(cfg, seed, backbone_only=True):
    """A JAX tree made on the port's side: every kernel of unit gain (so a
    forward's logits are O(1)), BatchNorm scales and statistics randomised."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    model = build_model(dict(cfg))
    sd = model.state_dict()
    tree = backbone_state_dict_to_jax(sd) if backbone_only else state_dict_to_jax(sd)
    randomise_bn(tree, rng)
    for path, a in flatten_tree(tree["params"]).items():
        if path.endswith("kernel") and "modulation" not in path:
            fan_in = int(np.prod(a.shape[:-1]))
            node = tree["params"]
            for part in path.split("/")[:-1]:
                node = node[part]
            node["kernel"] = (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(
                np.float32)
    return tree


def models(cfg, seed):
    """The JAX and port backbones of ``cfg`` on one set of weights."""
    tree = weights(cfg, seed)
    model = build_model(dict(cfg))
    model.load_state_dict(jax_to_backbone_state_dict(tree), strict=True)
    return jax_build_model(dict(cfg)), model, tree


def inputs(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if k != "segment"}


@functools.lru_cache(maxsize=None)
def _jax_maps_fn(capacities):
    """The JAX functions chained as the JAX SpUNet chains them: each
    level's hash neighbour table, the stem's 5^3 one and the parents at
    ``capacities``."""
    table = jax.vmap(jvox.neighbor_table, in_axes=(0, 0, None))

    def maps(grid, mask):
        out = dict(nbr5=table(grid, mask, jvox.kernel_offsets(5)), nbr3=[],
                   grid=[grid], mask=[mask], c2p=[])
        for cap in capacities:
            out["nbr3"].append(table(grid, mask, jvox.kernel_offsets(3)))
            grid, mask, c2p = jax.vmap(functools.partial(
                jvox.unique_parents, stride=2, capacity=cap))(grid, mask)
            for key, value in (("grid", grid), ("mask", mask), ("c2p", c2p)):
                out[key].append(value)
        out["nbr3"].append(table(grid, mask, jvox.kernel_offsets(3)))
        return out

    return jax.jit(maps)


def assert_maps_match_jax(batch, levels=5):
    """The port's voxel maps of a four-stage SpUNet (``index_maps``) equal
    the JAX functions', bit for bit, over the first ``levels`` levels.  On
    a parity input this also asserts that the JAX hash was exact there: it
    may leave a key unplaced (~1e-4) or find a key that is not in the set
    (a tag collision, ~2^-16 a probe at this size; met at some seeds), and
    either gives a voxel other neighbours than the exact table's."""
    got = build_model(dict(BACKBONE)).index_maps(*tt(batch["grid_coord"], batch["mask"]))
    caps = tuple(m.shape[1] for m in got["mask"][1:])
    ref = _jax_maps_fn(caps)(batch["grid_coord"], batch["mask"])
    np.testing.assert_array_equal(got["nbr5"].numpy(), np.asarray(ref["nbr5"]))
    for key in ("nbr3", "grid", "mask", "c2p"):
        for a, b in list(zip(got[key], ref[key]))[:levels]:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    return got, ref


_JAX_EVAL = {}


def jax_forward(jmodel, tree, batch, **kwargs):
    """The JAX eval forward and its summed drop diagnostic (one compile a
    model and call options)."""
    key = (id(jmodel), tuple(sorted(kwargs.items())))
    if key not in _JAX_EVAL:
        _JAX_EVAL[key] = jax.jit(functools.partial(
            jmodel.apply, train=False, mutable=["diagnostics"], **kwargs))
    jbatch = {k: v for k, v in batch.items() if k != "segment"}
    out, diag = _JAX_EVAL[key](tree, jbatch)
    dropped = sum(int(x) for x in diag.get("diagnostics", {}).get(
        "capacity_dropped_points", ()))
    return np.asarray(out), dropped


def assert_logits_close(got, ref, mask=None):
    ref = np.asarray(ref)
    err = np.abs(got - ref).max()
    assert np.abs(ref).max() > 0.1
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())
    if mask is not None:
        assert (got[~mask] == 0).all()


# -- voxel maps ---------------------------------------------------------------------


@pytest.mark.parametrize("size", [3, 5])
def test_kernel_offsets_match_jax(size):
    np.testing.assert_array_equal(voxel.kernel_offsets(size), jvox.kernel_offsets(size))


def jax_table_lookup(grid, mask, offsets):
    """The JAX sorted table per sample: ``build_table`` + ``lookup`` of
    every in-bounds query of a valid row."""
    def one(g, m):
        keys, rows = jvox.build_table(g, m)
        q = g[:, None, :] + jnp.asarray(offsets)[None]
        ok = m[:, None] & jnp.all(q >= 0, axis=-1)
        qk = jnp.where(ok, jvox.pack_grid(jnp.maximum(q, 0)), jnp.uint32(0xFFFFFFFF))
        return jnp.where(ok, jvox.lookup(keys, rows, qk.reshape(-1)).reshape(ok.shape), -1)
    return np.asarray(jax.jit(jax.vmap(one))(grid, mask))


@pytest.mark.parametrize("size", [3, 5])
def test_neighbor_table_matches_jax(size):
    """Bit-equal to the JAX ``build_table`` + ``lookup`` (a sample with
    duplicate cells too: the lower row is found on both sides), and to the
    JAX hash ``neighbor_table`` on the scene without duplicates, after
    checking that its hash placed every key."""
    batch = scene(1)
    grid, mask = batch["grid_coord"], batch["mask"]
    offsets = voxel.kernel_offsets(size)
    got = voxel.neighbor_table(*tt(grid, mask), offsets).numpy()
    assert got.shape == (2, 2048, size ** 3) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_table_lookup(grid, mask, offsets))
    placed = jax.vmap(lambda g, m: jvox.lookup_hash(
        jvox.build_hash_table(g, m), jvox.pack_grid(g), n_rows=g.shape[0]))(grid, mask)
    assert (np.asarray(placed)[mask] == np.nonzero(mask)[1]).all()
    ref = jax.jit(jax.vmap(functools.partial(jvox.neighbor_table, offsets=offsets)))(
        grid, mask)
    np.testing.assert_array_equal(got, np.asarray(ref))
    hits = (got >= 0).sum(-1)[mask]
    assert hits.min() >= 1 and hits.max() < size ** 3
    # two rows in one cell (a Mix3D merge)
    dup = grid.copy()
    dup[0, 1000:1400] = dup[0, :400]
    got = voxel.neighbor_table(*tt(dup, mask), offsets).numpy()
    np.testing.assert_array_equal(got, jax_table_lookup(dup, mask, offsets))
    centre = got[0, :, size ** 3 // 2]
    np.testing.assert_array_equal(centre[1000:1400], centre[:400])
    np.testing.assert_array_equal(centre[:400], np.arange(400))


def test_level_maps_and_flattening_match_jax():
    """Every level of the SpUNet's maps (``SpUNet.index_maps``: parents at
    the config's capacities, the child -> parent maps, each level's 3^3
    table and the stem's 5^3 one) bit-equal to the JAX functions chained as
    the JAX module chains them; ``flatten_neighbor_rows`` and
    ``flatten_slot_map`` bit-equal to theirs."""
    got, ref = assert_maps_match_jax(scene(2))
    assert [m.shape[1] for m in got["mask"]] == [2048, 1024, 512, 256, 128]
    assert all(int(m.sum()) > 0 for m in got["mask"])
    for s in range(5):
        np.testing.assert_array_equal(
            voxel.flatten_neighbor_rows(got["nbr3"][s]).numpy(),
            np.asarray(jvox.flatten_neighbor_rows(ref["nbr3"][s])))
    for s in range(4):
        n = got["mask"][s + 1].shape[1]
        np.testing.assert_array_equal(voxel.flatten_slot_map(got["c2p"][s], n).numpy(),
                                      np.asarray(jvox.flatten_slot_map(ref["c2p"][s], n)))


def test_voxel_key_bound():
    """A grid past the bit budget (any axis at 2^20, or negative) raises
    and names the grid's extent; the last cell in bounds passes; x = 2048,
    past the JAX package's 11 bits, passes and the forward runs; padded
    rows do not count."""
    batch = scene(3)
    model = build_model(dict(BACKBONE)).eval()
    top = 1 << 20
    for axis, limit in ((0, top), (1, top), (2, top), (0, -1)):
        bad = dict(batch, grid_coord=batch["grid_coord"].copy())
        bad["grid_coord"][1, 5, axis] = limit
        with pytest.raises(ValueError, match=r"extent .* cells\) is outside"):
            voxel.check_grid_bound(*tt(bad["grid_coord"], bad["mask"]))
        with pytest.raises(ValueError, match="voxel grid"):
            with torch.inference_mode():
                model(inputs(bad))
        bad["grid_coord"][1, 5, axis] = top - 1
        if limit > 0:
            voxel.check_grid_bound(*tt(bad["grid_coord"], bad["mask"]))
    wide = dict(batch, grid_coord=batch["grid_coord"].copy())
    wide["grid_coord"][1, 5, 0] = 2048
    voxel.check_grid_bound(*tt(wide["grid_coord"], wide["mask"]))
    with torch.inference_mode():
        assert torch.isfinite(model(inputs(wide))).all()
    pad = batch["grid_coord"].copy()
    pad[1, -1] = (2 * top, 2 * top, 2 * top)
    voxel.check_grid_bound(*tt(pad, batch["mask"]))


# -- convs --------------------------------------------------------------------------


def test_gather_conv_matches_jax():
    """The 3^3 submanifold conv on the flat rows of a two-sample table,
    forward and the gradients of feat and weights, rtol 1e-4 / atol 1e-5;
    the rulebook holds the present pairs alone."""
    batch = scene(4)
    nbr = voxel.flatten_neighbor_rows(voxel.neighbor_table(
        *tt(batch["grid_coord"], batch["mask"]), voxel.kernel_offsets(3)))
    rng = np.random.RandomState(4)
    feat = rng.standard_normal((nbr.shape[0], 16)).astype(np.float32)
    w = (rng.standard_normal((27, 16, 24)) / 20).astype(np.float32)
    g = rng.standard_normal((nbr.shape[0], 24)).astype(np.float32)

    def jloss(f, w_):
        return jnp.sum(jvox.gather_conv(f, jnp.asarray(nbr.numpy()), w_) * g)

    ref = np.asarray(jax.jit(jvox.gather_conv)(feat, nbr.numpy(), w))
    ref_gf, ref_gw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(feat, w)
    rules = voxel.table_rulebook(nbr)
    assert sum(rules.counts) == int((nbr >= 0).sum()) == rules.in_rows.shape[0]
    f, wt = (torch.from_numpy(a).requires_grad_(True) for a in (feat, w))
    out = voxel.gather_conv(f, rules, wt)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(ref_gf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_gw), rtol=RTOL, atol=1e-4)
    # the (M, K) table form builds the same rulebook
    np.testing.assert_array_equal(voxel.gather_conv(f, nbr, wt).detach().numpy(),
                                  out.detach().numpy())


def test_scatter_mean_to_parent_matches_jax():
    """Children's features mean-pooled onto their parents at a capacity of
    1,024 (padding left out, the slots past a sample's parents 0), against
    the JAX function: rtol 1e-5 / atol 1e-6."""
    batch = scene(6)
    grid, mask = tt(batch["grid_coord"], batch["mask"])
    _, p_mask, c2p = voxel.unique_parents(grid, mask, 2, capacity=1024)
    c2p_flat = voxel.flatten_slot_map(c2p, 1024)
    feat = np.random.RandomState(6).standard_normal((2 * 2048, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(jvox.scatter_mean_to_parent, static_argnums=2)(
        feat, c2p_flat.numpy(), 2 * 1024))
    got = voxel.scatter_mean_to_parent(torch.from_numpy(feat), c2p_flat, 2 * 1024).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    empty = ~p_mask.numpy().reshape(-1)
    assert empty.any() and (got[empty] == 0).all()


def test_strided_convs_match_jax():
    """``SparseDownConv`` and ``SparseInverseConv`` on one level's parent
    map (children of parents past a capacity of 512 dropped), the JAX
    modules' weights carried over as they are: rtol 1e-4 / atol 1e-5."""
    batch = scene(5)
    grid, mask = tt(batch["grid_coord"], batch["mask"])
    cap = 512
    _, p_mask, c2p = voxel.unique_parents(grid, mask, 2, capacity=cap)
    c2p_flat = voxel.flatten_slot_map(c2p, cap)
    assert int((mask.reshape(-1) & (c2p_flat < 0)).sum()) > 0
    pos = ((grid[..., 0] % 2) * 4 + (grid[..., 1] % 2) * 2 + grid[..., 2] % 2).reshape(-1)
    down, up = voxel.map_rulebooks(c2p_flat, pos, 2 * cap)
    rng = np.random.RandomState(5)
    feat = rng.standard_normal((2 * 2048, 16)).astype(np.float32)
    pfeat = rng.standard_normal((2 * cap, 32)).astype(np.float32)
    args = (jnp.asarray(c2p_flat.numpy()), jnp.asarray(pos.numpy()),
            jnp.asarray((c2p_flat >= 0).numpy()))
    for jcls, cls, x, extra, rules in (
            (jsp.SparseDownConv, port.SparseDownConv, feat, dict(num_parents=2 * cap), down),
            (jsp.SparseInverseConv, port.SparseInverseConv, pfeat, {}, up)):
        c_in, c_out = x.shape[1], 24
        jmod = jcls(c_in, c_out)
        v = jinit(jmod, x, *args, seed=c_in, **extra)
        ref = np.asarray(japply(jmod, v, x, *args, **extra))
        mod = cls(c_in, c_out)
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"])))
        got = mod(torch.from_numpy(x), rules).detach().numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# -- the network --------------------------------------------------------------------


@pytest.fixture(scope="module")
def main_models():
    return models(BACKBONE, 10)


def test_eval_forward_matches_jax(main_models):
    """SpUNet-v1m1 at the reduced width in eval: logits within 1e-4 x max
    |logit|, padded rows 0, no point dropped on either side."""
    jmodel, model, tree = main_models
    batch = scene(11)
    assert_maps_match_jax(batch)
    ref, jdropped = jax_forward(jmodel, tree, batch)
    voxel.capacity_dropped_points(reset=True)
    with torch.inference_mode():
        got = model.eval()(inputs(batch)).numpy()
    assert got.shape == (2, 2048, 13)
    assert_logits_close(got, ref, batch["mask"])
    assert voxel.capacity_dropped_points(reset=True) == jdropped == 0


def test_capacity_overflow_drop_count_matches_jax(main_models):
    """A volume of voxels filled at random keeps about one child a parent:
    the half capacities drop children at every stride.  The drop count
    equals the JAX diagnostic's sum, and the logits still agree."""
    jmodel, model, tree = main_models
    batch = scene(12, cells=volume_cells)
    assert_maps_match_jax(batch)
    ref, jdropped = jax_forward(jmodel, tree, batch)
    voxel.capacity_dropped_points(reset=True)
    with torch.inference_mode():
        got = model.eval()(inputs(batch)).numpy()
    dropped = voxel.capacity_dropped_points(reset=True)
    assert dropped == jdropped > 100
    assert_logits_close(got, ref, batch["mask"])


@pytest.mark.parametrize("cfg", [
    dict(ONE_STAGE, cls_mode=True, num_classes=7),
    dict(ONE_STAGE, type="MinkUNet50"),
    dict(ONE_STAGE, num_classes=0)], ids=["cls_mode", "MinkUNet50", "features"])
def test_variants_match_jax(cfg):
    """One stage each: ``cls_mode`` (a masked mean over the deepest
    level, (B, classes)); MinkUNet50's bottleneck blocks (1x1, 3^3, 1x1 at
    expansion 4: 128-wide outputs); ``num_classes`` 0 (the decoder's
    features, as CAC takes them).  Within 1e-4 x max |output|."""
    jmodel, model, tree = models(cfg, 14)
    batch = scene(15)
    assert_maps_match_jax(batch, levels=2)
    ref, _ = jax_forward(jmodel, tree, batch)
    with torch.inference_mode():
        got = model.eval()(inputs(batch)).numpy()
    if cfg.get("cls_mode"):
        assert got.shape == (2, 7)
    else:
        width = 16 * (4 if cfg["type"] == "MinkUNet50" else 1)
        assert got.shape[-1] == (width if cfg["num_classes"] == 0 else 13)
    assert_logits_close(got, ref, None if cfg.get("cls_mode") else batch["mask"])
    if cfg["type"] == "MinkUNet50":
        assert "enc.0.block0.conv3.weight" in model.state_dict()


M3 = dict(ONE_STAGE, type="SpUNet-v1m3", norm_adaptive=True, context_channels=8,
          zero_init=False)


@pytest.fixture(scope="module")
def m3_models():
    jmodel, model, tree = models(M3, 16)
    rng = np.random.RandomState(16)
    for path, a in flatten_tree(tree["params"]).items():
        if "modulation" in path:
            node = tree["params"]
            for part in path.split("/")[:-1]:
                node = node[part]
            node[path.rsplit("/", 1)[1]] = (0.3 * rng.standard_normal(a.shape)).astype(
                np.float32)
    model.load_state_dict(jax_to_backbone_state_dict(tree), strict=True)
    return jmodel, model, tree


def m3_batch(seed):
    batch = scene(seed)
    batch["context"] = np.random.RandomState(seed).rand(8).astype(np.float32)
    return batch


@pytest.mark.parametrize("condition", ["ScanNet", "Structured3D"])
def test_v1m3_condition_selects_its_bank(m3_models, condition):
    """SpUNet-v1m3 (decoupled, adaptive) in eval under ScanNet and
    Structured3D (S3DIS trains below), named by the call: within 1e-4 x max
    |logit| of JAX's, and apart from another condition's logits (named by
    the batch's ``condition_name``); a forward with no condition raises."""
    jmodel, model, tree = m3_models
    batch = m3_batch(17)
    assert_maps_match_jax(batch, levels=2)
    ref, _ = jax_forward(jmodel, tree, batch, condition=condition)
    with torch.inference_mode():
        got = model.eval()(inputs(batch), condition=condition).numpy()
        other = model(dict(inputs(batch), condition_name="ScanNet" if condition != "ScanNet"
                           else "S3DIS")).numpy()
    assert_logits_close(got, ref, batch["mask"])
    assert np.abs(got - other).max() > 0.1 * np.abs(got).max()
    with pytest.raises(ValueError, match="condition"):
        with torch.inference_mode():
            model(inputs(batch))


def test_v1m3_step_moves_only_the_active_bank(m3_models):
    """Training under ``S3DIS``: the loss rtol 1e-4 and the gradient as
    ``assert_gradient_triple`` holds it (the inactive banks' rows 0 on both
    sides); the running statistics within 1e-5 of JAX's; every other bank
    bit-equal to its start."""
    jmodel, model, tree = m3_models
    model = copy.deepcopy(model)
    batch = m3_batch(18)
    assert_maps_match_jax(batch, levels=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    criteria = jax_build_criteria(CE)
    stats0 = jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"])

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": stats0},
                                jbatch, train=True, condition="S3DIS",
                                mutable=["batch_stats", "diagnostics"])
        return criteria(out, jbatch["segment"]), mut["batch_stats"]

    (ref, stats), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree["params"])
    loss_of = build_criteria(CE)
    named = dict(batch, condition_name="S3DIS")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    truth = float64_gradients(model, named, lambda out, b: loss_of(out, b["segment"]),
                              backbone_state_dict_to_jax)
    loss = loss_of(model.train()(dict(inputs(batch), condition_name="S3DIS")),
                   torch.from_numpy(batch["segment"]))
    assert float(loss) == pytest.approx(float(ref), rel=1e-4)
    loss.backward()
    grads = grad_tree(model, to_jax=backbone_state_dict_to_jax)
    assert_gradient_triple(grads, ref_g, truth, "SpUNet-v1m3")
    scale = flatten_tree(grads)["enc0_block0/bn1/scale"]
    assert (scale[[0, 2]] == 0).all() and np.abs(scale[1]).max() > 0
    got = flatten_tree(backbone_state_dict_to_jax(model.state_dict())["batch_stats"])
    for path, r in flatten_tree(jax.tree_util.tree_map(np.asarray, stats)).items():
        np.testing.assert_allclose(got[path], r, rtol=1e-5, atol=1e-5, err_msg=path)
    moved = 0
    for key, t in model.state_dict().items():
        if "running" in key:
            same = torch.equal(t, start[key])
            assert same != (".bns.1." in key), key
            moved += not same
    assert moved == 2 * sum(isinstance(m, PDMaskedBatchNorm) for m in model.modules())


def test_rejects_the_dense_extent_path():
    for key, value in (("dense_extent", (64, 64, 32)), ("conv_window", 1024),
                       ("conv_coverage_check", True)):
        with pytest.raises(NotImplementedError, match=key):
            build_model(dict(BACKBONE, **{key: value}))


# -- bridge and configs ---------------------------------------------------------------


def jax_shapes(cfg, **kwargs):
    """The JAX model's parameter and statistics shapes by path (traced,
    not compiled)."""
    batch = {k: jnp.asarray(v) for k, v in m3_batch(20).items() if k != "segment"}
    shapes = jax.eval_shape(lambda: jax_build_model(dict(cfg)).init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False, **kwargs))
    return {coll: {k: tuple(v.shape) for k, v in flatten_tree(dict(shapes[coll])).items()}
            for coll in ("params", "batch_stats")}


@pytest.mark.parametrize("cfg", [
    BACKBONE, M3, dict(M3, norm_decouple=False, norm_adaptive=False),
    dict(ONE_STAGE, type="MinkUNet50")], ids=["v1m1", "v1m3", "v1m3-shared", "MinkUNet50"])
def test_bridge_round_trip_bit_equal(cfg):
    """The port's tree has the JAX model's names and shapes (PD banks
    stacked (3, C), the bottleneck's conv1 / conv3 as Dense kernels, the
    convs' (K, C_in, C_out)); JAX tree -> state_dict -> JAX tree is
    bit-equal and loads with strict=True."""
    kwargs = dict(condition="S3DIS") if "v1m3" in cfg["type"] else {}
    tree = weights(cfg, 19)
    assert {coll: {k: a.shape for k, a in flatten_tree(tree[coll]).items()}
            for coll in ("params", "batch_stats")} == jax_shapes(cfg, **kwargs)
    model = build_model(dict(cfg))
    sd = jax_to_backbone_state_dict(tree)
    model.load_state_dict(sd, strict=True)
    assert sd["conv_input.0.weight"].shape == (125, 6, 16)
    assert sd["down.0.0.weight"].shape == (8, 16, 16)
    back = backbone_state_dict_to_jax(model.state_dict())
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("path,params", [
    ("s3dis/semseg-spunet-v1m1-0-base.py", 39.16), ("s3dis/semseg-spunet-v1m2-0-base.py", 39.16),
    ("s3dis/semseg-minkunet34c-0-base.py", 39.16),
    ("scannet/semseg-cac-v1m1-0-spunet-base.py", 39.29),
    ("scannet/semseg-spunet-v1m3-0-pdnorm-base.py", 39.20)])
def test_shipped_configs_build(path, params):
    """The shipped configs build at full width in the port (millions of
    parameters as stated; on the meta device but the first); the S3DIS
    SpUNet-v1m1's tree goes through the bridge both ways with the JAX
    model's names and shapes (six blocks a stage and all)."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", path))
    full = path.startswith("s3dis/semseg-spunet-v1m1")
    with torch.device("cpu" if full else "meta"):
        model = build_model(dict(cfg.model))
    assert sum(p.numel() for p in model.parameters()) / 1e6 == pytest.approx(params, abs=0.01)
    if full:
        tree = state_dict_to_jax(model.state_dict())
        model.load_state_dict(jax_to_state_dict(tree), strict=True)
        got = {coll: {k: a.shape for k, a in flatten_tree(tree[coll]).items()}
               for coll in ("params", "batch_stats")}
        assert got == jax_shapes(cfg.model)


# -- a trainer step -------------------------------------------------------------------


def test_default_trainer_step_matches_jax(tmp_path):
    """One ``DefaultTrainer`` step of the shipped S3DIS SpUNet config (SGD,
    Nesterov, lr 0.1, weight decay 1e-4, ``PolyLR`` with the base config's
    MultiStepLR keys, which the port drops; CE) at the reduced width
    through both packages, from one start (``weights``), f32 without
    autocast and Mix3D off (the JAX trainer runs neither on the CPU).  Its
    training-mode forward and gradient: the loss rtol 1e-4, the gradient
    as ``assert_gradient_triple`` holds it, the running statistics rtol
    1e-5 / atol 1e-5 (one forward's batch statistics); the rate equal; the
    parameters after the step within 1e-4 of max(1, the tensor's max
    |value|): the step moves a zero-initialised BatchNorm bias by lr x its
    gradient, and the two gradients differ by the JAX package's f32
    noise."""
    shipped = Config.fromfile(os.path.join(ROOT, "configs", "s3dis",
                                           "semseg-spunet-v1m1-0-base.py"))
    model = dict(shipped.model)
    model["backbone"] = dict(model["backbone"], **{k: BACKBONE[k] for k in (
        "base_channels", "channels", "layers")})
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=model,
               optimizer=dict(shipped.optimizer), scheduler=dict(shipped.scheduler),
               param_dicts=None)
    assert cfg["scheduler"] == dict(type="PolyLR", power=0.9, milestones=[0.6, 0.8],
                                    gamma=0.1)
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(cfg)))
    # the JAX trainer raises on the keys the PT-v1 base leaves in the
    # PolyLR dict; the port drops them
    cfg["scheduler"] = dict(type="PolyLR", power=0.9)
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    record_gradients(jtrainer)
    batch = scene(21)
    assert_maps_match_jax(batch)
    np_batch = dict(coord=batch["grid_coord"] * np.float32(0.04),
                    grid_coord=batch["grid_coord"], feat=batch["feat"],
                    segment=batch["segment"], count=batch["mask"].sum(1).astype(np.int32))
    start = weights(model, 22, backbone_only=False)
    jtrainer._init_variables = lambda batch, rng: (start["params"], start["batch_stats"])
    jbatch = jtrainer.device_batch(np_batch)
    jtrainer.initialize_state(jbatch)
    trainer.model.load_state_dict(jax_to_state_dict(start), strict=True)
    truth = float64_gradients(
        trainer.model, trainer.device_batch(np_batch),
        lambda out, b: trainer.model.loss(out["seg_logits"], b["segment"]))
    rng = jax.random.fold_in(jtrainer._base_rng, 1)
    jtrainer.state, jout = jtrainer._train_step(jtrainer.state, jbatch, rng)
    trainer.comm_info["input_dict"] = np_batch
    grads = port_gradients(trainer, trainer.run_step)
    out = trainer.comm_info["model_output_dict"]
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4)
    assert trainer.comm_info["lr"] == pytest.approx(float(jtrainer.scheduler(0)), abs=1e-12)
    assert_gradient_triple(grads, recorded_gradients(jtrainer), truth, "SpUNet step")
    state = state_dict_to_jax(trainer.model.state_dict())
    got, ref = (flatten_tree(jax.tree_util.tree_map(np.asarray, t["batch_stats"])) for t in (
        state, {"batch_stats": jtrainer.state.batch_stats}))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=1e-5, atol=1e-5, err_msg=path)
    got, ref = (flatten_tree(jax.tree_util.tree_map(np.asarray, t)) for t in (
        state["params"], jtrainer.state.params))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        err = np.abs(got[path] - r).max()
        assert err <= 1e-4 * max(np.abs(r).max(), 1.0), (path, err)
