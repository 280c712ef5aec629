"""The port's OA-CNNs against the JAX package on the CPU: the segment means
and sums, the adaptive block in eval and training mode with its gradients
(a case where the padded rows' vector sets the adaptive softmax's maximum,
and what a level without that row would compute there), the whole small
OA-CNNs through ``DefaultSegmentor`` in eval on clustered voxels (the JAX
voxel tables asserted exact), compacted levels against full-length ones,
one ``DefaultTrainer`` step under CE + Lovasz with AdamW, the bridge and the
shipped ScanNet config's shapes at full width.

Reductions from the shipped ScanNet OA-CNNs config (four stages of widths
64 / 64 / 128 / 256 with 3 / 3 / 9 / 8 blocks, four grid sizes a stage,
decoder 256, 2 cm voxels, batch 12): two stages of widths 8 / 16, one block
each, grid sizes (2, 3) at both, decoder 8 / 16, stem 8; two samples of
1,500 and 1,300 voxels of a room's surfaces padded to 1,536.  One JAX
model, compiled once for its eval forward and once for its trainer step.

Tolerances: tables and maps bit-equal; a module rtol 1e-4 / atol 1e-5; a
whole forward 1e-4 x max |logit|; whole-network gradients as
``test_torch_cac_losses.assert_gradient_triple`` holds them.
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
from pointcloudpdf_tpu.models.oacnns import oacnns as joa
from pointcloudpdf_tpu.ops import voxel as jvox
from pointcloudpdf_tpu.parallel.mesh import create_mesh
from pointcloudpdf_tpu.utils.optimizer import build_optimizer as jax_build_optimizer
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.norm import _bn_factory
from pointcloudpdf_tpu_torch.models.oacnns import oacnns as port
from pointcloudpdf_tpu_torch.ops import voxel
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_cac_losses import assert_gradient_triple, float64_gradients
from test_torch_layer import randomise_bn
from test_torch_ptv3 import tree_shapes
from test_torch_spunet import room_cells, weights
from test_torch_st import tt
from test_torch_swin3d import jax_shapes
from test_torch_train import CFG, port_gradients, record_gradients, recorded_gradients

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "configs", "scannet", "semseg-oacnns-v1m1-0-base.py")
TOL = 1e-4                # x max |logit|
RTOL, ATOL = 1e-4, 1e-5   # single modules
SIZES = (2, 3)
BACKBONE = dict(type="OACNNs", in_channels=6, num_classes=5, embed_channels=8,
                enc_channels=(8, 16), groups=(2, 2), enc_depth=(1, 1), down_ratio=(2, 2),
                dec_channels=(8, 16), point_grid_size=(SIZES, SIZES), dec_depth=(1, 1),
                enc_num_ref=(16, 16))
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
SEGMENTOR = dict(type="DefaultSegmentor", backbone=BACKBONE, criteria=CRITERIA)
OFF3 = jvox.kernel_offsets(3)


def scene(seed, counts=(1500, 1300), n=1536, classes=5):
    """A padded batch of voxel sets on a room's surfaces (clustered: most
    parents hold several children), features and labels."""
    rng = np.random.RandomState(seed)
    grid = np.zeros((len(counts), n, 3), np.int32)
    for i, c in enumerate(counts):
        grid[i, :c] = room_cells(rng, c)
    mask = np.arange(n)[None, :] < np.array(counts)[:, None]
    feat = (rng.rand(len(counts), n, 6) * mask[..., None]).astype(np.float32)
    segment = np.where(mask, rng.randint(0, classes, mask.shape), -1).astype(np.int64)
    return dict(grid_coord=grid, feat=feat, mask=mask, segment=segment)


def inputs(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if k != "segment"}


@functools.lru_cache(maxsize=None)
def _jax_maps_fn(stages):
    """The JAX voxel functions chained as the JAX OA-CNNs chains them: each
    level's hash neighbour table, its parents (capacity N) and its clusters
    at each grid size."""
    table = jax.vmap(jvox.neighbor_table, in_axes=(0, 0, None))

    def maps(grid, mask):
        out = dict(nbr=[table(grid, mask, OFF3)], grid=[grid], mask=[mask], c2p=[],
                   clusters=[])
        for sizes in stages:
            grid, mask, c2p = jax.vmap(functools.partial(jvox.unique_parents, stride=2))(
                grid, mask)
            out["clusters"].append([jax.vmap(functools.partial(
                jvox.unique_parents, stride=s))(grid, mask)[2] for s in sizes])
            out["nbr"].append(table(grid, mask, OFF3))
            for key, value in (("grid", grid), ("mask", mask), ("c2p", c2p)):
                out[key].append(value)
        return out

    return jax.jit(maps)


def assert_maps_match_jax(batch):
    """The port's full-length maps (levels, parents, clusters, neighbour
    tables) equal the JAX functions' bit for bit; on a parity input this
    also asserts the JAX hash exact there (ROADMAP §3 item 13)."""
    model = port.OACNNs(**{k: v for k, v in BACKBONE.items() if k != "type"})
    model.compact_levels = False
    got = model.index_maps(*tt(batch["grid_coord"], batch["mask"]))
    got["nbr"] = [voxel.neighbor_table(g, m, OFF3) for g, m in zip(got["grid"], got["mask"])]
    ref = _jax_maps_fn(BACKBONE["point_grid_size"])(batch["grid_coord"], batch["mask"])
    for key in ("nbr", "grid", "mask", "c2p"):
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    for a, b in zip(got["clusters"], ref["clusters"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg="clusters")


# -- segment reductions and the adaptive block ---------------------------------------


def test_segment_mean_and_sum_match_jax():
    """``segment_mean`` / ``segment_sum`` against the JAX ``_segment_mean`` /
    ``_segment_sum``: invalid rows left out, an empty segment 0, rtol 1e-6."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((300, 5)).astype(np.float32)
    seg = rng.randint(0, 40, 300)
    seg[seg == 7] = 8                                 # segment 7 empty
    valid = rng.rand(300) < 0.8
    for jfn, fn in ((joa._segment_mean, port.segment_mean),
                    (joa._segment_sum, port.segment_sum)):
        ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(seg), jnp.asarray(valid), 300))
        got = fn(*tt(x, seg, valid), 300).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        assert (got[7] == 0).all() and (got[40:] == 0).all()


def block_level(seed, counts, n, constant=False):
    """A level of two samples (``counts`` voxels of a 12 x 12 x 3 volume,
    padded to ``n``), its clusters at ``SIZES`` and features; with
    ``constant`` each feature is constant over a 6-cell (so over every
    cluster of either size)."""
    rng = np.random.RandomState(seed)
    cells = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(3), indexing="ij"),
                     -1).reshape(-1, 3).astype(np.int32)
    grid = np.zeros((2, n, 3), np.int32)
    for i, c in enumerate(counts):
        grid[i, :c] = cells[rng.choice(len(cells), c, replace=False)]
    mask = np.arange(n)[None, :] < np.array(counts)[:, None]
    if constant:
        coarse = grid // 6
        table = rng.standard_normal((2, 2, 2, 1, 8)).astype(np.float32)
        feat = table[np.arange(2)[:, None], coarse[..., 0], coarse[..., 1], coarse[..., 2]]
    else:
        feat = rng.standard_normal((2, n, 8)).astype(np.float32)
    feat = (feat * mask[..., None]).reshape(2 * n, 8)
    return grid, mask, feat


def port_level(grid, mask):
    level = port.Level(*tt(grid, mask))
    level.clusters = [(voxel.flatten_slot_map(c).clamp(min=0).long(), c.reshape(-1) >= 0)
                      for c in (voxel.unique_parents(*tt(grid, mask), s)[2] for s in SIZES)]
    return level


def jax_block_args(grid, mask):
    """The JAX block's neighbour table and clusters (asserted equal to the
    port's exact ones) and flat mask."""
    nbr = jvox.flatten_neighbor_rows(jax.vmap(
        lambda g, m: jvox.neighbor_table(g, m, OFF3))(grid, mask))
    exact = voxel.flatten_neighbor_rows(voxel.neighbor_table(*tt(grid, mask), OFF3))
    np.testing.assert_array_equal(exact.numpy(), np.asarray(nbr))
    clusters = []
    for s in SIZES:
        cc = jvox.flatten_slot_map(jax.vmap(lambda g, m: jvox.unique_parents(g, m, s))(
            grid, mask)[2])
        clusters.append((jnp.maximum(cc, 0), cc >= 0))
    return nbr, clusters, mask.reshape(-1)


_BLOCK = {}


def block_fns():
    """The JAX ``AdaptiveBlock`` (width 8, two scales) compiled once for eval
    and once for the training forward with the gradients of sum(out g)."""
    if not _BLOCK:
        jmod = joa.AdaptiveBlock(8, len(SIZES))

        def train_loss(params, stats, x, nbr, seg, valid, mask, g):
            out, new = jmod.apply({"params": params, "batch_stats": stats}, x, nbr,
                                  list(zip(seg, valid)), mask, True, mutable=["batch_stats"])
            return jnp.sum(out * g), (out, new["batch_stats"])

        _BLOCK.update(module=jmod, eval=jax.jit(
            lambda v, x, nbr, seg, valid, mask: jmod.apply(v, x, nbr, list(zip(seg, valid)),
                                                           mask, False)),
                      train=jax.jit(jax.value_and_grad(train_loss, argnums=(0, 2),
                                                       has_aux=True)))
    return _BLOCK


def block_weights(grid, mask, feat, seed):
    """The JAX block's variables (kernels of unit gain, BatchNorms
    randomised) and the port's block on them."""
    rng = np.random.RandomState(seed)
    nbr, clusters, flat_mask = jax_block_args(grid, mask)
    shapes = jax.eval_shape(lambda: block_fns()["module"].init(
        {"params": jax.random.PRNGKey(0)}, feat, nbr, clusters, flat_mask, False))
    v = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), dict(shapes))
    for path, a in flatten_tree(v["params"]).items():
        if path.endswith("kernel"):
            fan_in = int(np.prod(a.shape[:-1]))
            node = v["params"]
            for part in path.split("/")[:-1]:
                node = node[part]
            node["kernel"] = (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
    randomise_bn(v, rng)
    block = port.AdaptiveBlock(8, len(SIZES), _bn_factory())
    load_block(block, v)
    return v, block


def load_block(block, v):
    sd = jax_to_state_dict({coll: {"backbone_module": {"enc0_block0": v[coll]}}
                            for coll in ("params", "batch_stats")})
    prefix = "backbone.enc.0.blocks.0."
    block.load_state_dict({k[len(prefix):]: t for k, t in sd.items()}, strict=True)


def padded_vector_sets_max(v, block, level, feat, training):
    """Scale each scale's ``weight{i}`` so that the padded rows' vector
    (W (mlp(0) - mean of cluster 0)) peaks at 30 over its channels, far
    above the valid rows' (0, their features constant over each cluster):
    the adaptive softmax's maximum is then the padded rows'."""
    probe = copy.deepcopy(block).train(training)
    x = torch.from_numpy(feat)
    with torch.no_grad():
        for i, (seg, valid) in enumerate(level.clusters):
            pw = port._run_mlp(probe.l_w[i], x, level.flat_mask)
            mean0 = port.segment_mean(pw, seg, valid, x.shape[0])[0]
            pad = pw[~level.flat_mask][0]      # a padded row: zero features
            u = (pad - mean0) @ block.weight[i].weight.t()
            scale = 30.0 / (u.max() if u.max() > 0 else u.min())
            v["params"][f"weight{i}"]["kernel"] *= float(scale)
    load_block(block, v)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", ["random", "padded-max"])
def test_adaptive_block_matches_jax(case, training):
    """``AdaptiveBlock`` (two scales, width 8) on a level of 96 and 80
    voxels padded to 128 rows (the JAX layout), against the JAX module on
    its weights: the output rtol 1e-4 / atol 1e-5, padded rows 0; in
    training mode the gradients of the input and of every parameter and
    the running statistics too.  In "padded-max" the padded rows' vector
    sets the adaptive softmax's maximum (30 above the valid rows')."""
    grid, mask, feat = block_level(1, (96, 80), 128, constant=case == "padded-max")
    v, block = block_weights(grid, mask, feat, 2)
    level = port_level(grid, mask)
    if case == "padded-max":
        padded_vector_sets_max(v, block, level, feat, training)
    nbr, clusters, flat_mask = jax_block_args(grid, mask)
    seg, valid = zip(*clusters)
    g = np.random.RandomState(3).standard_normal(feat.shape).astype(np.float32)
    fns = block_fns()
    x = torch.from_numpy(feat).requires_grad_(training)
    out = block.train(training)(x, level)
    if not training:
        ref = np.asarray(fns["eval"](v, feat, nbr, seg, valid, flat_mask))
    else:
        (_, (ref, stats)), (ref_gp, ref_gx) = fns["train"](
            v["params"], v["batch_stats"], feat, nbr, seg, valid, flat_mask, g)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert (out[~level.flat_mask] == 0).all()
    if not training:
        return
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=RTOL, atol=ATOL)
    grads = jax_to_block_tree({k: p.grad for k, p in block.named_parameters()})["params"]
    for path, r in flatten_tree(jax.tree_util.tree_map(np.asarray, ref_gp)).items():
        got = flatten_tree(grads)[path]
        np.testing.assert_allclose(got, r, rtol=RTOL, atol=1e-4 * max(np.abs(r).max(), 1.0),
                                   err_msg=path)
    got = flatten_tree(jax_to_block_tree(block.state_dict())["batch_stats"])
    for path, r in flatten_tree(jax.tree_util.tree_map(np.asarray, stats)).items():
        np.testing.assert_allclose(got[path], r, rtol=1e-5, atol=1e-6, err_msg=path)


def jax_to_block_tree(tensors):
    """A port block's tensors as the JAX block's tree."""
    tree = state_dict_to_jax({f"backbone.enc.0.blocks.0.{k}": t for k, t in tensors.items()})
    return {coll: tree[coll].get("backbone_module", {}).get("enc0_block0", {})
            for coll in tree}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_block_needs_the_padded_row(training):
    """Two samples of 96 voxels each: the JAX level holds 128 rows a sample
    and so padded rows; where their vector sets the adaptive softmax's
    maximum, a level held at 96 rows (none padded) computes another
    function (the valid rows' own maximum: O(1) apart), and one padded row
    more a sample (the port's compacted length, ``OACNNs.index_maps``)
    computes the JAX module's (rtol 1e-4 / atol 1e-5)."""
    grid, mask, feat = block_level(4, (96, 96), 128, constant=True)
    v, block = block_weights(grid, mask, feat, 5)
    padded_vector_sets_max(v, block, port_level(grid, mask), feat, training)
    nbr, clusters, flat_mask = jax_block_args(grid, mask)
    seg, valid = zip(*clusters)
    fns = block_fns()
    if training:
        g = np.zeros_like(feat)
        (_, (ref, _)), _ = fns["train"](v["params"], v["batch_stats"], feat, nbr, seg, valid,
                                        flat_mask, g)
    else:
        ref = fns["eval"](v, feat, nbr, seg, valid, flat_mask)
    ref = np.asarray(ref).reshape(2, 128, 8)[:, :96]
    outs = {}
    for rows in (96, 97):
        level = port_level(grid[:, :rows], mask[:, :rows])
        x = torch.from_numpy(feat.reshape(2, 128, 8)[:, :rows].reshape(-1, 8))
        with torch.no_grad():
            out = copy.deepcopy(block).train(training)(x, level)
        outs[rows] = out.numpy().reshape(2, rows, 8)[:, :96]
    np.testing.assert_allclose(outs[97], ref, rtol=RTOL, atol=ATOL)
    assert np.abs(outs[96] - ref).max() > 0.1


# -- the network ------------------------------------------------------------------------


_MODELS = {}


def models():
    """The small OA-CNNs segmentor in both packages on one set of weights
    (kernels of unit gain, BatchNorms randomised), built once."""
    if not _MODELS:
        tree = weights(SEGMENTOR, 10, backbone_only=False)
        model = build_model(dict(SEGMENTOR))
        model.load_state_dict(jax_to_state_dict(tree), strict=True)
        jmodel = jax_build_model(dict(SEGMENTOR))
        _MODELS.update(jmodel=jmodel, model=model, tree=tree,
                       eval=jax.jit(functools.partial(jmodel.apply, train=False)))
    return _MODELS


def test_eval_forward_matches_jax():
    """The small OA-CNNs through ``DefaultSegmentor`` in eval (stem, strided
    convs, adaptive blocks at two grid sizes, inverse convs and fuses,
    ``final``) on 2 x ~1,500 clustered voxels, the JAX tables asserted
    exact, its levels compacted: logits within 1e-4 x max |logit|, padded
    rows 0."""
    m = models()
    batch = scene(13)     # at seed 11 the JAX hash finds two voxels that are not there
    assert_maps_match_jax(batch)
    ref = np.asarray(m["eval"](m["tree"], {k: v for k, v in batch.items()
                                            if k != "segment"})["seg_logits"])
    with torch.inference_mode():
        got = m["model"].eval()(inputs(batch))["seg_logits"].numpy()
    assert got.shape == (2, 1536, 5)
    assert np.abs(ref).max() > 0.1
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    assert (got[~batch["mask"]] == 0).all()


@pytest.mark.parametrize("counts,n", [((1500, 1300), 1536), ((1400,), 1536)],
                         ids=["two-samples", "one-sample"])
def test_compacted_levels_equal_full_length(counts, n):
    """Levels held at the batch's largest voxel count (one row more where
    that leaves none padded: every level of the one-sample batch) compute
    what full-length levels (the JAX module's) compute on their valid rows:
    every level's voxels, masks, parent and cluster maps equal on the
    shorter length and padding past it, and the logits of a training
    forward (batch statistics) equal."""
    model = build_model(dict(SEGMENTOR))
    batch = inputs(scene(12, counts, n))
    backbone = model.backbone
    args = (batch["grid_coord"], batch["mask"])
    compact = backbone.index_maps(*args)
    backbone.compact_levels = False
    full = backbone.index_maps(*args)
    held = [m.shape[1] for m in compact["mask"][1:]]
    most = [int(m.sum(1).max()) for m in compact["mask"][1:]]
    assert all(h < n for h in held)
    if len(counts) == 1:
        assert held == [m + 1 for m in most]
    for key in ("grid", "mask"):
        for a, b in zip(compact[key], full[key]):
            torch.testing.assert_close(a, b[:, :a.shape[1]], rtol=0, atol=0)
            assert key != "mask" or not b[:, a.shape[1]:].any()
    for a, b in zip(compact["c2p"], full["c2p"]):
        torch.testing.assert_close(a, b[:, :a.shape[1]], rtol=0, atol=0)
        assert (b[:, a.shape[1]:] == -1).all()
    for a, b in zip(compact["clusters"], full["clusters"]):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y[:, :x.shape[1]], rtol=0, atol=0)
            assert (y[:, x.shape[1]:] == -1).all()
    ref = model.train()(batch)["seg_logits"]
    backbone.compact_levels = True
    got = model(batch)["seg_logits"]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_default_trainer_step_matches_jax(tmp_path):
    """One ``DefaultTrainer`` step through both packages of the shipped
    ScanNet OA-CNNs config at the reduced width (AdamW at lr 1e-3, weight
    decay 0.02, OneCycleLR; CE + Lovasz), f32 without autocast, Mix3D off:
    the training-mode forward's loss rtol 1e-4, its gradient as
    ``assert_gradient_triple`` holds it, the running statistics rtol 1e-5 /
    atol 1e-5, the parameters after the step within 1e-4 of max(1, max
    |value|) where the gradient is clear of f32 noise.

    The config's AdamW dict keeps the SGD base's ``momentum`` and
    ``nesterov`` and its OneCycleLR dict the PolyLR base's ``power``: the
    port drops them with a warning; the JAX trainer raises on the first
    (ROADMAP §3 item 7), so its step gets the optimizer without them."""
    shipped = Config.fromfile(SHIPPED)
    model = dict(shipped.model)
    model["backbone"] = dict(model["backbone"], **{k: v for k, v in BACKBONE.items()
                                                   if k != "type"})
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=model,
               optimizer=dict(shipped.optimizer), scheduler=dict(shipped.scheduler),
               data=dict(CFG["data"], num_classes=5))
    assert cfg["optimizer"]["momentum"] == 0.9 and cfg["scheduler"]["power"] == 0.9
    with pytest.raises(TypeError, match="momentum"):
        jax_build_optimizer(dict(cfg["optimizer"]), {"w": jnp.zeros(2)})
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(copy.deepcopy(cfg))))
    cfg["optimizer"] = {k: v for k, v in cfg["optimizer"].items()
                        if k not in ("momentum", "nesterov")}
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    jtrainer.mesh = create_mesh(1)
    record_gradients(jtrainer)
    batch = scene(21)
    assert_maps_match_jax(batch)
    np_batch = dict(coord=batch["grid_coord"] * np.float32(0.02),
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
    assert trainer.comm_info["lr"] == pytest.approx(float(jtrainer.scheduler(0)), rel=1e-6)
    assert_gradient_triple(grads, recorded_gradients(jtrainer), truth, "OA-CNNs step")
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


# -- bridge and configs -----------------------------------------------------------------


def test_bridge_round_trip_bit_equal():
    """The port's tree has the JAX model's names and shapes (the stem's and
    the blocks' convs (27, C_in, C_out), the strided ones (8, C_in, C_out),
    a block's ``proj_last`` from ``proj.{S}``); the state_dict holds the
    reference's names; JAX tree -> state_dict -> JAX tree is bit-equal and
    loads with strict=True."""
    tree = weights(SEGMENTOR, 19, backbone_only=False)
    assert tree_shapes(tree) == jax_shapes(SEGMENTOR, scene(20, counts=(200, 150), n=256))
    model = build_model(dict(SEGMENTOR))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    sd = model.state_dict()
    assert sd["backbone.stem.3.weight"].shape == (27, 8, 8)
    assert sd["backbone.enc.1.down.0.weight"].shape == (8, 8, 16)
    assert sd["backbone.enc.1.blocks.0.voxel_block.3.weight"].shape == (27, 16, 16)
    assert sd["backbone.dec.0.fuse.0.weight"].shape == (8, 16)
    for key in ("backbone.stem.7.running_var", "backbone.enc.0.blocks.0.l_w.1.1.running_mean",
                "backbone.enc.0.blocks.0.weight.1.weight",
                "backbone.enc.0.blocks.0.proj.2.0.weight",
                "backbone.enc.1.blocks.0.adaptive.weight", "backbone.enc.1.blocks.0.fuse.1.bias",
                "backbone.dec.1.up.1.weight", "backbone.dec.1.fuse.4.running_mean",
                "backbone.final.bias"):
        assert key in sd, key
    back = state_dict_to_jax(sd)
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert a.keys() == b.keys()
        assert "backbone_module/enc0_block0/proj_last_fc/kernel" in flatten_tree(
            back["params"])
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_shipped_config_builds():
    """The shipped ScanNet OA-CNNs config builds at full width (on the meta
    device; the keys ``groups``, ``enc_num_ref``, ``dec_depth`` and
    ``down_ratio`` accepted and unread), every parameter and statistic's
    shape, named through the bridge, equal to the JAX init tree's (traced
    by ``jax.eval_shape``, not compiled)."""
    cfg = Config.fromfile(SHIPPED)
    assert cfg.model.backbone.type == "OACNNs" and cfg.model.backbone.dec_depth == [2, 2, 2, 2]
    with torch.device("meta"):
        model = build_model(dict(cfg.model))
    n_params = sum(p.numel() for p in model.parameters())
    want = {coll: {f"backbone_module/{k}": v for k, v in shapes.items()}
            for coll, shapes in jax_shapes(dict(cfg.model.backbone), scene(
                20, counts=(200, 150), n=256)).items()}
    got = tree_shapes(state_dict_to_jax(
        {k: torch.empty(v.shape, dtype=v.dtype) for k, v in model.state_dict().items()}))
    assert got == want
    assert n_params == sum(int(np.prod(s)) for s in want["params"].values())
