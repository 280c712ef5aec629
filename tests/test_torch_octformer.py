"""The port's OctFormer-v1m1 against the JAX package on the CPU: the z-order
sort, the RPE's indices and bias at dilations 1 and 2, dilated patch
attention (values and gradients), the depthwise CPE conv, the whole small
OctFormer through ``DefaultSegmentor`` in eval, one ``DefaultTrainer``
AdamW step (its training-mode forward and gradient), compacted levels
against full-length ones, the bridge and the shipped ScanNet config's
shapes.

Reductions from the shipped ScanNet OctFormer config (stages of widths 96 to
384 with 2 / 2 / 18 / 2 blocks, patches of 26, dilation 4, FPN 168, 1 cm
voxels, 120,000-point crops, batch 12): widths (8, 8, 16, 16), blocks (2, 1,
1, 1), two heads, patches of 8, dilation 2, FPN 8; two samples of 500 and
430 voxels of a 24 x 24 x 4 volume padded to 512.

Tolerances: sorts and indices bit-equal; a module rtol 1e-4 / atol 1e-5; a
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
from pointcloudpdf_tpu.models.octformer import octformer as joct
from pointcloudpdf_tpu.ops import voxel as jvox
from pointcloudpdf_tpu.parallel.mesh import create_mesh
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.norm import _bn_factory
from pointcloudpdf_tpu_torch.models.octformer import octformer as port
from pointcloudpdf_tpu_torch.ops import voxel
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_cac_losses import assert_gradient_triple, float64_gradients
from test_torch_ptv3 import assert_logits_close, inputs, tree_shapes
from test_torch_st import japply, jinit, tt
from test_torch_swin3d import copy_linear, jax_shapes, jax_value_and_grads, random_params
from test_torch_swin3d import weights
from test_torch_train import CFG, port_gradients, record_gradients, recorded_gradients

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
BACKBONE = dict(type="OctFormer-v1m1", in_channels=6, num_classes=5, fpn_channels=8,
                channels=(8, 8, 16, 16), num_blocks=(2, 1, 1, 1), num_heads=(2, 2, 2, 2),
                patch_size=8, dilation=2, stem_down=2, head_up=2, drop_path=0.0)
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
SEGMENTOR = dict(type="DefaultSegmentor", backbone=BACKBONE, criteria=CRITERIA)


def scene(seed, counts=(500, 430), n=512, channels=6, classes=5, extent=(24, 24, 4)):
    """A padded batch of voxel sets drawn from a small volume, features and
    labels."""
    rng = np.random.RandomState(seed)
    cells = np.stack(np.meshgrid(*[np.arange(e) for e in extent], indexing="ij"), -1)
    cells = cells.reshape(-1, 3).astype(np.int32)
    grid = np.zeros((len(counts), n, 3), np.int32)
    for i, c in enumerate(counts):
        grid[i, :c] = cells[rng.choice(len(cells), c, replace=False)]
    mask = np.arange(n)[None, :] < np.array(counts)[:, None]
    feat = (rng.rand(len(counts), n, channels) * mask[..., None]).astype(np.float32)
    segment = np.where(mask, rng.randint(0, classes, mask.shape), -1).astype(np.int64)
    return dict(grid_coord=grid, feat=feat, mask=mask, segment=segment)


def models(cfg, seed):
    tree = weights(cfg, seed)
    model = build_model(dict(cfg))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    return jax_build_model(dict(cfg)), model, tree


def level_case(seed, n=96, counts=(96, 61)):
    """A level of two samples, the second partly padded."""
    rng = np.random.RandomState(seed)
    batch = scene(seed, counts=counts, n=n, extent=(8, 8, 4))
    return rng, batch["grid_coord"], batch["mask"]


def test_z_sort_matches_jax():
    """The level's z-order sort and its inverse bit-equal to the JAX
    ``_z_sort`` (valid first; codes clip past 1023, so they tie)."""
    rng, grid, mask = level_case(1)
    grid[:, :20] += 1020
    level = port.OctreeLevel(*tt(grid, mask), 8)
    order, inverse = jax.jit(joct._z_sort)(grid, mask)
    b, n = mask.shape
    base = np.arange(b)[:, None] * n
    np.testing.assert_array_equal(level.order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(level.inverse_rows.numpy().reshape(b, n) - base,
                                  np.asarray(inverse))


@pytest.mark.parametrize("dilation,bound", [(1, 6), (2, 9)])
def test_rpe_index_and_bias_match_jax(dilation, bound):
    """``OctreeRPE`` at patches of 8: the clip int(0.8 K sqrt(D)) (6 at D = 1,
    9 at D = 2; 20 and 41 at the config's K = 26, D = 1 and 4); each valid
    pair's index the JAX module's per-axis rows (x, y, z) and its bias
    equal to JAX's (rtol 1e-6) over the dilated patches of the sorted level;
    the table of every offset triple (571,787 rows at the config's D = 4)."""
    rng, grid, mask = level_case(2)
    grid = grid * 3          # offsets past the clip
    assert port.octree_rpe_bound(8, dilation) == bound
    assert port.octree_rpe_bound(26, 1) == 20 and port.octree_rpe_bound(26, 4) == 41
    level = port.OctreeLevel(*tt(grid, mask), 8)
    index = level.rpe_index(dilation)
    g = level.patches(torch.from_numpy(grid).gather(
        1, level.order[..., None].expand(-1, -1, 3)), dilation).numpy()
    valid = level.patches(torch.from_numpy(mask).gather(1, level.order), dilation).numpy()
    rel = np.clip(g[:, :, :, None] - g[:, :, None, :], -bound, bound) + bound
    span = 2 * bound + 1
    pairs = valid[..., :, None] & valid[..., None, :]
    want = (rel[..., 0] * span + rel[..., 1]) * span + rel[..., 2]
    np.testing.assert_array_equal(index.numpy()[pairs], want[pairs])
    jmod = joct.OctreeRPE(8, 2, dilation)
    v = random_params(jinit(jmod, jnp.asarray(g[:, :, :, None] - g[:, :, None, :])), rng)
    ref = np.asarray(japply(jmod, v, g[:, :, :, None] - g[:, :, None, :]))
    rpe = port.RPE(bound, 2)
    with torch.no_grad():
        rpe.rpe_table.copy_(torch.from_numpy(np.asarray(v["params"]["rpe_table"])))
        got = rpe(index).numpy()
    np.testing.assert_allclose(got.transpose(0, 1, 3, 4, 2)[pairs],
                               ref.transpose(0, 1, 3, 4, 2)[pairs], rtol=1e-6, atol=1e-7)
    assert rpe.rpe_num == span and int(index.max()) < span ** 3


@pytest.mark.parametrize("dilation", [1, 2])
def test_octree_attention_matches_jax(dilation):
    """``OctreeAttention`` at N = 96 (patches of 8: a block of 16 at D = 2),
    a partly padded sample, against JAX's on its weights: the output rtol
    1e-4 / atol 1e-5, padded rows 0; the gradients of the input, qkv, proj
    and the RPE table at the same tolerances."""
    rng, grid, mask = level_case(3)
    feat = rng.standard_normal((2, 96, 16)).astype(np.float32)
    g = rng.standard_normal((2, 96, 16)).astype(np.float32)
    order, inverse = joct._z_sort(jnp.asarray(grid), jnp.asarray(mask))
    jmod = joct.OctreeAttention(16, 8, 2, dilation)
    args = (grid, order, inverse, mask, False)
    v = random_params(jinit(jmod, feat, *args), rng)
    ref, (ref_gp, ref_gx) = jax_value_and_grads(jmod, v["params"], feat, args, g)
    mod = port.OctreeAttention(16, 8, 2, dilation)
    p = v["params"]
    copy_linear(mod.qkv, p["qkv"])
    copy_linear(mod.proj, p["proj"])
    with torch.no_grad():
        mod.rpe.rpe_table.copy_(torch.from_numpy(np.asarray(p["rpe"]["rpe_table"])))
    level = port.OctreeLevel(*tt(grid, mask), 8)
    x = torch.from_numpy(feat).requires_grad_(True)
    out = mod(x, level)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    assert (out[~torch.from_numpy(mask)] == 0).all()
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=RTOL, atol=ATOL)
    for name in ("qkv", "proj"):
        np.testing.assert_allclose(getattr(mod, name).weight.grad.numpy().T,
                                   np.asarray(ref_gp[name]["kernel"]), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(mod.rpe.rpe_table.grad.numpy(),
                               np.asarray(ref_gp["rpe"]["rpe_table"]), rtol=RTOL, atol=ATOL)


def test_dwconv_matches_jax():
    """The CPE (depthwise 3^3 conv over the compacted rulebook, BatchNorm)
    in training mode against JAX's ``OctreeDWConv`` (its 27 dense gathers)
    on its weights: the output and the gradients of the input, kernel and
    BatchNorm rtol 1e-4 / atol 1e-5; the running statistics rtol 1e-5."""
    rng, grid, mask = level_case(4)
    feat = rng.standard_normal((2 * 96, 16)).astype(np.float32)
    g = rng.standard_normal((2 * 96, 16)).astype(np.float32)
    nbr = jvox.flatten_neighbor_rows(jax.vmap(
        lambda gg, mm: jvox.neighbor_table(gg, mm, jvox.kernel_offsets(3)))(grid, mask))
    flat_mask = mask.reshape(-1)
    jmod = joct.OctreeDWConv(16)
    v = jinit(jmod, feat, nbr, flat_mask, train=False)
    v = dict(v, params=random_params(v["params"], rng))

    def jloss(p, x):
        out, stats = jmod.apply({"params": p, "batch_stats": v["batch_stats"]}, x, nbr,
                                flat_mask, True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, stats)

    (_, (ref, stats)), (ref_gp, ref_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(v["params"], feat)
    level = port.OctreeLevel(*tt(grid, mask), 8)
    np.testing.assert_array_equal(voxel.flatten_neighbor_rows(voxel.neighbor_table(
        *tt(grid, mask), voxel.kernel_offsets(3))).numpy(), np.asarray(nbr))
    mod = port.OctreeDWConvBn(16, _bn_factory()).train()
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"])))
        mod.bn.weight.copy_(torch.from_numpy(np.asarray(v["params"]["bn"]["scale"])))
        mod.bn.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bn"]["bias"])))
    x = torch.from_numpy(feat).requires_grad_(True)
    out = mod(x, level)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mod.bn.running_var.numpy(),
                               np.asarray(stats["batch_stats"]["bn"]["var"]), rtol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mod.conv.weight.grad.numpy(), np.asarray(ref_gp["kernel"]),
                               rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(mod.bn.weight.grad.numpy(),
                               np.asarray(ref_gp["bn"]["scale"]), rtol=RTOL, atol=1e-4)


# -- the network ------------------------------------------------------------------------


def test_eval_forward_matches_jax():
    """The small OctFormer through ``DefaultSegmentor`` in eval (stem convs
    and strided convs, dilated and dense blocks, the FPN, ``head_up``
    deconvs, the seg head) against the JAX module: logits within 1e-4 x max
    |logit|, padded rows 0."""
    jmodel, model, tree = models(SEGMENTOR, 10)
    batch = scene(11)
    ref = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        tree, {k: v for k, v in batch.items() if k != "segment"})["seg_logits"])
    with torch.inference_mode():
        got = model.eval()(inputs(batch))["seg_logits"].numpy()
    assert got.shape == (2, 512, 5)
    assert_logits_close(got, ref, batch["mask"])
    assert (got[~batch["mask"]] == 0).all()


def test_compacted_levels_equal_full_length():
    """Levels held at the batch's largest voxel count rounded up to a block
    of K D compute what full-length levels (the JAX module's) compute on
    their valid rows: every level's voxels, masks and child -> parent maps
    equal on the shorter length and padding past it, and the logits of a
    training forward (batch statistics) equal."""
    model = build_model(dict(SEGMENTOR))
    batch = inputs(scene(12))
    backbone = model.backbone
    args = (batch["grid_coord"], batch["mask"])
    compact = backbone.index_maps(*args)
    backbone.compact_levels = False
    full = backbone.index_maps(*args)
    sizes = [m.shape[1] for m in compact["mask"]]
    assert sizes[0] == 512 and all(s % 16 == 0 and s < 512 for s in sizes[1:])
    for key in ("grid", "mask"):
        for a, b in zip(compact[key], full[key]):
            torch.testing.assert_close(a, b[:, :a.shape[1]], rtol=0, atol=0)
            assert key != "mask" or not b[:, a.shape[1]:].any()
    for a, b in zip(compact["c2p"], full["c2p"]):
        torch.testing.assert_close(a, b[:, :a.shape[1]], rtol=0, atol=0)
        assert (b[:, a.shape[1]:] == -1).all()
    ref = model.train()(batch)["seg_logits"]
    backbone.compact_levels = True
    got = model(batch)["seg_logits"]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_default_trainer_step_matches_jax(tmp_path):
    """One ``DefaultTrainer`` step through both packages of the shipped
    ScanNet OctFormer config at the reduced width (AdamW, MultiStepLR, no
    param groups), f32 without autocast, Mix3D off and drop path 0: the
    training-mode forward's loss rtol 1e-4, its gradient as
    ``assert_gradient_triple`` holds it, the running statistics rtol 1e-5 /
    atol 1e-5, the parameters after the step within 1e-4 of max(1, max
    |value|) where the gradient is clear of f32 noise.

    The config's schedule keeps the PT-v3 base's ``OneCycleLR`` keys under
    ``type="MultiStepLR"``: the JAX trainer cannot build it (``TypeError``,
    ROADMAP §3), the port's drops them with a warning.  The JAX step gets
    the schedule without them."""
    shipped = Config.fromfile(os.path.join(ROOT, "configs", "scannet",
                                           "semseg-octformer-v1m1-0-base.py"))
    model = dict(shipped.model)
    model["backbone"] = dict(model["backbone"], **{k: v for k, v in BACKBONE.items()
                                                   if k != "type"})
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=model,
               optimizer=dict(shipped.optimizer), scheduler=dict(shipped.scheduler),
               data=dict(CFG["data"], num_classes=5))
    assert shipped.param_dicts is None and "max_lr" in cfg["scheduler"]
    with pytest.raises(TypeError, match="max_lr"):
        JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(copy.deepcopy(cfg))))
    cfg["scheduler"] = {k: cfg["scheduler"][k] for k in ("type", "milestones", "gamma")}
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    jtrainer.mesh = create_mesh(1)
    record_gradients(jtrainer)
    batch = scene(21)
    np_batch = dict(coord=batch["grid_coord"] * np.float32(0.01),
                    grid_coord=batch["grid_coord"], feat=batch["feat"],
                    segment=batch["segment"], count=batch["mask"].sum(1).astype(np.int32))
    start = weights(model, 22)
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
    assert_gradient_triple(grads, recorded_gradients(jtrainer), truth, "OctFormer step")
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
    """The port's tree has the JAX model's names and shapes (the CPE kernels
    (27, C), the RPE tables (3 rpe_num, H), the convs (K, C_in, C_out)); the
    state_dict holds the reference's names; JAX tree -> state_dict -> JAX
    tree is bit-equal and loads with strict=True."""
    tree = weights(SEGMENTOR, 19)
    assert tree_shapes(tree) == jax_shapes(SEGMENTOR, scene(20, counts=(60, 50), n=64))
    model = build_model(dict(SEGMENTOR))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    sd = model.state_dict()
    assert sd["backbone.layers.0.blocks.0.cpe.conv.weight"].shape == (27, 8)
    assert sd["backbone.layers.0.blocks.1.attention.rpe.rpe_table"].shape == (3 * 19, 2)
    assert sd["backbone.patch_embed.downsamples.1.conv.weight"].shape == (8, 4, 8)
    for key in ("backbone.patch_embed.convs.0.bn.running_mean", "backbone.patch_embed.proj.bn.bias",
                "backbone.downsamples.2.norm.running_var", "backbone.decoder.conv1x1.3.weight",
                "backbone.decoder.conv3x3.0.conv.weight", "backbone.decoder.up_conv.1.deconv.weight",
                "backbone.decoder.up_conv.0.bn.weight", "backbone.seg_head.1.running_mean",
                "backbone.layers.3.blocks.0.mlp.fc2.bias", "backbone.layers.1.blocks.0.norm2.bias"):
        assert key in sd, key
    back = state_dict_to_jax(sd)
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_shipped_config_builds():
    """The shipped ScanNet OctFormer config builds at full width (millions of
    parameters as stated, on the meta device), every parameter and
    statistic's shape, named through the bridge, equal to the JAX init
    tree's (traced by ``jax.eval_shape``, not compiled); ``head_up`` must
    bring the features back to the input's level."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "scannet",
                                       "semseg-octformer-v1m1-0-base.py"))
    with torch.device("meta"):
        model = build_model(dict(cfg.model))
    assert sum(p.numel() for p in model.parameters()) / 1e6 == pytest.approx(42.93, abs=0.01)
    want = {coll: {f"backbone_module/{k}": v for k, v in shapes.items()}
            for coll, shapes in jax_shapes(dict(cfg.model.backbone), scene(
                20, counts=(200, 150), n=208, channels=10)).items()}
    assert tree_shapes(state_dict_to_jax(
        {k: torch.empty(v.shape, dtype=v.dtype) for k, v in model.state_dict().items()})) == want
    with pytest.raises(ValueError, match="head_up"):
        build_model(dict(BACKBONE, head_up=1))
