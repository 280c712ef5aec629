"""The port's instance segmentation against the JAX package on the CPU: the
host clustering (``bfs_cluster``: the same clusters in the same order), the
PointGroup forward over a small SpUNet in eval and training mode (logits,
shifts, the four loss parts, the gradient), ``propose`` on the same
outputs, ``InsSegEvaluator`` end to end on fixed outputs against the JAX
hook, one ``DefaultTrainer`` step of the shipped S3DIS config, the ``bbox``
collation, PointGroup over the PPT fine-tune backbone under its condition,
the bridge both ways, the eight shipped insseg configs, and the synthetic
rooms of ``chip_smoke.py`` (unchanged, with instance ids).

Reductions from the shipped S3DIS PointGroup config (SpUNet-v1m1 of
channels (32, 64, 128, 256, 256, 128, 96, 96), layers (2, 3, 4, 6, 2, 2, 2,
2), 4 cm voxels, 100,000-point crops, batch 12): a one-stage SpUNet of
channels (8, 8), one block each, base 8; two samples of 2,000 and 1,700
voxels of a room's surfaces padded to 2,048.  The JAX ``propose`` and
``_class_ap`` are host numpy and are called as they are; the JAX model
compiles once for its eval forward and once for its training forward with
the gradient, the JAX trainer once.

Tolerances: clusters, proposals and AP bit-equal; a forward's outputs and
loss parts rtol 1e-4 / atol 1e-5; whole-network gradients as
``test_torch_cac_losses.assert_gradient_triple`` holds them.
"""

import copy
import functools
import hashlib
import os
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.datasets.utils import padded_collate_fn as jax_collate
from pointcloudpdf_tpu.engines.hooks.evaluator import InsSegEvaluator as JaxInsSegEvaluator
from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.ops.cluster import bfs_cluster as jax_bfs_cluster
from pointcloudpdf_tpu.parallel.mesh import create_mesh
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.datasets.transform import Compose, InstanceParser
from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn
from pointcloudpdf_tpu_torch.engines.hooks.evaluator import (AP_OVERLAPS, InsSegEvaluator,
                                                             ap_summary)
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.ops.cluster import bfs_cluster
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config
from pointcloudpdf_tpu_torch.utils.optimizer import build_optimizer
from pointcloudpdf_tpu_torch.utils.scheduler import build_scheduler

from test_torch_cac_losses import assert_gradient_triple, float64_gradients, grad_tree
from test_torch_ppt import assert_spunet_maps_exact, weights
from test_torch_ptv3 import tree_shapes
from test_torch_spunet import room_cells
from test_torch_train import CFG, port_gradients, record_gradients, recorded_gradients

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (its synthetic rooms)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
VOXEL = 0.04
S3DIS_PG = os.path.join(ROOT, "configs", "s3dis", "insseg-pointgroup-v1m1-0-spunet-base.py")
SPUNET = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
              channels=(8, 8), layers=(1, 1))
PG = dict(type="PG-v1m1", backbone=SPUNET, backbone_out_channels=8, semantic_num_classes=13,
          segment_ignore_index=(-1,), voxel_size=VOXEL, cluster_propose_points=20,
          cluster_min_points=10)
PD_CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")
PG_PPT = dict(PG, backbone=dict(
    type="PPT-v1m1", backbone=dict(SPUNET, type="SpUNet-v1m3", conditions=PD_CONDITIONS,
                                   context_channels=16, zero_init=False, norm_decouple=True,
                                   norm_adaptive=True, norm_affine=True),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
    backbone_out_channels=8, context_channels=16,
    conditions=("Structured3D", "ScanNet", "S3DIS"), backbone_mode=True))
INSSEG_CONFIGS = [
    "s3dis/insseg-pointgroup-v1m1-0-spunet-base.py",
    "s3dis/insseg-pointgroup-v1m1-0-spunet-base-vs0p02.py",
    "s3dis/insseg-pointgroup-v1m1-0-spunet-base-vs0p02-sc-aug.py",
    "s3dis/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py",
    "s3dis/insseg-ppt-v1m1-0-pointgroup-spunet-ft-vs0p05.py",
    "scannet/insseg-pointgroup-v1m1-0-spunet-base.py",
    "scannet/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py",
    "scannet200/insseg-pointgroup-spunet-0-base.py",
]


def instance_scene(seed, counts=(2000, 1700), n=2048):
    """A padded batch of voxels on a room's surfaces with coordinates,
    features, labels and instances (an instance a 10-voxel block of the
    room, a few points of none), as the S3DIS config's InstanceParser
    leaves them: ``instance_centroid`` each instance's mean coordinate."""
    rng = np.random.RandomState(seed)
    b = len(counts)
    grid = np.zeros((b, n, 3), np.int32)
    for i, c in enumerate(counts):
        grid[i, :c] = room_cells(rng, c)
    mask = np.arange(n)[None, :] < np.array(counts)[:, None]
    coord = ((grid + rng.rand(b, n, 3)) * VOXEL).astype(np.float32) * mask[..., None]
    block = grid // 10
    instance = np.where(mask, (block[..., 0] * 7 + block[..., 1]) * 5 + block[..., 2], -1)
    instance[mask & (rng.rand(b, n) < 0.05)] = -1
    segment = np.where(mask, (instance * 3) % 13, -1).astype(np.int64)
    centroid = np.zeros((b, n, 3), np.float32)
    for i in range(b):
        for iid in np.unique(instance[i][instance[i] >= 0]):
            sel = instance[i] == iid
            centroid[i][sel] = coord[i][sel].mean(0)
    feat = (rng.rand(b, n, 6) * mask[..., None]).astype(np.float32)
    return dict(coord=coord, grid_coord=grid, feat=feat, mask=mask, segment=segment,
                instance=instance.astype(np.int64), instance_centroid=centroid)


def tensors(batch):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


# -- clustering ---------------------------------------------------------------------------


def cluster_input(seed):
    """Shifted centres of three classes: tight blobs, loose blobs (chains
    that the radius links or not), and class 2's dense blob, whose pairs
    pass ``len(sel) * max_neighbors``."""
    rng = np.random.RandomState(seed)
    parts, labels = [], []
    for cls, spread, blobs in ((0, 0.3, 4), (1, 1.2, 3), (2, 0.05, 1)):
        for _ in range(blobs):
            m = rng.randint(40, 120)
            parts.append(rng.uniform(-20, 20, 3) + rng.normal(scale=spread, size=(m, 3)))
            labels.append(np.full(m, cls))
    order = rng.permutation(sum(len(p) for p in parts))
    return np.concatenate(parts)[order], np.concatenate(labels)[order]


@pytest.mark.parametrize("max_neighbors", [300, 5], ids=["full", "truncated"])
def test_bfs_cluster_matches_jax(max_neighbors):
    """``bfs_cluster`` against the JAX function: the same clusters (index
    arrays) in the same order, the union-find roots' (not each component's
    smallest member's); with ``max_neighbors`` 5 the dense class's pairs
    are cut at ``len(sel) * 5`` and its blob splits."""
    center, segment = cluster_input(0)
    sel = np.where(segment == 2)[0]
    from scipy.spatial import cKDTree
    pairs = cKDTree(center[sel]).query_pairs(1.5, output_type="ndarray")
    assert len(pairs) > len(sel) * 5
    got = bfs_cluster(center, segment, 1.5, max_neighbors, 10)
    ref = jax_bfs_cluster(center, segment, 1.5, max_neighbors, 10)
    assert len(got) == len(ref) >= 5
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert [c.min() for c in got] != sorted(c.min() for c in got)


# -- the model ----------------------------------------------------------------------------


_JAX = {}


def jax_fns(jmodel):
    """The JAX PointGroup's eval forward and its training forward with the
    loss's gradient, compiled once a model."""
    if id(jmodel) not in _JAX:
        def train(params, stats, batch):
            out, new = jmodel.apply({"params": params, "batch_stats": stats}, batch,
                                    train=True, mutable=["batch_stats"])
            return out["loss"], (out, new["batch_stats"])

        _JAX[id(jmodel)] = (jax.jit(functools.partial(jmodel.apply, train=False)),
                            jax.jit(jax.value_and_grad(train, has_aux=True)))
    return _JAX[id(jmodel)]


_MODELS = {}


def pg_models():
    """The small PointGroup in both packages on one set of weights."""
    if not _MODELS:
        tree = weights(PG, 40)
        model = build_model(dict(PG))
        model.load_state_dict(jax_to_state_dict(tree), strict=True)
        _MODELS.update(jmodel=jax_build_model(dict(PG)), model=model, tree=tree)
    return _MODELS


def assert_outputs_close(got, ref, keys):
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(ref[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


OUT_KEYS = ("seg_logits", "bias_pred", "loss", "seg_loss", "bias_l1_loss", "bias_cosine_loss")


def test_eval_forward_matches_jax():
    """PointGroup over the one-stage SpUNet in eval (the JAX tables asserted
    exact): ``seg_logits`` and ``bias_pred`` (zero on padded rows) and the
    four loss parts rtol 1e-4 / atol 1e-5."""
    m = pg_models()
    batch = instance_scene(41)
    assert_spunet_maps_exact(m["model"].backbone, batch)
    ref = jax_fns(m["jmodel"])[0](m["tree"], batch)
    with torch.inference_mode():
        got = m["model"].eval()(tensors(batch))
    assert_outputs_close({k: v.numpy() for k, v in got.items()}, ref, OUT_KEYS)
    for key in ("seg_logits", "bias_pred"):
        assert (got[key][~torch.from_numpy(batch["mask"])] == 0).all()


def test_train_forward_and_gradient_match_jax():
    """PointGroup in training mode (batch statistics): outputs and the four
    loss parts rtol 1e-4 / atol 1e-5, the running statistics rtol 1e-5, and
    the loss's gradient held with JAX's and the port's float64 gradient
    (``assert_gradient_triple``)."""
    m = pg_models()
    batch = instance_scene(42)
    assert_spunet_maps_exact(m["model"].backbone, batch)
    (_, (ref, stats)), jgrad = jax_fns(m["jmodel"])[1](m["tree"]["params"],
                                                        m["tree"]["batch_stats"], batch)
    model = copy.deepcopy(m["model"]).train()
    truth = float64_gradients(model, batch, lambda out, b: out["loss"])
    out = model(tensors(batch))
    out["loss"].backward()
    assert_outputs_close({k: v.detach().numpy() for k, v in out.items()}, ref, OUT_KEYS)
    got = flatten_tree(state_dict_to_jax(model.state_dict())["batch_stats"])
    for path, r in flatten_tree(jax.tree_util.tree_map(np.asarray, stats)).items():
        np.testing.assert_allclose(got[path], r, rtol=1e-5, atol=1e-6, err_msg=path)
    assert_gradient_triple(grad_tree(model), jgrad, truth, "PointGroup")


def fixed_outputs(batch, seed):
    """Outputs of a half-trained PointGroup, made by hand: logits near the
    labels' one-hot with noise, shifts to the instance centroids with noise
    (more on a few points), so that proposals overlap ground truth at every
    IoU."""
    rng = np.random.RandomState(seed)
    seg = np.clip(batch["segment"], 0, None)
    logits = 4.0 * np.eye(13, dtype=np.float32)[seg] + rng.normal(size=seg.shape + (13,))
    bias = batch["instance_centroid"] - batch["coord"]
    bias = bias + rng.normal(scale=0.01, size=bias.shape) * (1 + 20 * (rng.rand(
        *seg.shape) < 0.1))[..., None]
    mask = batch["mask"][..., None]
    return dict(seg_logits=(logits * mask).astype(np.float32),
                bias_pred=(bias * mask).astype(np.float32))


def test_propose_matches_jax():
    """``propose`` of both packages on the same outputs: the same masks,
    classes and scores, in order (the scores bit-equal)."""
    m = pg_models()
    batch = instance_scene(43)
    out = fixed_outputs(batch, 44)
    for b, n in enumerate(batch["mask"].sum(1)):
        args = (batch["coord"][b, :n], out["seg_logits"][b, :n], out["bias_pred"][b, :n],
                np.ones(n, bool))
        got, ref = m["model"].propose(*args), m["jmodel"].propose(*args)
        assert len(got[1]) == len(ref[1]) > 5
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(a, r)


class _Trainer:
    """What an evaluator reads of a trainer: the val batches, the forward's
    (fixed) outputs, the config, the model and a logger."""

    def __init__(self, model, batches, outputs, num_classes):
        self.model, self.val_loader, self._outputs = model, batches, outputs
        self.cfg = Config(dict(evaluate=True, data=dict(num_classes=num_classes)))
        self.comm_info, self.epoch, self.writer, self.state = {}, 0, None, None
        self.lines = []
        self.logger = types.SimpleNamespace(info=self.lines.append)

    def device_batch(self, input_dict):
        return input_dict

    def eval_step(self, batch):
        return {k: torch.from_numpy(v) for k, v in self._outputs[id(batch)].items()}

    def _eval_step(self, state, batch):
        return self._outputs[id(batch)]


def test_evaluator_matches_jax():
    """``InsSegEvaluator`` end to end on fixed outputs of two val batches
    (three scenes; batch_size_val 2 and 1) against the JAX hook run the
    same way: the AP table bit-equal to the JAX ``_class_ap`` at every
    threshold and class, the logged mAP / AP50 / AP25 line and the metric
    (AP50) equal; S3DIS's ignore list (-1,) as the shipped hook's
    (-1, 0, 1)."""
    m = pg_models()
    batches, outputs = [], {}
    for seed, counts in ((45, (2000, 1700)), (46, (1800,))):
        batch = instance_scene(seed, counts)
        input_dict = {k: v for k, v in batch.items() if k not in ("mask", "grid_coord")}
        input_dict["count"] = batch["mask"].sum(1).astype(np.int32)
        batches.append(input_dict)
        outputs[id(input_dict)] = fixed_outputs(batch, seed + 10)
    for ignore in ((-1,), (-1, 0, 1)):
        results = []
        for hook_cls, model in ((InsSegEvaluator, m["model"]), (JaxInsSegEvaluator, m["jmodel"])):
            trainer = _Trainer(model, batches, outputs, 13)
            hook = hook_cls(segment_ignore_index=ignore)
            hook.trainer = trainer
            hook.before_train()
            hook.eval()
            line = [s for s in trainer.lines if s.startswith("Val result")]
            results.append((hook, trainer.comm_info, line))
        (port_hook, port_info, port_line), (jax_hook, jax_info, jax_line) = results
        scenes = [s for b in batches for s in port_hook.batch_scenes(
            m["model"], b, {k: torch.from_numpy(v) for k, v in outputs[id(b)].items()})]
        ref = np.array([[JaxInsSegEvaluator._class_ap(scenes, c, o)
                         for c in jax_hook.valid_classes] for o in AP_OVERLAPS])
        np.testing.assert_array_equal(port_hook.ap_table, ref)
        assert port_hook.valid_classes == jax_hook.valid_classes
        assert port_line == jax_line and port_info == jax_info
        assert port_info["current_metric_name"] == "AP50"
        m_ap, m_ap50, m_ap25 = ap_summary(ref)
        assert port_info["current_metric_value"] == m_ap50 and 0 < m_ap <= m_ap50 <= m_ap25


def test_default_trainer_step_matches_jax(tmp_path):
    """One ``DefaultTrainer`` step through both packages of the shipped S3DIS
    PointGroup config at the reduced width (SGD, Nesterov, lr 0.1, weight
    decay 1e-4, PolyLR), f32 without autocast, Mix3D off as shipped: the
    model's loss and its three parts rtol 1e-4, the gradient as
    ``assert_gradient_triple`` holds it, the running statistics rtol 1e-5 /
    atol 1e-5, the parameters after the step within 1e-4 of max(1, max
    |value|)."""
    shipped = Config.fromfile(S3DIS_PG)
    model = dict(shipped.model)
    model["backbone"] = dict(model["backbone"], **{k: SPUNET[k] for k in (
        "base_channels", "channels", "layers")})
    model["backbone_out_channels"] = 8
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=model,
               optimizer=dict(shipped.optimizer), scheduler=dict(shipped.scheduler),
               data=dict(CFG["data"], num_classes=13))
    assert cfg["optimizer"]["nesterov"] and cfg["scheduler"] == dict(type="PolyLR")
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(copy.deepcopy(cfg))))
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    jtrainer.mesh = create_mesh(1)
    record_gradients(jtrainer)
    batch = instance_scene(47)
    assert_spunet_maps_exact(trainer.model.backbone, batch)
    np_batch = {k: v for k, v in batch.items() if k != "mask"}
    np_batch["count"] = batch["mask"].sum(1).astype(np.int32)
    start = weights(model, 48)
    jtrainer._init_variables = lambda batch, rng: (start["params"], start["batch_stats"])
    jbatch = jtrainer.device_batch(np_batch)
    jtrainer.initialize_state(jbatch)
    trainer.model.load_state_dict(jax_to_state_dict(start), strict=True)
    truth = float64_gradients(trainer.model, trainer.device_batch(np_batch),
                              lambda out, b: out["loss"])
    rng = jax.random.fold_in(jtrainer._base_rng, 1)
    jtrainer.state, jout = jtrainer._train_step(jtrainer.state, jbatch, rng)
    trainer.comm_info["input_dict"] = np_batch
    grads = port_gradients(trainer, trainer.run_step)
    out = trainer.comm_info["model_output_dict"]
    assert set(out) == {"loss", "seg_loss", "bias_l1_loss", "bias_cosine_loss"} == set(jout)
    for key in out:
        assert float(out[key]) == pytest.approx(float(jout[key]), rel=1e-4, abs=1e-6), key
    assert trainer.comm_info["lr"] == pytest.approx(float(jtrainer.scheduler(0)), abs=1e-12)
    assert_gradient_triple(grads, recorded_gradients(jtrainer), truth, "PointGroup step")
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


# -- data ---------------------------------------------------------------------------------


def parsed_room(seed, n, instances):
    """One room after the S3DIS val transform's InstanceParser: per-point
    arrays and ``bbox`` (instances, 8)."""
    rng = np.random.RandomState(seed)
    data = dict(coord=rng.rand(n, 3).astype(np.float32),
                segment=rng.randint(0, 13, n).astype(np.int64),
                instance=rng.permutation(np.arange(n) % instances).astype(np.int64))
    return InstanceParser(segment_ignore_index=(-1,))(data)


def test_bbox_collation():
    """The per-instance ``bbox`` through both collations: at batch_size_val
    1 the port's list holds the JAX array's one sample; at 2 samples of
    other instance counts the JAX collation raises (it stacks), the port's
    keeps each sample's (I, 8); a sample of one instance stays (1, 8) here
    where JAX squeezes it, and one of as many instances as points is not
    taken for a per-point key.  The per-point keys pad as in JAX."""
    rooms = [parsed_room(50, 300, 7), parsed_room(51, 250, 5)]
    assert [r["bbox"].shape for r in rooms] == [(7, 8), (5, 8)]
    got, ref = padded_collate_fn(rooms[:1]), jax_collate(rooms[:1])
    assert isinstance(got["bbox"], list) and ref["bbox"].shape == (1, 7, 8)
    np.testing.assert_array_equal(got["bbox"][0], ref["bbox"][0])
    with pytest.raises(ValueError):
        jax_collate(rooms)
    got = padded_collate_fn(rooms)
    for a, r in zip(got["bbox"], rooms):
        np.testing.assert_array_equal(a, r["bbox"])
    for key in ("coord", "segment", "instance", "instance_centroid"):
        assert got[key].shape[:2] == (2, 1024)
        np.testing.assert_array_equal(got[key][1, :250], rooms[1][key])
    assert (got["instance"][1, 250:] == -1).all()
    one = parsed_room(52, 40, 1)
    assert jax_collate([one])["bbox"].shape == (1, 8)
    assert padded_collate_fn([one])["bbox"][0].shape == (1, 8)
    square = parsed_room(53, 6, 6)
    assert square["bbox"].shape == (6, 8)
    assert jax_collate([square])["bbox"].shape == (1, 1024, 8)
    assert padded_collate_fn([square])["bbox"][0].shape == (6, 8)


# -- PointGroup over the PPT fine-tune backbone ----------------------------------------


def test_ppt_backbone_matches_jax():
    """PointGroup over PPT-v1m1 in ``backbone_mode`` over SpUNet-v1m3
    (adaptive PD banks, as the fine-tune configs), the batch's condition
    ``S3DIS`` (the JAX trainer drops strings, ROADMAP §3 item 24: the JAX
    model is applied with it): eval outputs and loss parts rtol 1e-4 /
    atol 1e-5; under ``ScanNet`` other outputs."""
    tree = weights(PG_PPT, 60)
    model = build_model(dict(PG_PPT)).eval()
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    jmodel = jax_build_model(dict(PG_PPT))
    batch = instance_scene(61)
    assert_spunet_maps_exact(model.backbone.backbone, batch)
    ref = jax.jit(lambda t, b: jmodel.apply(t, dict(b, condition_name="S3DIS"),
                                             train=False))(tree, batch)
    with torch.inference_mode():
        got = model(dict(tensors(batch), condition_name="S3DIS"))
        other = model(dict(tensors(batch), condition_name="ScanNet"))
    assert_outputs_close({k: v.numpy() for k, v in got.items()}, ref, OUT_KEYS)
    assert not torch.allclose(other["seg_logits"], got["seg_logits"])


# -- bridge and configs ---------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [PG, PG_PPT], ids=["spunet", "ppt"])
def test_bridge_round_trip_bit_equal(cfg):
    """The port's tree has the JAX model's names and shapes (``bias_fc1`` /
    ``bias_bn`` / ``bias_fc2`` / ``seg_head`` beside ``backbone_module``,
    a PPT backbone's tree under it with its own ``backbone_module``); the
    state_dict holds the reference's names (``bias_head.0/1/3``,
    ``seg_head``, ``backbone.*``); JAX tree -> state_dict -> JAX tree is
    bit-equal and loads with strict=True."""
    tree = weights(cfg, 62)
    batch = {k: jnp.asarray(v) for k, v in instance_scene(63, (200, 150), 256).items()}
    shapes = jax.eval_shape(lambda: jax_build_model(dict(cfg)).init(
        {"params": jax.random.PRNGKey(0)}, dict(batch, condition_name="S3DIS"), train=False))
    assert tree_shapes(tree) == {coll: {k: tuple(v.shape) for k, v in flatten_tree(
        dict(shapes[coll])).items()} for coll in ("params", "batch_stats")}
    model = build_model(dict(cfg))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    sd = model.state_dict()
    for key in ("bias_head.0.weight", "bias_head.1.running_var", "bias_head.3.bias",
                "seg_head.weight"):
        assert key in sd, key
    inner = "backbone.backbone." if cfg is PG_PPT else "backbone."
    assert f"{inner}conv_input.0.weight" in sd
    if cfg is PG_PPT:
        assert "backbone.embedding_table.weight" in sd
        assert "backbone.backbone.conv_input.1.bns.1.weight" in sd
    back = state_dict_to_jax(sd)
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("path", INSSEG_CONFIGS)
def test_shipped_insseg_configs_build(path):
    """Each shipped insseg config builds in the port: the model at full width
    (on the meta device), its optimizer and schedule, the train and val
    transforms; the evaluator hook, the ignore lists as shipped (ScanNet200
    model (-1, 0, 2), the S3DIS ones' (-1,), beside the (-1, 0, 1) of the
    hook, and of ScanNet200's InstanceParser, inherited from the ScanNet
    base: ROADMAP §3), the S3DIS PPT configs' batches tagged ``S3DIS`` (the
    ScanNet one's carry no condition)."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", path))
    with torch.device("meta"):
        model = build_model(dict(cfg.model))
    assert type(model).__name__ == "PointGroup"
    assert model.seg_head.out_features == cfg.data.num_classes
    optimizer = build_optimizer(dict(cfg.optimizer), model.named_parameters())
    assert type(optimizer).__name__ == "SGD" and optimizer.defaults["nesterov"]
    schedule = build_scheduler(dict(cfg.scheduler), cfg.optimizer.lr, 100)
    assert schedule(0) == pytest.approx(0.1) and schedule(99) < schedule(50) < 0.1
    dataset = path.split("/")[0]
    for split in ("train", "val"):
        Compose(cfg.data[split].transform)
        parser = next(t for t in cfg.data[split].transform if t["type"] == "InstanceParser")
        assert tuple(parser["segment_ignore_index"]) == ((-1,) if dataset == "s3dis"
                                                         else (-1, 0, 1))
    hook = next(h for h in cfg.hooks if h["type"] == "InsSegEvaluator")
    assert tuple(hook["segment_ignore_index"]) == (-1, 0, 1)
    assert model.segment_ignore_index == {"scannet200": (-1, 0, 2), "scannet": (-1, 0, 1),
                                          "s3dis": (-1,)}[dataset]
    adds = [t for t in cfg.data.train.transform if t["type"] == "Add"]
    if "ppt" in path:
        assert type(model.backbone).__name__ == "PointPromptTraining"
        assert model.backbone.backbone_mode
        assert adds == ([dict(type="Add", keys_dict={"condition": "S3DIS"})]
                        if dataset == "s3dis" else [])


def test_scannet_config_steps():
    """The shipped ScanNet PointGroup config at a reduced width takes one
    ``DefaultTrainer`` step on the CPU: the loss and its three parts finite,
    the parameters moved."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "scannet",
                                       "insseg-pointgroup-v1m1-0-spunet-base.py"))
    cfg.model.backbone.update(base_channels=8, channels=(8, 8), layers=(1, 1))
    cfg.model.backbone_out_channels = 8
    with tempfile.TemporaryDirectory() as save:
        cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                             "enable_amp": False, "evaluate": False, "hooks": [],
                             "save_path": save, "epoch": 2, "eval_epoch": 2})
        cfg.data.train = dict(type="TorchParityDataset")
        trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=cfg))
        batch = instance_scene(64)
        batch["segment"] = np.minimum(batch["segment"], 19)
        input_dict = {k: v for k, v in batch.items() if k != "mask"}
        input_dict["count"] = batch["mask"].sum(1).astype(np.int32)
        before = trainer.model.seg_head.weight.detach().clone()
        trainer.comm_info["input_dict"] = input_dict
        trainer.run_step()
    out = trainer.comm_info["model_output_dict"]
    assert set(out) == {"loss", "seg_loss", "bias_l1_loss", "bias_cosine_loss"}
    assert all(np.isfinite(float(v)) for v in out.values())
    assert not torch.equal(before, trainer.model.seg_head.weight)


# -- chip_smoke.py's rooms ----------------------------------------------------------------


def test_synthetic_rooms_unchanged_with_instances():
    """``chip_smoke.synthetic_room`` draws what it drew before it wrote
    instance ids (the digest of two rooms' coordinates, colours, labels and
    normals, and the generator's next draw, from the tree before), and
    gives each plane and each box an instance id of its own: a box's six
    faces share one, each instance holds one class."""
    digest = hashlib.sha256()
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.RandomState(chip_smoke.SEED + 1)
        rooms = []
        for i, room in enumerate(({}, chip_smoke.PTV3_ROOM)):
            path = os.path.join(d, f"r{i}.npz")
            chip_smoke.synthetic_room(rng, path, **room)
            rooms.append(dict(np.load(path)))
            for key in ("coord", "color", "semantic_gt", "normal"):
                if key in rooms[-1]:
                    digest.update(np.ascontiguousarray(rooms[-1][key]).tobytes())
        assert digest.hexdigest() == (
            "6b6a9c47bb372220c03c967f8fc166e2e993c07d388cddd7d58b0bb136bf2ec7")
        assert rng.randint(1 << 30) == 204294687
    room = rooms[0]
    ids = np.unique(room["instance_gt"])
    # ceiling, floor, 4 walls, window, door, board; beam, column, table,
    # 3 chairs, sofa, bookcase, clutter
    assert len(ids) == 18 and ids.min() == 0
    for iid in ids:
        assert len(np.unique(room["semantic_gt"][room["instance_gt"] == iid])) == 1
