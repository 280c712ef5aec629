"""The port's Point Prompt Training slice against the JAX package on the
CPU: ``Structured3DDataset`` (both layouts, several splits, items through
the shipped transform), ``MultiDatasetDataloader`` (length and the order of
datasets and samples over two epochs, two shards), PPT-v1m1 over
SpUNet-v1m3 under each condition (eval logits, training loss, the
whole-network gradient), PPT-v1m2 with adaptive PD banks, PPT-v1m1 over a
PDNorm PT-v3, ``PDNorm``, the bridge, the zero gradient of the parameters a
step does not reach (two ``DefaultTrainer`` steps), three
``MultiDatasetTrainer`` steps that change condition and an evaluator
forward, ``tools/train_torch.py`` -> ``tools/test_torch.py`` on the shipped
S3DIS PPT config against the JAX model fragment by fragment, and the
fine-tuning loader's merge of a PPT checkpoint.

Reductions from the shipped configs (SpUNet-v1m3 of channels (32, 64, 128,
256, 256, 128, 96, 96), a 96 -> 512 projection, 100,000-point crops, batch
12): SpUNet-v1m3 of one stage (8, 8), one block each, context 16, a
32-wide class table (the JAX compiles dominate the file's time); PT-v3 of two stages (8, 16), no
RPE; two samples of 2,000 and 1,700 voxels padded to 2,048 (500 and 430 in
512 for PT-v3).  Weights are made on the port's side (kernels of unit gain,
BatchNorm scales and statistics and the modulations randomised) and carried
over by the bridge.  Every parity input is first asserted to give the JAX
voxel hash the exact tables (it is lossy, ROADMAP §3 item 13).

Tolerances: a whole forward 1e-4 x max |logit|; a loss rtol 1e-4;
whole-network gradients as ``test_torch_cac_losses.assert_gradient_triple``
holds them; parameters after a step within 1e-4 of max(1, max |value|),
and those the step did not reach (idle banks, heads, the context table),
which move by the optimizer's decay and momentum alone, rtol 1e-5.
"""

import copy
import functools
import os
import random
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as jnn

from pointcloudpdf_tpu.datasets import DATASETS as JAX_DATASETS
from pointcloudpdf_tpu.datasets.loader import (
    MultiDatasetDataloader as JaxMultiDatasetDataloader)
from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.models import MODELS as JAX_MODELS
from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models.builder import build_model as jax_build_submodel
from pointcloudpdf_tpu.models.losses import build_criteria as jax_build_criteria
from pointcloudpdf_tpu.models.point_prompt_training import PDNorm as JaxPDNorm
from pointcloudpdf_tpu.parallel.mesh import create_mesh
from pointcloudpdf_tpu.utils import checkpoint as jax_checkpoint
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.datasets import DATASETS, build_dataset, padded_collate_fn
from pointcloudpdf_tpu_torch.datasets.loader import MultiDatasetDataloader
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.point_prompt_training import PDNorm
from pointcloudpdf_tpu_torch.utils import checkpoint
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_cac_losses import assert_gradient_triple, float64_gradients, grad_tree
from test_torch_layer import randomise_bn
from test_torch_ptv3 import BACKBONE as PTV3_BACKBONE
from test_torch_ptv3 import assert_maps_match_jax as assert_ptv3_maps_match_jax
from test_torch_ptv3 import scene as ptv3_scene
from test_torch_spunet import _jax_maps_fn, scene
from test_torch_st import tt
from test_torch_st_train import _assert_items_equal
from test_torch_train import CFG, port_gradients, record_gradients, recorded_gradients
from test_torch_trainer import _run_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import ppt_test_data  # noqa: E402  (phase 15's data.test)

torch.set_num_threads(1)
S3DIS_PPT = os.path.join(ROOT, "configs", "s3dis", "semseg-ppt-v1m1-0-s3-sc-st-spunet.py")
TOL = 1e-4                # x max |logit|
CONDITIONS = ("Structured3D", "ScanNet", "S3DIS")      # PPT's order
PD_CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")   # the backbones' order
CE = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
SPUNET = dict(type="SpUNet-v1m3", in_channels=6, num_classes=0, base_channels=8,
              channels=(8, 8), layers=(1, 1), conditions=PD_CONDITIONS,
              context_channels=16)
PPT_M1 = dict(type="PPT-v1m1", backbone=SPUNET, criteria=CE, backbone_out_channels=8,
              context_channels=16, conditions=CONDITIONS, embed_channels=32)
PPT_M2 = dict(type="PPT-v1m2", backbone=dict(SPUNET, norm_adaptive=True), criteria=CE,
              backbone_out_channels=8, context_channels=16, conditions=CONDITIONS,
              num_classes=(25, 20, 13))
PPT_V3 = dict(PPT_M1, backbone=dict(PTV3_BACKBONE, enable_rpe=False, pdnorm_bn=True,
                                    pdnorm_ln=True, pdnorm_conditions=PD_CONDITIONS))


def set_leaf(tree, path, value):
    node = tree
    for part in path.split("/")[:-1]:
        node = node[part]
    node[path.rsplit("/", 1)[-1]] = value


def weights(cfg, seed):
    """A PPT model's JAX tree made on the port's side: every kernel of unit
    gain, BatchNorm scales and statistics, the modulations, the context
    table and the class table randomised."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    tree = randomise_bn(state_dict_to_jax(build_model(dict(cfg)).state_dict()), rng)
    for path, a in flatten_tree(tree["params"]).items():
        if "modulation" in path:
            value = 0.3 * rng.standard_normal(a.shape)
        elif path.endswith("kernel"):
            value = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif path in ("embedding_table/embedding", "class_embedding"):
            value = rng.standard_normal(a.shape)
        else:
            continue
        set_leaf(tree["params"], path, value.astype(np.float32))
    return tree


def models(cfg, seed):
    """The JAX and port models of ``cfg`` on one set of weights."""
    tree = weights(cfg, seed)
    model = build_model(dict(cfg))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    return jax_build_model(dict(cfg)), model, tree


def assert_spunet_maps_exact(backbone, batch):
    """The JAX hash tables equal the port's exact ones on ``batch`` (every
    level, the stem's 5^3 table, the parents): ROADMAP §3 item 13."""
    got = backbone.index_maps(*tt(batch["grid_coord"], batch["mask"]))
    caps = tuple(m.shape[1] for m in got["mask"][1:])
    ref = _jax_maps_fn(caps)(batch["grid_coord"], batch["mask"])
    np.testing.assert_array_equal(got["nbr5"].numpy(), np.asarray(ref["nbr5"]))
    for key in ("nbr3", "grid", "mask", "c2p"):
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)


def assert_logits_close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(got - ref).max()
    assert np.abs(ref).max() > 0.1
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


_JAX_FNS = {}


def jax_passes(jmodel, condition, gradient):
    """One compile a model, condition and ``gradient``: the eval logits, the
    training forward's logits, loss and new running statistics, and with
    ``gradient`` the loss's gradient."""
    key = (id(jmodel), condition, gradient)
    if key not in _JAX_FNS:
        def passes(tree, batch):
            ev = jmodel.apply(tree, batch, train=False, condition=condition)

            def loss_fn(params):
                out, mut = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]},
                                        batch, train=True, condition=condition,
                                        mutable=["batch_stats", "diagnostics"])
                return out["loss"], (out["seg_logits"], mut["batch_stats"])

            if not gradient:
                return ev["seg_logits"], loss_fn(tree["params"]), None
            aux, grads = jax.value_and_grad(loss_fn, has_aux=True)(tree["params"])
            return ev["seg_logits"], aux, grads

        _JAX_FNS[key] = jax.jit(passes)
    return _JAX_FNS[key]


def check_model(jmodel, model, tree, batch, condition, what, gradient=False):
    """Eval and training-mode logits within 1e-4 x max |logit| of JAX's, the
    training loss rtol 1e-4, the new running statistics rtol 1e-5 / atol
    1e-5; with ``gradient`` the whole-network gradient as
    ``assert_gradient_triple`` holds it.  The condition named by the call
    and by the batch's ``condition_name`` alike."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, (ref_loss, (ref_train, ref_stats)), ref_grads = jax_passes(
        jmodel, condition, gradient)(tree, jbatch)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = copy.deepcopy(model)
    with torch.inference_mode():
        got = model.eval()(inputs, condition=condition)["seg_logits"].numpy()
        named = model(dict(inputs, condition_name=condition))["seg_logits"].numpy()
    np.testing.assert_array_equal(got, named)
    assert_logits_close(got, ref)
    if gradient:
        truth = float64_gradients(model, dict(batch, condition_name=condition),
                                  lambda out, b: out["loss"])
    out = model.train()(inputs, condition=condition)
    assert_logits_close(out["seg_logits"].detach().numpy(), ref_train)
    assert float(out["loss"].detach()) == pytest.approx(float(ref_loss), rel=1e-4)
    if gradient:
        out["loss"].backward()
        assert_gradient_triple(grad_tree(model), ref_grads, truth, what)
    got = flatten_tree(state_dict_to_jax(model.state_dict())["batch_stats"])
    for path, r in flatten_tree(jax.tree_util.tree_map(np.asarray, ref_stats)).items():
        np.testing.assert_allclose(got[path], r, rtol=1e-5, atol=1e-5, err_msg=path)
    return ref


# -- datasets and the loader ----------------------------------------------------------


def _room(rng, n, labels):
    coord = (rng.rand(n, 3) * [1.2, 1.0, 0.8]).astype(np.float32)
    return dict(coord=coord, color=(rng.rand(n, 3) * 255).astype(np.float32),
                normal=rng.standard_normal((n, 3)).astype(np.float32),
                semantic_gt=rng.randint(-1, labels, n).astype(np.int64))


def test_structured3d_matches_jax(tmp_path):
    """Both layouts (``<split>/scene*/room*.npz`` and ``<split>/*.npz``) over
    two splits: the data list and the ``scene_room`` names equal the JAX
    package's; every item through the shipped Structured3D transform of
    the PPT configs (random scale and flip, grid sample, sphere crop, the
    condition) bit-equal to JAX's from one seed of numpy's and Python's
    RNGs."""
    rng = np.random.RandomState(0)
    for split, layout in (("train", ("scene_00000/room_1", "scene_00000/room_7",
                                     "scene_00012/room_2", "flat_a")),
                          ("val", ("scene_03000/room_0", "flat_b"))):
        for rel in layout:
            path = tmp_path / split / f"{rel}.npz"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(path, **_room(rng, 1500, 25))
    train = Config.fromfile(S3DIS_PPT).to_dict()["data"]["train"]["datasets"][0]
    assert train["type"] == "Structured3DDataset"
    cfg = dict(train, split=("train", "val"), data_root=str(tmp_path))
    port, ref = build_dataset(copy.deepcopy(cfg)), JAX_DATASETS.build(copy.deepcopy(cfg))
    assert port.data_list == ref.data_list and len(port) == 2 * 6
    names = [port.get_data_name(i) for i in range(6)]
    assert names == [ref.get_data_name(i) for i in range(6)]
    assert {"scene_00000_room_1", "scene_00012_room_2", "flat_a", "flat_b"} <= set(names)
    for i in range(len(ref)):
        random.seed(i)
        np.random.seed(i)
        got = port[i]
        random.seed(i)
        np.random.seed(i)
        _assert_items_equal(got, ref[i], f"item {i}")
        assert got["condition"] == "Structured3D"


class _Named:
    """A dataset of named samples; its items are their names."""

    def __init__(self, tag="a", n=5, loop=1, **kwargs):
        self.tag, self.n, self.loop = tag, n, loop

    def __len__(self):
        return self.n * self.loop

    def __getitem__(self, idx):
        return f"{self.tag}{idx % self.n}"


for _registry in (DATASETS, JAX_DATASETS):
    _registry.register_module("PPTNamedStub", module=_Named, force=True)


def _loader_sequence(cls, registry, shard, loops=(2, 1, 1), sizes=(9, 5, 4)):
    concat = registry.build(dict(type="ConcatDataset", loop=3, datasets=[
        dict(type="PPTNamedStub", tag=t, n=n, loop=lp)
        for t, n, lp in zip("abc", sizes, loops)]))
    loader = cls(concat, batch_size=2, collate_fn=list, seed=5, shard_id=shard,
                 num_shards=2)
    epochs = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        epochs.append([tuple(batch) for batch in loader])
    return len(loader), epochs


def test_multi_dataset_loader_matches_jax():
    """Loops 2 : 1 : 1 over a concat looped 3 times, shards 0 and 1 of 2: the
    length (the schedule's steps) and, over two epochs, the sequence of
    batches (each one dataset's sample names) equal the JAX loader's; both
    shards take the same dataset at every step."""
    runs = {}
    for shard in (0, 1):
        got = _loader_sequence(MultiDatasetDataloader, DATASETS, shard)
        assert got == _loader_sequence(JaxMultiDatasetDataloader, JAX_DATASETS, shard)
        runs[shard] = got
    assert runs[0][0] == runs[1][0] > 0
    for e0, e1 in zip(runs[0][1], runs[1][1]):
        assert len(e0) == len(e1) == runs[0][0]
        assert [{s[0] for s in b} for b in e0] == [{s[0] for s in b} for b in e1]
        assert all(len({s[0] for s in b}) == 1 for b in e0)
        assert {s[0] for b in e0 for s in b} == set("abc")
    assert runs[0][1][0] != runs[0][1][1]


def test_batch_condition():
    """One condition a batch (Mix3D keeps it); a batch with two raises."""
    samples = [dict(coord=np.zeros((n, 3), np.float32), condition="S3DIS")
               for n in (5, 7, 3, 4)]
    from pointcloudpdf_tpu_torch.engines.defaults import batch_condition
    batch = padded_collate_fn(samples, mix_prob=1.0)
    assert batch["condition"] == ["S3DIS"] * 4 and batch_condition(batch) == "S3DIS"
    assert batch_condition(dict(coord=batch["coord"])) is None
    with pytest.raises(ValueError, match="one dataset condition"):
        batch_condition(dict(condition=["S3DIS", "ScanNet"]))


# -- the models ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def m1_models():
    return models(PPT_M1, 31)


def parity_batch(seed):
    batch = scene(seed)
    assert_spunet_maps_exact(build_model(dict(SPUNET)), batch)
    return batch


@pytest.mark.parametrize("condition", CONDITIONS)
def test_ppt_v1m1_matches_jax(m1_models, condition):
    """PPT-v1m1 over SpUNet-v1m3 under each condition: the logits hold the
    condition's classes (25 / 20 / 13); the checks of ``check_model``, the
    whole-network gradient under S3DIS (the shipped S3DIS config's)."""
    jmodel, model, tree = m1_models
    batch = parity_batch(32)
    ref = check_model(jmodel, model, tree, batch, condition, f"PPT-v1m1 {condition}",
                      gradient=condition == "S3DIS")
    assert ref.shape == (2, 2048, (25, 20, 13)[CONDITIONS.index(condition)])


def test_ppt_v1m2_adaptive_matches_jax():
    """PPT-v1m2 over SpUNet-v1m3 with adaptive PD banks (the context from
    the embedding table modulates every norm), under ScanNet: the checks of
    ``check_model``; the idle heads' and banks' gradients 0, the context
    table's only at the condition's row."""
    jmodel, model, tree = models(PPT_M2, 33)
    batch = parity_batch(34)
    check_model(jmodel, model, tree, batch, "ScanNet", "PPT-v1m2", gradient=True)
    model.zero_grad(set_to_none=True)
    model.train()({k: torch.from_numpy(v) for k, v in batch.items()},
                  condition="ScanNet")["loss"].backward()
    assert model.seg_heads[0].weight.grad is None and model.seg_heads[2].weight.grad is None
    assert model.backbone.conv_input[1].bns[1].weight.grad is None
    grad = model.embedding_table.weight.grad
    assert grad[1].abs().max() > 0 and (grad[[0, 2]] == 0).all()


def test_ppt_over_pdnorm_ptv3_matches_jax():
    """PPT-v1m1 over a PT-v3 with PD BatchNorm and LayerNorm banks at drop
    path 0, under S3DIS: the checks of ``check_model`` (the maps and curve
    sorts asserted exact first)."""
    jmodel, model, tree = models(PPT_V3, 35)
    batch = ptv3_scene(36)
    assert_ptv3_maps_match_jax(model, batch)
    check_model(jmodel, model, tree, batch, "S3DIS", "PPT-v1m1 over PT-v3")


def jax_tree_shapes(cfg, batch, condition):
    shapes = jax.eval_shape(lambda: jax_build_model(dict(cfg)).init(
        {"params": jax.random.PRNGKey(0)}, {k: jnp.asarray(v) for k, v in batch.items()},
        train=False, condition=condition))
    return {coll: {k: tuple(v.shape) for k, v in flatten_tree(dict(shapes[coll])).items()}
            for coll in ("params", "batch_stats")}


@pytest.mark.parametrize("cfg", [PPT_M1, PPT_M2, PPT_V3, dict(PPT_M1, backbone_mode=True)],
                         ids=["v1m1", "v1m2", "v1m1-ptv3", "backbone-mode"])
def test_bridge_round_trip_bit_equal(cfg):
    """The port's tree has the JAX model's names and shapes (``embedding_table
    /embedding``, ``proj_head``, the 0-d ``logit_scale``, ``seg_head_{i}``,
    the backbone's PD banks); JAX tree -> state_dict -> JAX tree is
    bit-equal, and the state_dict has the reference's names and loads with
    strict=True."""
    batch = (ptv3_scene if cfg is PPT_V3 else scene)(37)
    batch = {k: v for k, v in batch.items() if k != "segment"}
    tree = weights(cfg, 38)
    assert {coll: {k: a.shape for k, a in flatten_tree(tree[coll]).items()}
            for coll in ("params", "batch_stats")} == jax_tree_shapes(cfg, batch, "S3DIS")
    sd = jax_to_state_dict(tree)
    model = build_model(dict(cfg))
    model.load_state_dict(sd, strict=True)
    names = set(sd)
    assert "embedding_table.weight" in names
    if cfg.get("backbone_mode"):
        assert not any(n.startswith(("proj_head", "class_embedding")) for n in names)
    elif cfg["type"] == "PPT-v1m2":
        assert {f"seg_heads.{i}.weight" for i in range(3)} <= names
    else:
        assert {"proj_head.weight", "class_embedding", "logit_scale"} <= names
        assert sd["logit_scale"].dim() == 0
    back = state_dict_to_jax(model.state_dict())
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].shape == a[k].shape, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_pdnorm_matches_jax():
    """``PDNorm`` (decoupled, adaptive): each condition's bank in training
    and eval rtol 1e-4 / atol 1e-5 against the JAX module, the running
    statistics of that bank alone moved; an unknown condition takes bank 0."""
    rng = np.random.RandomState(39)
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    mask = np.arange(40)[None] < np.array([[40], [29]])
    context = rng.standard_normal((1, 16)).astype(np.float32)
    jnorm = JaxPDNorm(8, conditions=PD_CONDITIONS, context_channels=16, adaptive=True)
    variables = jax.jit(functools.partial(jnorm.init, train=True, condition="S3DIS"))(
        jax.random.PRNGKey(0), x, mask, context=context)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    randomise_bn(variables, rng)
    norm = PDNorm(8, conditions=PD_CONDITIONS, context_channels=16, adaptive=True)
    sd = {}
    for i in range(3):
        p, s = variables["params"][f"norm{i}"], variables["batch_stats"][f"norm{i}"]
        sd.update({f"norm.{i}.weight": p["scale"], f"norm.{i}.bias": p["bias"],
                   f"norm.{i}.running_mean": s["mean"], f"norm.{i}.running_var": s["var"],
                   f"norm.{i}.num_batches_tracked": np.array(0)})
    sd["modulation.1.weight"] = variables["params"]["modulation"]["kernel"].T
    sd["modulation.1.bias"] = variables["params"]["modulation"]["bias"]
    norm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    for condition in PD_CONDITIONS + ("Other",):
        bank = PD_CONDITIONS.index(condition) if condition in PD_CONDITIONS else 0
        for train in (True, False):
            ref, mut = jnorm.apply(variables, x, mask, train, condition=condition,
                                   context=context, mutable=["batch_stats"])
            local = copy.deepcopy(norm).train(train)
            got = local(*tt(x, mask), condition=condition, context=torch.from_numpy(context))
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5)
            for i in range(3):
                moved = not torch.equal(local.norm[i].running_mean, norm.norm[i].running_mean)
                assert moved == (train and i == bank), (condition, train, i)
                if moved:
                    np.testing.assert_allclose(
                        local.norm[i].running_var.numpy(),
                        np.asarray(mut["batch_stats"][f"norm{i}"]["var"]), rtol=1e-5)


# -- the trainers ----------------------------------------------------------------------


class JaxS3DISSegmentor(jnn.Module):
    """A JAX segmentor that runs its backbone under ``S3DIS``: the JAX
    ``DefaultTrainer`` drops the batch's condition strings, so the condition
    is the model's here (the port's trainer reads it off the batch)."""

    backbone: dict = None
    criteria: list = None

    def setup(self):
        self.backbone_module = jax_build_submodel(dict(self.backbone))

    def __call__(self, input_dict, train=True):
        out = self.backbone_module(input_dict, train=train, condition="S3DIS")
        return dict(seg_logits=out, intermediates={})

    def loss(self, seg_logits, target):
        return jax_build_criteria(self.criteria)(seg_logits, target)


JAX_MODELS.register_module("PPTTestS3DISSegmentor", module=JaxS3DISSegmentor, force=True)


def trainer_batch(seed, condition):
    batch = scene(seed)
    assert_spunet_maps_exact(build_model(dict(SPUNET)), batch)
    return dict(coord=batch["grid_coord"] * np.float32(0.02), grid_coord=batch["grid_coord"],
                feat=batch["feat"], segment=batch["segment"],
                count=batch["mask"].sum(1).astype(np.int32), condition=[condition] * 2)


def idle_paths(tree, banks, heads=()):
    """(path, row) of the PD banks' rows ``banks`` (the backbones' order of
    conditions) and (path, None) of the heads ``heads`` (PPT's order)."""
    out = []
    for path, a in flatten_tree(tree).items():
        if a.ndim == 2 and a.shape[0] == 3 and path.split("/")[-1] in ("scale", "bias"):
            out += [(path, row) for row in banks]
        elif path.startswith("seg_head_") and int(path.split("/")[0][9:]) in heads:
            out.append((path, None))
    return out


def assert_params_match(got_tree, ref_tree, idle):
    got = flatten_tree(got_tree)
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_tree))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        err = np.abs(got[path] - r).max()
        assert err <= 1e-4 * max(np.abs(r).max(), 1.0), (path, err)
    for path, row in idle:
        a, r = (t[path] if row is None else t[path][row] for t in (got, ref))
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=0, err_msg=f"{path} {row}")


def test_default_trainer_steps_move_idle_banks_as_jax(tmp_path):
    """Two ``DefaultTrainer`` steps of SpUNet-v1m3 under S3DIS (the batch's
    ``condition``; SGD, Nesterov momentum 0.9, weight decay 0.01, lr 0.1)
    against the JAX ``DefaultTrainer``: the losses rtol 1e-4 and, after each
    step, every parameter, the idle banks' rows rtol 1e-5: they have no
    gradient in the port's backward and a zero gradient in the JAX one, and
    the optimizer decays them and moves their momentum in both."""
    model = dict(type="DefaultSegmentor", backbone=dict(SPUNET, num_classes=13),
                 criteria=CE)
    opt = dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.01, nesterov=True)
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=model, optimizer=opt,
               scheduler=dict(type="MultiStepLR", milestones=[0.9], gamma=0.1))
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(copy.deepcopy(cfg))))
    cfg["model"] = dict(model, type="PPTTestS3DISSegmentor")
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    jtrainer.mesh = create_mesh(1)
    start = weights(model, 40)
    jtrainer._init_variables = lambda batch, rng: (start["params"], start["batch_stats"])
    trainer.model.load_state_dict(jax_to_state_dict(start), strict=True)
    idle = idle_paths(start["params"], [i for i, c in enumerate(PD_CONDITIONS)
                                        if c != "S3DIS"])
    assert len(idle) > 10
    for step, seed in enumerate((41, 42)):
        np_batch = trainer_batch(seed, "S3DIS")
        jbatch = jtrainer.device_batch(np_batch)
        if step == 0:
            jtrainer.initialize_state(jbatch)
        jtrainer.state, jout = jtrainer._train_step(
            jtrainer.state, jbatch, jax.random.fold_in(jtrainer._base_rng, step + 1))
        trainer.comm_info["input_dict"] = np_batch
        trainer.run_step()
        out = trainer.comm_info["model_output_dict"]
        assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4)
        assert_params_match(state_dict_to_jax(trainer.model.state_dict())["params"],
                            jtrainer.state.params, idle)


class _Scenes:
    """Stands in for the datasets a trainer builds: only its length reaches
    the step."""

    def __init__(self, **kwargs):
        self.loop = 1

    def __len__(self):
        return 8


for _registry in (DATASETS, JAX_DATASETS):
    _registry.register_module("PPTParityDataset", module=_Scenes, force=True)


def test_multi_dataset_trainer_steps_match_jax(tmp_path):
    """Three ``MultiDatasetTrainer`` steps of PPT-v1m2 over a one-stage
    SpUNet-v1m3 under S3DIS, Structured3D, S3DIS, with the shipped SGD
    (Nesterov momentum 0.9; weight decay 0.01 so that the idle parameters'
    decay shows) and OneCycleLR, against the JAX ``MultiDatasetTrainer``:
    each step's loss rtol 1e-4 and rate, every parameter after each step
    (the idle banks' rows, the idle heads and the unused context table
    rtol 1e-5), the running statistics; the first step's gradient as
    ``assert_gradient_triple`` holds it; then an evaluator forward under the
    val batch's condition."""
    shipped = Config.fromfile(S3DIS_PPT)
    model = dict(PPT_M2, backbone=dict(SPUNET))
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=model,
               optimizer=dict(shipped.optimizer, weight_decay=0.01),
               scheduler=dict(shipped.scheduler),
               data=dict(CFG["data"], num_classes=13, train=dict(
                   type="ConcatDataset",
                   datasets=[dict(type="PPTParityDataset") for _ in range(3)])))
    trainer = TRAINERS.build(dict(type="MultiDatasetTrainer", cfg=Config(copy.deepcopy(cfg))))
    jtrainer = JAX_TRAINERS.build(dict(type="MultiDatasetTrainer", cfg=JaxConfig(cfg)))
    assert trainer.total_steps == jtrainer.total_steps == 2 * 3 * 4
    jtrainer.mesh = create_mesh(1)
    record_gradients(jtrainer)
    start = weights(model, 43)
    jtrainer._init_variables = lambda batch, rng: (start["params"], start["batch_stats"])
    trainer.model.load_state_dict(jax_to_state_dict(start), strict=True)
    used = set()
    for step, (seed, condition) in enumerate(((44, "S3DIS"), (45, "Structured3D"),
                                              (46, "S3DIS"))):
        np_batch = trainer_batch(seed, condition)
        jtrainer.comm_info["input_dict"] = np_batch
        jtrainer.run_step()
        trainer.comm_info["input_dict"] = np_batch
        if step == 0:
            truth = float64_gradients(trainer.model, trainer.device_batch(np_batch),
                                      lambda out, b: out["loss"])
            grads = port_gradients(trainer, trainer.run_step)
            assert_gradient_triple(grads, recorded_gradients(jtrainer), truth,
                                   "PPT-v1m2 step")
        else:
            trainer.run_step()
        assert trainer.comm_info["condition"] == condition
        jout = jtrainer.comm_info["model_output_dict"]
        out = trainer.comm_info["model_output_dict"]
        assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4), step
        assert trainer.comm_info["lr"] == pytest.approx(jtrainer.comm_info["lr"], rel=1e-6)
        # idle: the banks' rows and heads of the conditions no step has
        # trained yet (a bank trained before moves by its momentum, whose
        # gradient carries f32 noise), and the context table (no norm is
        # adaptive)
        used.add(condition)
        idle = [("embedding_table/embedding", None)] + idle_paths(
            start["params"], [i for i, c in enumerate(PD_CONDITIONS) if c not in used],
            [i for i, c in enumerate(CONDITIONS) if c not in used])
        state = state_dict_to_jax(trainer.model.state_dict())
        assert_params_match(state["params"], jtrainer.state.params, idle)
        got = flatten_tree(state["batch_stats"])
        for path, r in flatten_tree(jax.tree_util.tree_map(
                np.asarray, jtrainer.state.batch_stats)).items():
            np.testing.assert_allclose(got[path], r, rtol=1e-5, atol=1e-5, err_msg=path)
    val = trainer_batch(47, "S3DIS")
    ref = jtrainer._eval_step(jtrainer.state, jtrainer.device_batch(val))["seg_logits"]
    got = trainer.eval_step(trainer.device_batch(val))["seg_logits"].numpy()
    assert got.shape == (2, 2048, 13)
    assert_logits_close(got, ref)


# -- the entry points ------------------------------------------------------------------


def _ppt_scene(rng, n, labels):
    """A small room of ``n`` points with colours and normals, labels in a
    dataset's own class space (``labels`` classes)."""
    return dict(coord=(rng.rand(n, 3) * [1.0, 0.8, 0.6]).astype(np.float32),
                color=(rng.rand(n, 3) * 255).astype(np.float32),
                normal=rng.standard_normal((n, 3)).astype(np.float32),
                semantic_gt=rng.randint(0, labels, n).astype(np.int64),
                instance_gt=np.zeros(n, np.int64))


def write_ppt_data(root, rng, n=1200):
    """Synthetic scenes in the three layouts of the PPT configs (relative to
    ``root``): Structured3D ``data/structured3d/train/scene_*/room_*.npz``
    (25 classes), ScanNet ``data/scannet/train/*.npz`` (20 classes, as
    ``semantic_gt20``), S3DIS ``data/s3dis/Area_{1,5}/*.npz`` (13)."""
    for i in range(4):
        path = os.path.join(root, "data", "structured3d", "train", f"scene_{i:05d}")
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "room_0.npz"), **_ppt_scene(rng, n, 25))
    os.makedirs(os.path.join(root, "data", "scannet", "train"), exist_ok=True)
    for i in range(2):
        room = _ppt_scene(rng, n, 20)
        room["semantic_gt20"] = room.pop("semantic_gt")
        np.savez(os.path.join(root, "data", "scannet", "train", f"scene000{i}_00.npz"),
                 **room)
    for area, count in (("Area_1", 2), ("Area_5", 1)):
        os.makedirs(os.path.join(root, "data", "s3dis", area), exist_ok=True)
        for i in range(count):
            np.savez(os.path.join(root, "data", "s3dis", area, f"office_{i}.npz"),
                     **_ppt_scene(rng, n, 13))


_CLI_CONFIG = '''
_base_ = [{base!r}]
batch_size = 2
num_worker = 0
enable_amp = False
seed = 11
epoch = 1
eval_epoch = 1
model = dict(backbone=dict(base_channels=8, channels=(8, 8), layers=(1, 1),
                           context_channels=16),
             backbone_out_channels=8, context_channels=16, embed_channels=32)
data = dict(test={test!r})
'''


def test_train_then_test_cli_matches_jax(tmp_path, monkeypatch):
    """``tools/train_torch.py --device cpu`` on the shipped S3DIS PPT config
    (its three datasets at ratios 2 : 1 : 1, Mix3D 0.8, the S3DIS evaluator)
    at narrow widths over synthetic scenes in the three layouts, then
    ``tools/test_torch.py --device cpu`` on the checkpoint through a config
    that adds a ``data.test`` under condition S3DIS: every training step's
    condition is its batch's dataset's, every condition trains, and the
    pred file equals the JAX model's vote, fragment by fragment with
    ``condition="S3DIS"``, on the checkpoint."""
    rng = np.random.RandomState(48)
    write_ppt_data(str(tmp_path), rng)
    monkeypatch.chdir(tmp_path)
    config = tmp_path / "ppt.py"
    config.write_text(_CLI_CONFIG.format(base=S3DIS_PPT, test=ppt_test_data("data/s3dis")))
    seen = []
    run_step = TRAINERS.get("MultiDatasetTrainer").run_step

    def recording_run_step(self):
        run_step(self)
        seen.append((self.comm_info["condition"], self.comm_info["input_dict"]["condition"]))

    monkeypatch.setattr(TRAINERS.get("MultiDatasetTrainer"), "run_step", recording_run_step)
    log = _run_tool("train_torch.py", ["--config-file", str(config), "--device", "cpu",
                                       "--options", "save_path=exp/ppt"])
    # 4 Structured3D rooms at loop 2 and batch 2 drive the epoch: 2 batches
    # a cycle of it, one of ScanNet, one of S3DIS
    assert [c for c, _ in seen] == ["Structured3D", "Structured3D", "ScanNet", "S3DIS"]
    assert all(set(names) == {c} for c, names in seen)
    assert "Val result: mIoU/mAcc/allAcc" in log
    weight = tmp_path / "exp" / "ppt" / "model" / "model_last.pth"
    log = _run_tool("test_torch.py", ["--config-file", str(config), "--device", "cpu",
                                      "--options", f"weight={weight}",
                                      "save_path=exp/ppt_test"])
    assert "Val result: mIoU/mAcc/allAcc" in log
    pred = np.load(tmp_path / "exp" / "ppt_test" / "result" / "office_0_pred.npy")

    cfg = Config.fromfile(str(config)).to_dict()
    state = checkpoint.load_checkpoint(str(weight))["state"]
    jmodel = jax_build_model(copy.deepcopy(cfg["model"]))
    backbone = build_model(copy.deepcopy(cfg["model"]["backbone"]))
    apply = jax.jit(functools.partial(jmodel.apply, train=False, condition="S3DIS"))
    data = build_dataset(cfg["data"]["test"])[0]
    vote = np.zeros((len(data["segment"]), 13), np.float32)
    for fragment in data["fragment_list"]:
        collated = padded_collate_fn([fragment])
        batch = {k: v for k, v in collated.items() if isinstance(v, np.ndarray)}
        batch["mask"] = np.arange(batch["coord"].shape[1])[None] < batch["count"][:, None]
        assert_spunet_maps_exact(backbone, batch)
        out = apply({"params": state["params"], "batch_stats": state["batch_stats"]},
                    {k: jnp.asarray(batch[k]) for k in ("coord", "grid_coord", "feat", "mask")})
        logits = np.asarray(out["seg_logits"])[0, :int(batch["count"][0])]
        e = np.exp(logits - logits.max(-1, keepdims=True))
        np.add.at(vote, fragment["index"], e / e.sum(-1, keepdims=True))
    np.testing.assert_array_equal(pred, vote.argmax(-1))


# -- fine-tuning from a PPT checkpoint ---------------------------------------------------


def full_width_tree(cfg, seed):
    """A model's JAX tree at full width, every value seeded normal (built on
    the meta device: initialising 46M parameters takes seconds)."""
    with torch.device("meta"):
        model = build_model(dict(cfg))
    model = model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.normal_(generator=gen)
    return state_dict_to_jax(model.state_dict())


def test_finetune_loader_merges_ppt_checkpoint_as_jax():
    """``configs/scannet200/semseg-pt-v3m1-1-ppt-ft.py`` loads a PPT
    checkpoint through ``CheckpointLoader(keywords="module.backbone_module.",
    replacement="module.")``.  From one PPT-v1m1 / PDNorm PT-v3 checkpoint
    (the S3DIS PPT-extreme config's model at full width), both packages'
    merges into the fine-tuning model's tree are equal, leaf for leaf; the
    count of backbone leaves that land is printed (the rewrite matches no
    JAX path: the leaves land by their own names; the PD banks, (3, C)
    against (C,) or under other names, do not)."""
    from pointcloudpdf_tpu_torch.engines.hooks.misc import CheckpointLoader

    ppt_cfg = Config.fromfile(os.path.join(ROOT, "configs", "s3dis",
                                           "semseg-pt-v3m1-1-ppt-extreme.py"))
    ft_cfg = Config.fromfile(os.path.join(ROOT, "configs", "scannet200",
                                          "semseg-pt-v3m1-1-ppt-ft.py"))
    loader = next(h for h in ft_cfg.hooks if h["type"] == "CheckpointLoader")
    hook = CheckpointLoader(**{k: v for k, v in loader.items() if k != "type"})
    rewrite = {hook.keywords: hook.replacement}
    source, target = (full_width_tree(cfg.model, seed)
                      for cfg, seed in ((ppt_cfg, 49), (ft_cfg, 50)))
    got = checkpoint.load_weights_into(copy.deepcopy(target), source, rewrite=rewrite)
    ref = jax_checkpoint.load_weights_into(copy.deepcopy(target), source, rewrite=rewrite)
    got, ref, before = (flatten_tree(t) for t in (got, ref, target))
    assert got.keys() == ref.keys() == before.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    landed = [k for k in before if not np.array_equal(got[k], before[k])]
    backbone = [k for k in before if "/backbone_module/" in k]
    print(f"PPT checkpoint -> ScanNet200 PT-v3: {len(landed)} of {len(backbone)} backbone "
          f"leaves land, {sum(1 for k in landed if k not in backbone)} others")
    assert landed and all(k in backbone for k in landed)
