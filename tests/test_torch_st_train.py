"""The port's Stratified Transformer training slice against the JAX package
on the CPU: the ScanNet / ScanNet200 datasets (the data of the paper's
released ScanNet ST model), one ``OpenSegTrainer`` step of a small ST-v1m1 +
ST recognizer past ``start_epoch`` under AdamW with the config's ``blocks``
group and the warm-up schedule, and the drop-path generator of the trainer
(bit-equal steps from one seed, other draws from another, the global RNG
untouched).

The JAX side runs its exact CPU paths (exact kNN, unfused window attention
and KPConv).  Drop path cannot be compared draw for draw across the two
packages (JAX folds a key, the port seeds a ``torch.Generator``), so the
parity step runs at ``drop_path_rate=0`` and the generator is tested on the
port alone.
"""

import contextlib
import copy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.datasets import DATASETS as JAX_DATASETS
from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.models.stratified_transformer import st as stm
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.datasets import DATASETS
from pointcloudpdf_tpu_torch.engines.train import TRAINERS, step_seed
from pointcloudpdf_tpu_torch.ops import geometry
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree, unflatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_st import BACKBONE, CHANNELS, cloud, knn_tie_gap
from test_torch_train import (CFG, GRADIENT_TOL, assert_gradients_close,
                              assert_trees_close,
                              perturbed_start, port_gradients, record_gradients,
                              recorded_gradients)

torch.set_num_threads(1)


# -- ScanNet data ------------------------------------------------------------------


def _scannet_scene(rng, n):
    coord = (rng.rand(n, 3) * np.array([3.0, 2.5, 1.5])).astype(np.float32)
    return dict(
        coord=coord, color=(rng.rand(n, 3) * 255).astype(np.float32),
        normal=rng.randn(n, 3).astype(np.float32),
        semantic_gt20=rng.randint(-1, 20, n).astype(np.int64),
        semantic_gt200=rng.randint(-1, 200, n).astype(np.int64),
        instance_gt=rng.randint(-1, 9, n).astype(np.int64))


_TRAIN_TF = [
    dict(type="CenterShift", apply_z=True),
    dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
         keys=("coord", "color", "normal", "segment"), return_grid_coord=True),
    dict(type="NormalizeColor", mode="zeroOne"),
    dict(type="ToTensor"),
    dict(type="Collect", keys=("coord", "grid_coord", "segment"),
         feat_keys=("coord", "color", "normal")),
]
_TEST_CFG = dict(
    voxelize=dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="test",
                  keys=("coord", "color", "normal"), return_grid_coord=True),
    crop=None,
    post_transform=[dict(type="CenterShift", apply_z=False), dict(type="ToTensor"),
                    dict(type="Collect", keys=("coord", "grid_coord", "index"),
                         feat_keys=("coord", "color", "normal"))],
    aug_transform=[[dict(type="RandomScale", scale=[1, 1])],
                   [dict(type="RandomScale", scale=[1.1, 1.1])]])


def _assert_items_equal(a, b, where):
    if isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _assert_items_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_items_equal(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
        assert a.dtype == b.dtype, where
    else:
        assert a == b, where


@pytest.mark.parametrize("dataset", ["ScanNetDataset", "ScanNet200Dataset"])
@pytest.mark.parametrize("protocol", ["full", "lr_file", "la_file", "test"])
def test_scannet_items_match_jax(tmp_path, dataset, protocol):
    """Scenes in the ScanNet layout (``<split>/<scene>.pth`` with coord,
    color, normal, semantic_gt20 / semantic_gt200, instance_gt): every item
    of the port's dataset equals the JAX package's, key for key and bit for
    bit, under the full split, the limited-reconstruction list
    (``lr_file``), the limited-annotation sample (``la_file``) and the test
    protocol (fragments)."""
    rng = np.random.RandomState(0)
    names = [f"scene000{i}_00" for i in range(3)]
    for split in ("train", "val"):
        (tmp_path / split).mkdir()
        for name in names:
            torch.save(_scannet_scene(rng, int(rng.uniform(400, 600))),
                       tmp_path / split / f"{name}.pth")
    cfg = dict(type=dataset, split="train", data_root=str(tmp_path),
               transform=_TRAIN_TF, test_mode=False)
    if protocol == "lr_file":
        np.savetxt(tmp_path / "lr.txt", names[:2], fmt="%s")
        cfg["lr_file"] = str(tmp_path / "lr.txt")
    elif protocol == "la_file":
        torch.save({name: np.sort(rng.choice(400, 40, replace=False))
                    for name in names}, tmp_path / "la.pth")
        cfg["la_file"] = str(tmp_path / "la.pth")
    elif protocol == "test":
        cfg.update(split="val", test_mode=True, test_cfg=_TEST_CFG,
                   transform=[dict(type="CenterShift", apply_z=True),
                              dict(type="NormalizeColor", mode="zeroOne")])
    port, ref = DATASETS.build(copy.deepcopy(cfg)), JAX_DATASETS.build(copy.deepcopy(cfg))
    assert len(port) == len(ref) == (2 if protocol == "lr_file" else 3)
    for i in range(len(ref)):
        # the train-mode grid sample draws its kept point from numpy's RNG
        np.random.seed(i)
        got = port[i]
        np.random.seed(i)
        _assert_items_equal(got, ref[i], f"{protocol} item {i}")
    if protocol == "la_file":
        item = port.get_data(0)
        assert (item["segment"] != -1).sum() <= 40


@pytest.mark.parametrize("part", ["train", "val"])
@pytest.mark.parametrize("config", ["openseg-st-v1m1-0-origin-pointpdf-v1m1-base",
                                    "incrseg-pt-v1-0-pointpdf-v1m1-base"])
def test_scannet_configs_data_match_jax(tmp_path, config, part):
    """The ScanNet configs of the ST and incremental slices, their train and
    val pipelines as shipped (random augmentations, grid sampling, crops,
    label masks or remaps) over a scene in the ScanNet layout: the port's
    items equal the JAX package's, bit for bit, from one seed of numpy's
    and Python's RNGs, at three seeds."""
    import random

    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        (tmp_path / split).mkdir()
        torch.save(_scannet_scene(rng, 3000), tmp_path / split / "scene0000_00.pth")
    root = __file__.rsplit("/tests/", 1)[0]
    cfg = Config.fromfile(f"{root}/configs/scannet/{config}.py").to_dict()["data"][part]
    cfg.update(data_root=str(tmp_path))
    for seed in range(3):
        random.seed(seed)
        np.random.seed(seed)
        got = DATASETS.build(copy.deepcopy(cfg))[0]
        random.seed(seed)
        np.random.seed(seed)
        _assert_items_equal(got, JAX_DATASETS.build(copy.deepcopy(cfg))[0],
                            f"{config} {part} seed {seed}")


# -- one OpenSegTrainer step ------------------------------------------------------------


ST_CFG = dict(
    copy.deepcopy(CFG),
    model=dict(type="DefaultSegmentor", backbone=dict(BACKBONE, num_classes=5),
               criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0,
                              ignore_index=-1)]),
    recognizer=dict(
        type="PointPdf-v1m1",
        recognizer=dict(type="ST-v1m1-Recognizer", up_k=3, channels=CHANNELS,
                        num_layers=4),
        criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
        loss_weight=0.01, step_loss_weight=False, num_classes=5, start_epoch=1,
        kp_ball_radius=0.1, kp_max_neighbor=8, condition_from="msp", beta=1.5,
        seed_from="ml", seed_range=0.05, num_seed=5, slide_window=True,
        pseudo_jobs=1),
    unknown_label=[4], train=dict(type="OpenSegTrainer"),
    # the shipped config's optimizer and schedule, at a rate where one AdamW
    # step (a move of ~lr per element, whatever the gradient's size) stays
    # inside the parameter tolerance even on gradient elements that are f32
    # noise in both packages (a bias ahead of a batch-statistic BatchNorm)
    optimizer=dict(type="AdamW", lr=4e-6, weight_decay=0.05),
    param_dicts=[dict(keyword="blocks", lr=4e-7)],
    scheduler=dict(type="MultiStepWithWarmupLR", milestones=[0.6, 0.8], gamma=0.1,
                   warmup_rate=0.5, warmup_scale=0.25))
# The JAX ST names its blocks ``layer{i}_block{d}``: the config's "blocks"
# matches none of its parameters, where the reference's (and the port's)
# ``layers.{l}.blocks.{d}`` put every block in the low-rate group.  The JAX
# step is given the keyword that picks the same parameters.
JAX_BLOCKS_KEYWORD = "_block"


def st_batch(seed=7, num_classes=5, n=1024):
    coord, feat, mask = cloud(seed, n=n, tail=n // 5)
    rng = np.random.RandomState(seed + 1)
    segment = rng.randint(0, num_classes, mask.shape).astype(np.int64)
    segment[~mask] = -1
    pseudo = np.where((rng.rand(*mask.shape) < 0.1) & (segment >= 0),
                      num_classes, segment)
    return dict(coord=coord, feat=feat, segment=segment, segment_pseudo=pseudo,
                count=mask.sum(1).astype(np.int32))


@contextlib.contextmanager
def knn_tie_gaps():
    """The list of ``knn_tie_gap`` of every kNN the port runs inside the
    block (``geometry.knn`` wherever a module took it)."""
    knn, gaps = geometry.knn, []

    def recording(query, ref, k, ref_mask=None):
        gaps.append(knn_tie_gap(
            query.detach().numpy(), ref.detach().numpy(), k,
            None if ref_mask is None else ref_mask.numpy()))
        return knn(query, ref, k, ref_mask=ref_mask)

    users = [m for m in list(sys.modules.values())
             if getattr(m, "__name__", "").startswith("pointcloudpdf_tpu_torch")
             and getattr(m, "knn", None) is knn]
    for m in users:
        m.knn = recording
    try:
        yield gaps
    finally:
        for m in users:
            m.knn = knn


def assert_st_gradients_close(grads, jgrads):
    """``assert_gradients_close`` with its bias rule carried over to the
    LayerNorms: a LayerNorm bias ahead of a Linear and a batch-statistic
    BatchNorm (the decoders' last ``norm1`` before the classifiers) has an
    exact gradient of 0, rounding noise on both sides, so it is held to the
    larger of its own and its LayerNorm scale's gradient."""
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, grads))
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    ln_bias = [p for p in ref if p.endswith("/bias") and p[:-4] + "scale" in ref]
    for path in ln_bias:
        scale = max(np.abs(ref[path]).max(), np.abs(ref[path[:-4] + "scale"]).max())
        err = np.abs(flat[path] - ref[path]).max()
        assert err <= GRADIENT_TOL * scale, (path, err, scale)
    return assert_gradients_close(
        unflatten_tree({p: v for p, v in flat.items() if p not in ln_bias}),
        unflatten_tree({p: v for p, v in ref.items() if p not in ln_bias}),
        "gradients")


@pytest.fixture(scope="module")
def exact_jax_paths():
    old = (jgeo.FORCE_KNN_PATH, stm.FUSED_ST_ATTENTION, stm.FUSED_KPCONV)
    jgeo.FORCE_KNN_PATH = "exact"
    stm.FUSED_ST_ATTENTION = stm.FUSED_KPCONV = "off"
    yield
    jgeo.FORCE_KNN_PATH, stm.FUSED_ST_ATTENTION, stm.FUSED_KPCONV = old


def test_st_open_seg_step_matches_jax(tmp_path, exact_jax_paths):
    """One joint ST step past ``start_epoch`` (recognizer loss on), drop
    path 0, from a perturbed shared start: the low-rate group holds the same
    parameters in both packages (every attention block, nothing else) at a
    tenth of the rate, and the step's rate is the warm-up's; loss, seg_loss
    and loss_rec within 1e-4 relative; every backbone and recognizer
    gradient as ``assert_gradients_close`` holds it; parameters and
    BatchNorm running statistics within 1e-4 of each tensor's max |value|;
    the move of every parameter element whose gradient is clear of noise
    (Adam's step ~ lr x sign) equal to the JAX move within 2% of the
    group's rate and two float32 spacings of the parameter."""
    cfg = dict(copy.deepcopy(ST_CFG), save_path=str(tmp_path))
    jcfg = copy.deepcopy(cfg)
    jcfg["param_dicts"] = [dict(cfg["param_dicts"][0], keyword=JAX_BLOCKS_KEYWORD)]
    jtrainer = JAX_TRAINERS.build(dict(type="OpenSegTrainer", cfg=JaxConfig(jcfg)))
    trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=Config(cfg)))
    record_gradients(jtrainer)
    np_batch = st_batch()
    jbatch = jtrainer.device_batch(np_batch)
    jtrainer.initialize_state(jbatch)
    start = perturbed_start(jtrainer, seed=6)
    for name, module in trainer.modules().items():
        module.load_state_dict(jax_to_state_dict(
            {k: start[k][name] for k in start}), strict=True)

    # the groups: port names through the bridge against the JAX labels
    low = {id(p) for p in trainer.optimizer.param_groups[1]["params"]}
    jax_low = {path for path in flatten_tree(start["params"])
               if JAX_BLOCKS_KEYWORD in path}
    mapped, port_low = set(), []
    for name, module in trainer.modules().items():
        sub = {n: p for n, p in module.named_parameters() if id(p) in low}
        port_low += list(sub)
        if sub:
            mapped |= {f"{name}/{path}"
                       for path in flatten_tree(state_dict_to_jax(sub)["params"])}
    assert mapped == jax_low and len(jax_low) > 0
    assert all(".blocks." in pname for pname in port_low)

    rec_w = trainer.recognizer.loss_weight(1)
    assert rec_w == pytest.approx(0.01)
    jtrainer.state, jout = jtrainer._train_step(
        jtrainer.state, jbatch, jax.random.PRNGKey(0), jnp.asarray(rec_w, jnp.float32))
    batch = trainer.device_batch(np_batch)
    with knn_tie_gaps() as gaps:
        grads = port_gradients(trainer, lambda: trainer._dispatch_train(batch, rec_w))
    # the JAX kNN forms d^2 by the matmul identity: no near-tie may decide a
    # neighbour set
    assert len(gaps) > 10 and min(gaps) >= 5e-7
    lr = trainer.comm_info["lr"]
    assert lr == pytest.approx(float(jtrainer.scheduler(0)), rel=1e-12)
    assert lr == pytest.approx(4e-6 * 0.25)
    assert [g["lr"] for g in trainer.optimizer.param_groups] == pytest.approx(
        [lr, lr * 0.1])
    out = trainer.comm_info["model_output_dict"]
    for key in ("loss", "seg_loss", "loss_rec"):
        assert float(out[key]) == pytest.approx(float(jout[key]), rel=1e-4), key
    jgrads = recorded_gradients(jtrainer)
    print("gradients port-JAX: worst tensor %.3e, whole %.3e"
          % assert_st_gradients_close(grads, jgrads))
    state = trainer.state_dict()
    assert_trees_close(state["params"], jtrainer.state.params, 1e-4, "params")
    assert_trees_close(state["batch_stats"], jtrainer.state.batch_stats, 1e-4,
                       "batch_stats")

    got, ref = flatten_tree(state["params"]), flatten_tree(
        jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    first, jg = flatten_tree(start["params"]), flatten_tree(
        jax.tree_util.tree_map(np.asarray, jgrads))
    checked = 0
    for path, g in jg.items():
        rate = lr * (0.1 if path in jax_low else 1.0)
        # a bias's gradient against its layer's (a bias ahead of a
        # batch-statistic norm has a gradient of noise alone)
        scale = max([np.abs(g).max()] + [
            np.abs(jg[path[:-4] + s]).max() for s in ("kernel", "scale")
            if path.endswith("/bias") and path[:-4] + s in jg])
        clear = np.abs(g) > 1e-2 * scale
        d_port = (got[path] - first[path])[clear]
        d_jax = (ref[path] - first[path])[clear]
        # and two float32 spacings of the parameter: the move is rounded
        ulp = np.spacing(np.abs(first[path][clear]))
        assert (np.abs(d_port - d_jax) <= 0.02 * rate + 2 * ulp).all(), path
        checked += int(clear.sum())
    assert checked > 1000


# -- the drop-path generator -------------------------------------------------------------


@pytest.mark.parametrize("trainer_type", ["DefaultTrainer", "OpenSegTrainer"])
def test_drop_path_steps_follow_the_seed(tmp_path, trainer_type):
    """Drop path 0.3 in training: two trainers with one seed take bit-equal
    steps from one start (losses and every parameter), a third with another
    seed does not; the global RNG's state is the same after the steps as
    before; the generator is on the trainer's device, seeded from (seed,
    step)."""
    cfg = copy.deepcopy(ST_CFG)
    cfg["model"]["backbone"]["drop_path_rate"] = 0.3
    cfg.update(save_path=str(tmp_path), optimizer=dict(type="AdamW", lr=1e-3,
                                                       weight_decay=0.05))
    if trainer_type == "DefaultTrainer":
        cfg.pop("recognizer")
    np_batch = st_batch()
    runs = []
    global_state = torch.random.get_rng_state()
    for seed in (3, 3, 4):
        torch.manual_seed(0)
        trainer = TRAINERS.build(dict(type=trainer_type,
                                      cfg=Config(dict(cfg, seed=seed))))
        assert trainer.generator.device == trainer.device
        batch = trainer.device_batch(np_batch)
        global_state = torch.random.get_rng_state()
        losses = []
        for _ in range(2):
            if trainer_type == "OpenSegTrainer":
                trainer._dispatch_train(batch, 0.01)
            else:
                trainer._dispatch_train(batch)
            losses.append(float(trainer.comm_info["model_output_dict"]["loss"]))
        assert torch.equal(torch.random.get_rng_state(), global_state)
        assert trainer.generator.initial_seed() == step_seed(seed, 1)
        runs.append((losses, {k: v.clone() for k, v in trainer.model.state_dict().items()}))
    (loss_a, sd_a), (loss_b, sd_b), (loss_c, sd_c) = runs
    assert loss_a == loss_b
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    assert loss_a != loss_c
    assert any(not torch.equal(sd_a[k], sd_c[k]) for k in sd_a)


# -- the shipped configs' optimizer ------------------------------------------------------


@pytest.mark.parametrize("dataset", ["s3dis", "scannet"])
def test_shipped_st_config_optimizer(dataset):
    """The shipped ST open-set configs build their optimizer in the port:
    AdamW at 0.006 with weight decay 0.05, the attention blocks at a tenth
    of the rate.  The S3DIS config inherits the PT-v1 config's SGD
    ``momentum`` into its AdamW dict; AdamW takes none, the port drops it
    (the ScanNet config has none), where the JAX package's ``AdamW`` raises,
    so the JAX trainer cannot train that config."""
    from pointcloudpdf_tpu.utils.optimizer import build_optimizer as jax_build_optimizer
    from pointcloudpdf_tpu_torch.utils.optimizer import build_optimizer

    root = __file__.rsplit("/tests/", 1)[0]
    path = f"{root}/configs/{dataset}/openseg-st-v1m1-0-origin-pointpdf-v1m1-base.py"
    cfg = Config.fromfile(path)
    named = [("backbone.layers.0.blocks.0.attn.qkv.weight", torch.nn.Parameter(torch.ones(3))),
             ("backbone.classifier.0.weight", torch.nn.Parameter(torch.ones(3)))]
    opt = build_optimizer(dict(cfg.optimizer), named, param_dicts=cfg.param_dicts)
    assert isinstance(opt, torch.optim.AdamW)
    assert [(g["lr"], g["weight_decay"], len(g["params"])) for g in opt.param_groups] == [
        (0.006, 0.05, 1), (pytest.approx(0.0006), 0.05, 1)]
    jcfg = JaxConfig.fromfile(path)
    if dataset == "s3dis":
        assert dict(cfg.optimizer)["momentum"] == 0.9
        with pytest.raises(TypeError, match="momentum"):
            jax_build_optimizer(dict(jcfg.optimizer))
    else:
        assert "momentum" not in dict(cfg.optimizer)
        jax_build_optimizer(dict(jcfg.optimizer))
