"""The port's OpenSegTester / SemSegTester against the JAX OpenSegTester on
the same pickled JAX checkpoint (BatchNorm statistics randomised), over a
tiny synthetic scene in the S3DIS on-disk layout.  Both run in-process;
the port with ``device="cpu"``, as asked for by name.  The PT-v1 pair is
built through the tester registry; the Stratified Transformer pair runs
the port through ``tools/test_torch.py --device cpu`` on a config file, and
the PT-v2 pair runs both tools, the JAX ``tools/test.py`` and the port's
``tools/test_torch.py --device cpu``, on a closed-set config.
"""

import copy
import functools
import logging
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.recognizers import build_recognizer as jax_build_recognizer
from pointcloudpdf_tpu.utils.checkpoint import save_checkpoint
from pointcloudpdf_tpu_torch.utils.config import Config as PortConfig

from test_torch_layer import randomise_bn
from test_torch_model import MODEL, RECOGNIZER
from test_torch_st import MODEL as ST_MODEL, RECOGNIZER as ST_RECOGNIZER

torch.set_num_threads(1)

NAMES = ["ceiling", "floor", "wall", "beam", "column", "window", "door",
         "table", "chair", "sofa", "bookcase", "board", "clutter"]


def _cfg_dict(data_root, weight, save_path, model=MODEL, recognizer=RECOGNIZER):
    return dict(
        save_path=save_path, weight=weight, unknown_label=[5, 9],
        model=copy.deepcopy(model), recognizer=copy.deepcopy(recognizer),
        data=dict(
            num_classes=13, ignore_index=-1, names=NAMES,
            test=dict(
                type="S3DISDataset", split="Area_5", data_root=data_root,
                transform=[dict(type="CenterShift", apply_z=True),
                           dict(type="NormalizeColor", mode="zeroOne")],
                test_mode=True,
                test_cfg=dict(
                    voxelize=dict(type="GridSample", grid_size=0.08,
                                  hash_type="fnv", mode="test",
                                  keys=("coord", "color"),
                                  return_grid_coord=True),
                    crop=None,
                    post_transform=[
                        dict(type="CenterShift", apply_z=False),
                        dict(type="ToTensor"),
                        dict(type="Collect", keys=("coord", "grid_coord", "index"),
                             feat_keys=("coord", "color")),
                    ],
                    aug_transform=[[dict(type="RandomScale", scale=[0.9, 0.9])],
                                   [dict(type="RandomScale", scale=[1, 1])]],
                ),
            ),
        ),
    )


def _make_setup(root, model, recognizer, n_init, head=None, scene_seed=0):
    """The scene on disk, a seeded JAX checkpoint of ``model`` + ``recognizer``
    (initialised on ``n_init`` points) and the JAX OpenSegTester's results.
    With ``head`` = (intermediate, Dense, BatchNorm, Dense) of the backbone's
    classifier, that BatchNorm's running statistics are set to what the
    intermediate really has and the last Dense is redrawn (sigma 0.3), so
    that the classes compete and the argmax says something."""
    rng = np.random.RandomState(scene_seed)
    data_root = root / "s3dis"
    os.makedirs(data_root / "Area_5")
    n = 1500
    coord = (rng.rand(n, 3) * np.array([2.0, 1.6, 1.0])).astype(np.float32)
    color = (rng.rand(n, 3) * 255).astype(np.float32)
    seg = (np.floor(coord[:, 0] * 3) + 3 * np.floor(coord[:, 1] * 2)).astype(np.int64) % 13
    np.savez(data_root / "Area_5" / "office_1.npz", coord=coord, color=color,
             semantic_gt=seg, instance_gt=np.zeros_like(seg))

    old = jgeo.FORCE_KNN_PATH
    jgeo.FORCE_KNN_PATH = "exact"
    try:
        batch = dict(coord=jnp.asarray(rng.rand(1, n_init, 3).astype(np.float32)),
                     feat=jnp.asarray(rng.rand(1, n_init, 6).astype(np.float32)),
                     mask=jnp.ones((1, n_init), bool))
        jm = jax_build_model(model)
        v = jax.jit(functools.partial(jm.init, train=False))(
            {"params": jax.random.PRNGKey(0)}, batch)
        out = jax.jit(functools.partial(jm.apply, train=False))(v, batch)
        rv = jax.jit(functools.partial(
            jax_build_recognizer(recognizer).model.init, train=False))(
            {"params": jax.random.PRNGKey(1)}, out["intermediates"])
        v = randomise_bn(jax.tree_util.tree_map(np.array, dict(v)), rng)
        if head is not None:
            inter, fc1, bn, fc2 = head
            feat = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
                v, batch)["intermediates"][inter][0][0])
            params = v["params"]["backbone_module"]
            y = feat @ params[fc1]["kernel"] + params[fc1]["bias"]
            stats = v["batch_stats"]["backbone_module"][bn]
            stats["mean"][...] = y.mean(0)
            stats["var"][...] = y.var(0)
            params[fc2]["kernel"][...] = 0.3 * rng.standard_normal(
                params[fc2]["kernel"].shape)
        rv = randomise_bn(jax.tree_util.tree_map(np.array, dict(rv)), rng)
        weight = str(root / "model.pth")
        save_checkpoint(weight, {"epoch": 1, "state": {
            "params": {"model": v["params"], "recognizer": rv["params"]},
            "batch_stats": {"model": v["batch_stats"],
                            "recognizer": rv["batch_stats"]}}})

        from pointcloudpdf_tpu.engines.test import TESTERS as JAX_TESTERS
        from pointcloudpdf_tpu.utils.config import Config

        jax_save = str(root / "jax_exp")
        cfg = Config(_cfg_dict(str(data_root), weight, jax_save, model, recognizer))
        os.makedirs(jax_save)
        JAX_TESTERS.build(dict(type="OpenSegTester", cfg=cfg)).test()
    finally:
        jgeo.FORCE_KNN_PATH = old
    return dict(root=root, data_root=str(data_root), weight=weight,
                jax_result=os.path.join(jax_save, "result"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return _make_setup(tmp_path_factory.mktemp("torch_tester"), MODEL,
                       RECOGNIZER, 256)


def _port_run(setup, tester_type, name):
    from pointcloudpdf_tpu_torch.engines.test import TESTERS

    save = str(setup["root"] / name)
    cfg = PortConfig(_cfg_dict(setup["data_root"], setup["weight"], save))
    cfg.device = "cpu"
    os.makedirs(save)
    TESTERS.build(dict(type=tester_type, cfg=cfg)).test()
    return os.path.join(save, "result")


def test_open_seg_tester_matches_jax(setup):
    """pred.npy >= 99.9% equal entries, score.npy within 1e-4."""
    result = _port_run(setup, "OpenSegTester", "port_open")
    pred = np.load(os.path.join(result, "office_1_pred.npy"))
    score = np.load(os.path.join(result, "office_1_score.npy"))
    jpred = np.load(os.path.join(setup["jax_result"], "office_1_pred.npy"))
    jscore = np.load(os.path.join(setup["jax_result"], "office_1_score.npy"))
    assert pred.shape == jpred.shape == (1500,)
    assert (pred == jpred).mean() >= 0.999
    np.testing.assert_allclose(score, jscore, atol=1e-4)


def test_st_through_test_tool_matches_jax(tmp_path):
    """``tools/test_torch.py --device cpu`` on a small Stratified Transformer
    config (ST-v1m1 + ST recognizer, the unfused exact JAX paths on the
    other side): pred.npy >= 99.9% equal entries, score.npy within 1e-4.

    The scene must be one where no kNN of the forward has a near-tie at
    its k-th neighbour, which is asserted over every kNN the port's run
    makes.  The JAX kNN's distances come from the matmul identity and carry
    ~1e-7 of absolute noise, so on a closer tie it picks the other
    neighbour: on seed 0 one TransitionDown group of the last fragment
    differs by one point, and 9 of 1500 scores by up to 1.1e-3."""
    from pointcloudpdf_tpu.models.stratified_transformer import st as stm
    from pointcloudpdf_tpu_torch.models.stratified_transformer import st as port_st
    from pointcloudpdf_tpu_torch.ops import geometry as port_geometry
    from test_torch_st import knn_tie_gap

    old = (stm.FUSED_ST_ATTENTION, stm.FUSED_KPCONV)
    stm.FUSED_ST_ATTENTION = stm.FUSED_KPCONV = "off"
    try:
        setup = _make_setup(tmp_path, ST_MODEL, ST_RECOGNIZER, 1024, head=("dec0", "cls_fc1", "cls_bn", "cls_fc2"),
                            scene_seed=9)
    finally:
        stm.FUSED_ST_ATTENTION, stm.FUSED_KPCONV = old
    save = str(tmp_path / "port_st")
    cfg = dict(_cfg_dict(setup["data_root"], setup["weight"], save, ST_MODEL,
                         ST_RECOGNIZER),
               test=dict(type="OpenSegTester"), seed=0, epoch=1, eval_epoch=1)
    config = str(tmp_path / "openseg-st-small.py")
    with open(config, "w") as f:
        f.write("".join(f"{key} = {value!r}\n" for key, value in cfg.items()))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port_knn, gaps = port_geometry.knn, []

    def recording_knn(query, ref, k, ref_mask=None):
        gaps.append(knn_tie_gap(query, ref, k, ref_mask))
        return port_knn(query, ref, k, ref_mask)

    old_argv = sys.argv
    sys.argv = ["tools/test_torch.py", "--config-file", config, "--device", "cpu"]
    port_geometry.knn = port_st.knn = recording_knn
    try:
        runpy.run_path(os.path.join(root, "tools", "test_torch.py"),
                       run_name="__main__")
    finally:
        sys.argv = old_argv
        port_geometry.knn = port_st.knn = port_knn
    # measured 1.05e-6 over this scene's 112 kNNs; the scene of seed 0
    # (6.9e-8 over its 128) falls below the floor
    assert len(gaps) >= 16 and min(gaps) >= 5e-7, (len(gaps), min(gaps))
    pred = np.load(os.path.join(save, "result", "office_1_pred.npy"))
    score = np.load(os.path.join(save, "result", "office_1_score.npy"))
    jpred = np.load(os.path.join(setup["jax_result"], "office_1_pred.npy"))
    jscore = np.load(os.path.join(setup["jax_result"], "office_1_score.npy"))
    assert pred.shape == jpred.shape == (1500,)
    assert (pred == jpred).mean() >= 0.999
    np.testing.assert_allclose(score, jscore, atol=1e-4)
    assert len(np.unique(jpred)) > 3 and jscore.std() > 0


PTV2_MODEL = dict(
    type="DefaultSegmentor",
    backbone=dict(
        type="PT-v2m2", in_channels=6, num_classes=13, patch_embed_depth=1,
        patch_embed_channels=16, patch_embed_groups=2, patch_embed_neighbours=8,
        enc_depths=(1, 1, 1), enc_channels=(16, 32, 32), enc_groups=(2, 4, 4),
        enc_neighbours=(8, 8, 8), dec_depths=(1, 1, 1), dec_channels=(16, 16, 32),
        dec_groups=(2, 2, 4), dec_neighbours=(8, 8, 8), grid_sizes=(0.2, 0.4, 0.8),
        pe_multiplier=False, pe_bias=True, level_capacity_factor=0.5),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])


def test_ptv2_through_test_tool_matches_jax(tmp_path, monkeypatch):
    """The JAX ``tools/test.py`` (unfused grouped vector attention, exact
    kNN) and the port's ``tools/test_torch.py --device cpu`` on one small
    PT-v2m2 config and one closed-set JAX checkpoint (``SemSegTester``):
    pred.npy equal, the same mIoU/mAcc/allAcc line, and no point dropped by
    the pooling capacity on the port's side.  The scene is free of kNN
    near-ties (asserted over every kNN the port's run makes)."""
    from pointcloudpdf_tpu.engines import defaults as jax_defaults
    from pointcloudpdf_tpu.models.point_transformer_v2 import ptv2 as jptv2
    from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2 as port_ptv2
    from test_torch_st import knn_tie_gap

    monkeypatch.setattr(jgeo, "FORCE_KNN_PATH", "exact")
    monkeypatch.setattr(jptv2, "FUSED_GVA", "off")
    # the JAX tool's persistent compile cache would outlive this test
    monkeypatch.setattr(jax_defaults, "enable_compile_cache", lambda *a, **k: None)
    rng = np.random.RandomState(3)
    data_root = tmp_path / "s3dis"
    os.makedirs(data_root / "Area_5")
    n = 1500
    coord = (rng.rand(n, 3) * np.array([2.0, 1.6, 1.0])).astype(np.float32)
    color = (rng.rand(n, 3) * 255).astype(np.float32)
    seg = (np.floor(coord[:, 0] * 3) + 3 * np.floor(coord[:, 1] * 2)).astype(np.int64) % 13
    np.savez(data_root / "Area_5" / "office_1.npz", coord=coord, color=color,
             semantic_gt=seg, instance_gt=np.zeros_like(seg))
    # weights initialised on a cloud like a fragment of the scene (centred
    # coords, colours in [0, 1]); then the classifier's BatchNorm takes the
    # statistics its input really has there and its last Dense is redrawn
    # (sigma 0.3), so that the classes compete and the argmax says something
    part = (rng.rand(1, 512, 3) * [2.0, 1.6, 1.0] - [1.0, 0.8, 0.0]).astype(np.float32)
    batch = dict(coord=jnp.asarray(part),
                 feat=jnp.asarray(np.concatenate([part, rng.rand(1, 512, 3)], -1),
                                  jnp.float32),
                 mask=jnp.ones((1, 512), bool))
    jm = jax_build_model(PTV2_MODEL)
    v = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.PRNGKey(0)}, batch)
    v = randomise_bn(jax.tree_util.tree_map(np.array, dict(v)), rng)
    _, inter = jax.jit(functools.partial(jm.apply, train=False,
                                         capture_intermediates=True,
                                         mutable=["intermediates"]))(v, batch)
    head = np.asarray(inter["intermediates"]["backbone_module"]["seg_fc1"]["__call__"][0][0])
    stats = v["batch_stats"]["backbone_module"]["seg_bn"]
    stats["mean"][...] = head.mean(0)
    stats["var"][...] = head.var(0)
    fc2 = v["params"]["backbone_module"]["seg_fc2"]["kernel"]
    fc2[...] = 0.3 * rng.standard_normal(fc2.shape)
    weight = str(tmp_path / "model.pth")
    save_checkpoint(weight, {"epoch": 1, "state": {"params": v["params"],
                                                   "batch_stats": v["batch_stats"]}})

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    saves, logged = {}, {}
    for name, tool, extra in (("jax", "test.py", []),
                              ("port", "test_torch.py", ["--device", "cpu"])):
        saves[name] = str(tmp_path / f"{name}_exp")
        cfg = dict(_cfg_dict(str(data_root), weight, saves[name], PTV2_MODEL, None),
                   test=dict(type="SemSegTester"), seed=0, epoch=1, eval_epoch=1,
                   batch_size=1)
        config = str(tmp_path / f"semseg-pt-v2m2-small-{name}.py")
        with open(config, "w") as f:
            f.write("".join(f"{key} = {value!r}\n" for key, value in cfg.items()
                            if key not in ("recognizer", "unknown_label")))
        monkeypatch.setattr(sys, "argv", [f"tools/{tool}", "--config-file", config,
                                          *extra])
        if name == "port":
            port_knn, gaps = port_ptv2.knn, []

            def recording_knn(query, ref, k, ref_mask=None):
                gaps.append(knn_tie_gap(query, ref, k, ref_mask))
                return port_knn(query, ref, k, ref_mask)

            monkeypatch.setattr(port_ptv2, "knn", recording_knn)
            port_ptv2.capacity_dropped_points(reset=True)
        # a package's logger is made once a process, with the log file of its
        # first run: read what this run logs through a handler of its own
        logger = logging.getLogger({"jax": "pointcloudpdf_tpu",
                                    "port": "pointcloudpdf_tpu_torch"}[name])
        handler, logged[name] = logging.Handler(), []
        handler.emit = lambda record, out=logged[name]: out.append(record.getMessage())
        logger.addHandler(handler)
        try:
            runpy.run_path(os.path.join(root, "tools", tool), run_name="__main__")
        finally:
            logger.removeHandler(handler)
    assert port_ptv2.capacity_dropped_points(reset=True) == 0
    assert len(gaps) >= 8 and min(gaps) >= 5e-7, (len(gaps), min(gaps))

    pred = np.load(os.path.join(saves["port"], "result", "office_1_pred.npy"))
    jpred = np.load(os.path.join(saves["jax"], "result", "office_1_pred.npy"))
    assert pred.shape == jpred.shape == (1500,)
    np.testing.assert_array_equal(pred, jpred)
    assert len(np.unique(jpred)) > 3
    lines = {name: [m for m in msgs if m.startswith("Val result: mIoU/mAcc/allAcc")]
             for name, msgs in logged.items()}
    assert len(lines["port"]) == 1 and lines["port"] == lines["jax"]


def test_sem_seg_tester_matches_jax_votes(setup):
    """The closed-set tester votes the same seg logits: same predictions."""
    result = _port_run(setup, "SemSegTester", "port_sem")
    pred = np.load(os.path.join(result, "office_1_pred.npy"))
    jpred = np.load(os.path.join(setup["jax_result"], "office_1_pred.npy"))
    assert (pred == jpred).mean() >= 0.999
    assert os.path.isfile(os.path.join(result, "Area_5.pickle"))


def test_tester_asked_for_cuda_raises_without_it(setup, tmp_path):
    """No silent CPU: a run that asks for CUDA where there is none fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pointcloudpdf_tpu_torch.engines.test import TESTERS

    cfg = PortConfig(_cfg_dict(setup["data_root"], setup["weight"],
                               str(tmp_path / "exp")))
    cfg.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TESTERS.build(dict(type="OpenSegTester", cfg=cfg))
