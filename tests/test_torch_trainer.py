"""The port's trainer as a whole on the CPU, through its entry points:
``tools/train_torch.py --device cpu`` on a synthetic S3DIS tree for two
short epochs (the second past ``recognizer.start_epoch``, so it runs the
pseudo-label pipeline and the recognizer loss), then
``tools/test_torch.py --device cpu`` on the checkpoint it wrote, then a
resumed run; and ``tools/train_torch.py --device cpu`` on the S3DIS PT-v2m2
Lovasz config at small widths with ``PreciseEvaluator`` in the hooks.  Follows tests/test_openseg.py and tests/test_engine.py of
the JAX package; imports nothing of JAX.
"""

import contextlib
import logging
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2
from pointcloudpdf_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CONFIG = '''
_base_ = [{base!r}]
batch_size = 2
num_worker = 0
mix_prob = 0.0
enable_amp = False
seed = 7
unknown_label = [3]
model = dict(
    type="DefaultSegmentor",
    backbone=dict(type="PointTransformer-Seg26", in_channels=6, num_classes=4),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
)
recognizer = dict(
    type="PointPdf-v1m1",
    recognizer=dict(type="PointTransformer-Recognizer"),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
    loss_weight=0.01, step_loss_weight=False, num_classes=4, start_epoch=1,
    kp_ball_radius=0.25, kp_max_neighbor=8, condition_from="msp", beta=1.5,
    seed_from="ml", seed_range=0.05, num_seed=5, slide_window=True,
    pseudo_jobs=1,
)
epoch = 2
eval_epoch = 2
optimizer = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=0.0001)
scheduler = dict(type="MultiStepLR", milestones=[0.6, 0.8], gamma=0.1)
_train_tf = [
    dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
         keys=("coord", "color", "segment"), return_grid_coord=True),
    dict(type="NormalizeColor", mode="zeroOne"),
    dict(type="MaskLabel", mask_label=unknown_label),
    dict(type="ToTensor"),
    dict(type="Collect", keys=("coord", "grid_coord", "segment", "segment_known"),
         feat_keys=("coord", "color")),
]
data = dict(
    num_classes=4, ignore_index=-1, names=["a", "b", "c", "unk"],
    train=dict(type="S3DISDataset", split="Area_1", data_root={data_root!r},
               transform=_train_tf, test_mode=False),
    val=dict(type="S3DISDataset", split="Area_5", data_root={data_root!r},
             transform=_train_tf, test_mode=False),
    test=dict(
        type="S3DISDataset", split="Area_5", data_root={data_root!r},
        transform=[dict(type="NormalizeColor", mode="zeroOne")],
        test_mode=True, unknown_label=unknown_label,
        test_cfg=dict(
            voxelize=dict(type="GridSample", grid_size=0.05, hash_type="fnv",
                          mode="test", keys=("coord", "color"),
                          return_grid_coord=True),
            crop=None,
            post_transform=[
                dict(type="ToTensor"),
                dict(type="Collect", keys=("coord", "grid_coord", "index"),
                     feat_keys=("coord", "color")),
            ],
            aug_transform=[[dict(type="RandomScale", scale=[1, 1])]],
        ),
    ),
)
'''


def _scene(rng, n):
    coord = rng.rand(n, 3).astype(np.float32)
    seg = ((coord[:, 0] > 0.5).astype(np.int64) * 2
           + (coord[:, 1] > 0.5).astype(np.int64))
    color = (rng.rand(n, 3) * 60 + seg[:, None] * 60).astype(np.float32)
    return dict(coord=coord, color=color, semantic_gt=seg,
                instance_gt=np.zeros_like(seg))


@contextlib.contextmanager
def _captured_log():
    """The messages of the port's root logger.  (It is made once a process,
    so a run's ``train.log`` exists only if that run was the first to ask
    for the logger.)"""
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("pointcloudpdf_tpu_torch")
    logger.addHandler(handler)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)


def _run_tool(tool, argv):
    """Run an entry point of tools/ in this process; returns its log."""
    old = sys.argv
    sys.argv = [tool, *argv]
    try:
        with _captured_log() as lines:
            runpy.run_path(os.path.join(ROOT, "tools", tool), run_name="__main__")
    finally:
        sys.argv = old
    return "\n".join(lines)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer")
    rng = np.random.RandomState(0)
    data_root = root / "s3dis"
    for area, count in (("Area_1", 8), ("Area_5", 2)):
        os.makedirs(data_root / area)
        for i in range(count):
            np.savez(data_root / area / f"room_{i}.npz",
                     **_scene(rng, int(rng.uniform(300, 420))))
    config = root / "openseg-seg26.py"
    config.write_text(_CONFIG.format(
        base=os.path.join(ROOT, "configs", "_base_", "openseg_runtime.py"),
        data_root=str(data_root)))
    save = str(root / "exp")
    log = _run_tool("train_torch.py", ["--config-file", str(config), "--device",
                                       "cpu", "--options", f"save_path={save}"])
    return dict(root=root, config=str(config), save=save, log=log)


def _epoch_losses(log, key="loss"):
    return [float(m) for m in re.findall(
        rf"Train result: \[\d+/\d+\] .*?\b{key}: ([0-9.eE+-]+)", log)]


def test_train_cli_loss_falls_and_recognizer_trains(run):
    log = run["log"]
    seg = _epoch_losses(log, "seg_loss")
    assert len(seg) == 2 and seg[1] < seg[0], seg
    assert all(np.isfinite(float(v)) for v in re.findall(r" loss: ([0-9.naif+-]+)", log))
    # the second epoch is past start_epoch: pseudo-labels and recognizer loss
    assert "pseudo_flagged:" in log and "loss_rec:" in log


def test_train_cli_evaluator_reports_and_saves(run):
    log = run["log"]
    assert len(re.findall(r"Val result: mIoU/mAcc/allAcc", log)) == 2
    assert len(re.findall(r"Val result: aupr/auroc", log)) == 2
    model_dir = os.path.join(run["save"], "model")
    assert os.path.isfile(os.path.join(model_dir, "model_last.pth"))
    assert os.path.isfile(os.path.join(model_dir, "model_best_mIoU.pth"))
    payload = load_checkpoint(os.path.join(model_dir, "model_last.pth"))
    assert payload["epoch"] == 2
    state = payload["state"]
    # the JAX package's checkpoint keys
    assert set(state) == {"params", "batch_stats", "opt_state", "step"}
    assert set(state["params"]) == {"model", "recognizer"}
    assert "backbone_module" in state["params"]["model"]
    assert state["step"] == 8  # 2 epochs x 4 iterations


def test_test_cli_loads_the_trainers_checkpoint(run):
    save = str(run["root"] / "exp_test")
    weight = os.path.join(run["save"], "model", "model_last.pth")
    log = _run_tool("test_torch.py", [
        "--config-file", run["config"], "--device", "cpu",
        "--options", f"save_path={save}", f"weight={weight}"])
    assert "Val result: mIoU/mAcc/allAcc" in log
    assert "Val result: aupr/auroc" in log
    pred = np.load(os.path.join(save, "result", "room_0_pred.npy"))
    assert pred.min() >= 0 and pred.max() < 4


def test_resume_restores_step_and_optimizer_state(run):
    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS

    weight = os.path.join(run["save"], "model", "model_last.pth")
    saved = load_checkpoint(weight)
    cfg = default_config_parser(run["config"], {
        "save_path": str(run["root"] / "exp_resume"), "weight": weight,
        "resume": True, "epoch": 3, "eval_epoch": 3, "device": "cpu",
        "evaluate": False})
    os.makedirs(cfg.save_path, exist_ok=True)
    trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=cfg))
    trainer._call_hooks("before_train")  # OpenSegCheckpointLoader
    assert trainer.start_epoch == 2 and trainer._host_step == 8
    assert set(trainer.best_metric_value) == {"mIoU", "aupr", "auroc"}
    state = trainer.state_dict()
    a = saved["state"]["params"]["model"]["backbone_module"]["cls2"]["kernel"]
    b = state["params"]["model"]["backbone_module"]["cls2"]["kernel"]
    np.testing.assert_array_equal(a, b)
    bufs = [s["momentum_buffer"] for s in state["opt_state"]["state"].values()]
    want = [s["momentum_buffer"]
            for s in saved["state"]["opt_state"]["state"].values()]
    assert len(bufs) == len(want) > 0
    for x, y in zip(bufs, want):
        np.testing.assert_array_equal(x, y)
    trainer.train()  # the third epoch
    assert trainer.epoch + 1 == 3 and trainer._host_step == 12


def test_trainer_asked_for_cuda_raises_without_it(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run_tool("train_torch.py", ["--config-file", run["config"],
                                     "--options", f"save_path={run['root'] / 'exp_cuda'}"])


def test_more_cuda_ranks_than_cards_raises(run):
    """``--num-gpus 2 --device cuda`` on a machine with fewer cards raises:
    NCCL takes one card a rank (only ``launch``'s explicit gloo shares
    one)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _run_tool("train_torch.py", [
            "--config-file", run["config"], "--device", "cuda", "--num-gpus", "2",
            "--options", f"save_path={run['root'] / 'exp_two_cuda'}"])


# -- PT-v2 through tools/train_torch.py, with PreciseEvaluator ------------------------------------------------

_PTV2_CONFIG = '''
_base_ = [{base!r}]
batch_size = 2
num_worker = 0
enable_amp = False
seed = 5
epoch = 1
eval_epoch = 1
model = dict(backbone=dict(
    patch_embed_depth=1, patch_embed_channels=16, patch_embed_groups=2,
    patch_embed_neighbours=8, enc_depths=(1, 1, 1), enc_channels=(16, 32, 32),
    enc_groups=(2, 4, 4), enc_neighbours=(8, 8, 8), dec_channels=(16, 16, 32),
    dec_groups=(2, 2, 4), dec_neighbours=(8, 8, 8), grid_sizes=(0.1, 0.2, 0.4)))
hooks = [
    dict(type="CheckpointLoader"),
    dict(type="IterationTimer", warmup_iter=2),
    dict(type="InformationWriter"),
    dict(type="SemSegEvaluator"),
    dict(type="CheckpointSaver", save_freq=None),
    dict(type="PreciseEvaluator", test_last=False),
]
data = dict(
    train=dict(split="Area_1", data_root={data_root!r}),
    val=dict(data_root={data_root!r}),
    test=dict(data_root={data_root!r}),
)
'''


def surface_room(rng, n):
    """A 1 m box scanned on its floor and four walls (n points; the label
    is the surface), at the density of an S3DIS scan after the 0.04 grid:
    the level capacities at 0.5 assume surfaces, where a voxel of 0.1
    merges several points, and drop points of a volume filled at random."""
    face = rng.randint(0, 5, n)
    uv = rng.rand(n, 2)
    coord = np.zeros((n, 3), np.float32)
    coord[face == 0] = np.c_[uv[face == 0], np.zeros((face == 0).sum())]
    for f, (axis, side) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)), start=1):
        sel = face == f
        other = [a for a in range(3) if a != axis]
        coord[np.ix_(sel, other)] = uv[sel]
        coord[sel, axis] = side
    color = (rng.rand(n, 3) * 60 + face[:, None] * 40).astype(np.float32)
    return dict(coord=coord, color=color, semantic_gt=face.astype(np.int64),
                instance_gt=np.zeros(n, np.int64))


def test_train_cli_with_precise_evaluator(tmp_path):
    """``tools/train_torch.py --device cpu`` on the shipped S3DIS PT-v2m2
    Lovasz config at small widths, as shipped otherwise (Mix3D at 0.8,
    drop path 0.3, level capacity 0.5, AdamW, MultiStepLR): an epoch of two
    steps and the evaluator, then ``PreciseEvaluator`` runs the
    ``SemSegTester`` in-process on ``model_best.pth`` and writes a
    prediction for every point of the val room; no point dropped by the
    pooling capacity in any forward."""
    rng = np.random.RandomState(0)
    data_root = tmp_path / "s3dis"
    sizes = {}
    for area, count in (("Area_1", 4), ("Area_5", 1)):
        os.makedirs(data_root / area)
        for i in range(count):
            scene = surface_room(rng, int(rng.uniform(2500, 3000)))
            sizes[(area, i)] = len(scene["coord"])
            np.savez(data_root / area / f"room_{i}.npz", **scene)
    config = tmp_path / "semseg-pt-v2m2-small.py"
    config.write_text(_PTV2_CONFIG.format(
        base=os.path.join(ROOT, "configs", "s3dis", "semseg-pt-v2m2-0-lovasz.py"),
        data_root=str(data_root)))
    save = tmp_path / "exp"
    ptv2.capacity_dropped_points(reset=True)
    log = _run_tool("train_torch.py", ["--config-file", str(config), "--device", "cpu",
                                       "--options", f"save_path={save}"])
    assert ptv2.capacity_dropped_points(reset=True) == 0
    assert log.count("Train: [") == 2 and log.count("Val result: mIoU/mAcc/allAcc") == 2
    assert "Start Precise Evaluation" in log
    best = os.path.join(save, "model", "model_best.pth")
    assert os.path.isfile(best) and f"Loading weight at: {best}" in log
    pred = np.load(save / "result" / "room_0_pred.npy")
    assert pred.shape == (sizes[("Area_5", 0)],) and 0 <= pred.min() <= pred.max() < 13
