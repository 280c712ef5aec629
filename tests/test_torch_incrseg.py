"""The port's incremental-learning slice against the JAX package on the CPU:
the masked KL distillation loss, one ``IncrSegTrainer`` step (a frozen Seg26
teacher distilled into a Seg26 student with one class more, weights through
the bridge), the base-to-student weight transfer of
``IncrSegCheckpointLoader`` (head trim and ``reserve_matched``), the
known/incr/remap metrics of ``IncrSegEvaluator`` and ``IncrSegTester``, and
``tools/train_torch.py --device cpu`` -> ``tools/test_torch.py --device
cpu`` on an incremental config.
"""

import copy
import logging
import os
import pickle
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.engines.hooks import evaluator as jax_evaluator
from pointcloudpdf_tpu.engines.hooks import misc as jax_misc
from pointcloudpdf_tpu.engines.test import TESTERS as JAX_TESTERS
from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.incr_learners import incr_distill_kl_loss as jax_kl
from pointcloudpdf_tpu.utils.checkpoint import load_weights_into as jax_load_weights_into
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import (backbone_state_dict_to_jax,
                                            jax_to_backbone_state_dict,
                                            jax_to_state_dict, state_dict_to_jax)
from pointcloudpdf_tpu_torch.engines.hooks import evaluator as port_evaluator
from pointcloudpdf_tpu_torch.engines.hooks import misc as port_misc
from pointcloudpdf_tpu_torch.engines.test import TESTERS
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.incr_learners import incr_distill_kl_loss
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree, save_checkpoint
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_train import (CFG, assert_gradients_close, assert_trees_close,
                              make_batch, perturbed_start, port_gradients,
                              record_gradients, recorded_gradients)
from test_torch_trainer import _run_tool, _scene

torch.set_num_threads(1)

BASE_CLASSES = 4          # the teacher's classes; class 3 is learned anew
REMAP = {3: 4}
INCR_CFG = dict(
    copy.deepcopy(CFG),
    model=dict(
        type="DefaultSegmentor",
        backbone=dict(type="PointTransformer-Seg26", in_channels=6,
                      num_classes=BASE_CLASSES),
        criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]),
    incremental_learner=dict(
        type="PointPdf-incr-v1m1",
        backbone=dict(type="PointTransformer-Seg26", in_channels=6,
                      num_classes=BASE_CLASSES + 1),
        eval_criteria=[dict(type="CrossEntropyLoss", loss_weight=1, ignore_index=-1)]),
    data=dict(num_classes=BASE_CLASSES, ignore_index=-1,
              names=["a", "b", "c", "incr_cls"],
              train=dict(type="TorchParityDataset")),
    unknown_label=[3], incr_label_remap=dict(REMAP), incr_label_select=[3],
    base_ckpt=None, incr_ckpt=None, incr_resume=False,
    load_base_weight_to_incr_learner=True,
    base_weight_process_func="trim_base_weight_head",
    train=dict(type="IncrSegTrainer"))


def incr_labels(segment):
    """``segment_incr`` / ``segment_incr_remap`` as ``RemapLabel`` makes them
    for ``REMAP`` with every remapped class selected."""
    incr = np.where(segment == 3, 4, -1).astype(np.int64)
    remap = np.where(segment == 3, 4, segment).astype(np.int64)
    return incr, remap


def incr_batch(seed):
    batch = make_batch(seed, num_classes=BASE_CLASSES)
    batch["segment_incr"], batch["segment_incr_remap"] = incr_labels(batch["segment"])
    return batch


# -- the loss --------------------------------------------------------------------


@pytest.mark.parametrize("temps", [(1.0, 1.0, 1.0), (2.0, 0.5, 0.3)])
def test_incr_distill_kl_loss_matches_jax(temps):
    """Random logits, a masked tail, labelled new-class points and an
    ignored one: the loss within rtol 1e-5 of the JAX function, and its
    gradient (JAX's by ``jax.grad``) within 1e-5 of its max."""
    rng = np.random.RandomState(3)
    B, N, Kb, Kn = 2, 64, 4, 6
    pred = (rng.randn(B, N, Kn) * 3).astype(np.float32)
    target = (rng.randn(B, N, Kb) * 3).astype(np.float32)
    seg_incr = np.where(rng.rand(B, N) < 0.2, rng.randint(Kb, Kn, (B, N)), -1)
    mask = np.ones((B, N), bool)
    mask[1, 40:] = False
    args = (jnp.asarray(target), jnp.asarray(seg_incr), jnp.asarray(mask), *temps)
    want, jgrad = jax.value_and_grad(lambda p: jax_kl(p, *args))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = incr_distill_kl_loss(p, torch.from_numpy(target),
                               torch.from_numpy(seg_incr), torch.from_numpy(mask),
                               *temps)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(p.grad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())


# -- one trainer step ----------------------------------------------------------------


@pytest.fixture(scope="module")
def exact_knn():
    from pointcloudpdf_tpu.ops import geometry as jgeo

    old, jgeo.FORCE_KNN_PATH = jgeo.FORCE_KNN_PATH, "exact"
    yield
    jgeo.FORCE_KNN_PATH = old


def test_incr_step_matches_jax(tmp_path, exact_knn):
    """One distillation step from a shared perturbed start (student and
    teacher): the loss within 1e-4 relative; every student gradient as
    ``assert_gradients_close`` holds it; student parameters and BatchNorm
    running statistics within 1e-4 of each tensor's max |value|; the
    teacher's parameters and statistics bit-unchanged; the validation step
    (student logits, loss on ``segment_incr_remap``) within 1e-4."""
    cfg = dict(copy.deepcopy(INCR_CFG), save_path=str(tmp_path))
    jtrainer = JAX_TRAINERS.build(dict(type="IncrSegTrainer", cfg=JaxConfig(cfg)))
    trainer = TRAINERS.build(dict(type="IncrSegTrainer", cfg=Config(cfg)))
    assert set(trainer.modules()) == {"incr"}
    record_gradients(jtrainer)
    np_batch = incr_batch(0)
    jbatch = jtrainer.device_batch(np_batch)
    jtrainer.initialize_state(jbatch)
    start = perturbed_start(jtrainer, seed=1)
    rng = np.random.RandomState(2)
    teacher = jax.tree_util.tree_map(np.asarray, jtrainer.teacher_variables)
    teacher["params"] = jax.tree_util.tree_map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        teacher["params"])
    jtrainer.teacher_variables = teacher
    trainer.load_teacher_state(teacher)
    trainer.student.load_state_dict(jax_to_backbone_state_dict(
        {k: start[k]["incr"] for k in start}), strict=True)
    teacher_before = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    jtrainer.state, jout = jtrainer._train_step(
        jtrainer.state, jbatch, jax.random.PRNGKey(0), jtrainer.teacher_variables)
    batch = trainer.device_batch(np_batch)
    grads = port_gradients(trainer, lambda: trainer._dispatch_train(batch))["incr"]
    out = trainer.comm_info["model_output_dict"]
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4)
    print("gradients port-JAX: worst tensor %.3e, whole %.3e" % assert_gradients_close(
        grads, recorded_gradients(jtrainer)["incr"], "student gradients"))
    state = trainer.state_dict()
    assert set(state["params"]) == {"incr"}
    assert_trees_close(state["params"], jtrainer.state.params, 1e-4, "params")
    assert_trees_close(state["batch_stats"], jtrainer.state.batch_stats, 1e-4,
                       "batch_stats")
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k
    assert not any(p.requires_grad for p in trainer.model.parameters())

    jeval = jtrainer._make_eval_step()(jtrainer.state, jbatch)
    pout = trainer.eval_step(batch)
    ref = np.asarray(jeval["seg_logits"])
    assert ref.shape[-1] == BASE_CLASSES + 1
    assert np.abs(pout["seg_logits"].numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert float(pout["loss"]) == pytest.approx(float(jeval["loss"]), rel=1e-4)


# -- weight transfer ---------------------------------------------------------------------


def _write_base_checkpoint(path, trainer, open_set):
    """A base checkpoint of the teacher's architecture, seeded, in the JAX
    layout: a closed-set tree or an open-set ``{model, recognizer}`` one."""
    rng = np.random.RandomState(4)
    tree = jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape)).astype(a.dtype),
        state_dict_to_jax(trainer.model.state_dict()))
    if open_set:
        tree = {k: {"model": v, "recognizer": {}} for k, v in tree.items()}
    save_checkpoint(path, dict(epoch=3, state=tree))


@pytest.mark.parametrize("process,open_set", [("trim_base_weight_head", True),
                                              ("reserve_matched", False)])
def test_checkpoint_loader_matches_jax(tmp_path, process, open_set):
    """The port's ``IncrSegCheckpointLoader`` against the JAX hook: what the
    JAX hook hands its trainer (the teacher tree, the student tree with its
    rewrite and partial-row flag) merged by the JAX package's own
    ``load_weights_into`` into the port's initial trees equals, bit for bit,
    what the port's hook left in the port's teacher and student.  Under the
    trim the (C, 5) head takes the base's four columns and keeps its fifth;
    under ``reserve_matched`` it keeps its init."""
    base = str(tmp_path / "base.pth")
    cfg = dict(copy.deepcopy(INCR_CFG), save_path=str(tmp_path), base_ckpt=base,
               base_weight_process_func=process)
    trainer = TRAINERS.build(dict(type="IncrSegTrainer", cfg=Config(cfg)))
    _write_base_checkpoint(base, trainer, open_set)
    teacher0 = state_dict_to_jax(trainer.model.state_dict())
    own0 = trainer.state_dict()
    own0 = {"params": own0["params"], "batch_stats": own0["batch_stats"]}

    jtrainer = JAX_TRAINERS.build(dict(type="IncrSegTrainer", cfg=JaxConfig(cfg)))
    jhook = jax_misc.IncrSegCheckpointLoader()
    jhook.trainer = jtrainer
    jhook.before_train()
    src, rewrite, _, partial = jtrainer._pending_weight_load
    assert partial == (process == "trim_base_weight_head")
    want_student = jax_load_weights_into(own0, src, rewrite=rewrite,
                                         allow_partial_rows=partial)
    t = jtrainer._pending_teacher
    want_teacher = jax_load_weights_into(
        teacher0, {"params": t["params"], "batch_stats": t["batch_stats"]})

    hook = port_misc.IncrSegCheckpointLoader()
    hook.trainer = trainer
    hook.before_train()
    got_teacher = state_dict_to_jax(trainer.model.state_dict())
    got = trainer.state_dict()
    for what, a, b in (("teacher", got_teacher, want_teacher),
                       ("student", {k: got[k] for k in ("params", "batch_stats")},
                        want_student)):
        fa, fb = flatten_tree(a), flatten_tree(b)
        assert set(fa) == set(fb), what
        for path in fb:
            np.testing.assert_array_equal(fa[path], fb[path], err_msg=f"{what} {path}")

    head = got["params"]["incr"]["cls2"]["kernel"]
    base_head = flatten_tree(load_checkpoint_tree(base))["cls2/kernel"]
    init_head = own0["params"]["incr"]["cls2"]["kernel"]
    assert head.shape == (base_head.shape[0], BASE_CLASSES + 1)
    if process == "trim_base_weight_head":
        np.testing.assert_array_equal(head[:, :BASE_CLASSES], base_head)
    else:
        np.testing.assert_array_equal(head[:, :BASE_CLASSES], init_head[:, :BASE_CLASSES])
    np.testing.assert_array_equal(head[:, BASE_CLASSES:], init_head[:, BASE_CLASSES:])


def load_checkpoint_tree(path):
    """The params tree of a segmentor checkpoint under ``backbone_module``."""
    with open(path, "rb") as f:
        params = pickle.load(f)["state"]["params"]
    params = params.get("model", params)
    return params["backbone_module"]


def test_loader_refuses_resume_with_incr_resume(tmp_path):
    cfg = dict(copy.deepcopy(INCR_CFG), save_path=str(tmp_path), resume=True,
               incr_resume=True)
    trainer = TRAINERS.build(dict(type="IncrSegTrainer", cfg=Config(cfg)))
    hook = port_misc.IncrSegCheckpointLoader()
    hook.trainer = trainer
    with pytest.raises(RuntimeError, match="at the same time"):
        hook.before_train()


# -- metrics ------------------------------------------------------------------------------


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


class _FakeTrainer:
    """What an evaluator reads of its trainer: config, logger, the val
    batches and an eval step that hands out fixed logits."""

    def __init__(self, cfg, batches, logits, to_device, eval_step):
        self.cfg, self.val_loader = cfg, batches
        self.logger = logging.getLogger(f"incr_eval_{id(self)}")
        self.logger.setLevel(logging.INFO)
        self.capture = _Capture()
        self.logger.addHandler(self.capture)
        self.writer, self.epoch, self.comm_info, self.state = None, 0, {}, None
        self._logits, self._to_device = iter(logits), to_device
        self._eval = eval_step

    def device_batch(self, input_dict):
        batch = {k: self._to_device(v) for k, v in input_dict.items()}
        n = input_dict["coord"].shape[1]
        batch["mask"] = self._to_device(
            np.arange(n)[None, :] < input_dict["count"][:, None])
        return batch

    def eval_step(self, batch):
        logits = next(self._logits)
        return self._eval(logits)

    def _eval_step(self, state, batch):
        return self.eval_step(batch)


def test_incr_evaluator_matches_jax():
    """Fixed logits over three padded val batches: the port's evaluator
    reports the JAX evaluator's known/incr/remap triple (atol 1e-6) and the
    same log lines, and both name the metrics alike."""
    rng = np.random.RandomState(8)
    k = BASE_CLASSES + 1
    batches, logits = [], []
    for i in range(3):
        seg = rng.randint(-1, BASE_CLASSES, (2, 300)).astype(np.int64)
        count = np.array([300, 211 + 20 * i], np.int32)
        seg[1, count[1]:] = -1
        incr, remap = incr_labels(seg)
        batches.append(dict(coord=rng.rand(2, 300, 3).astype(np.float32),
                            segment_incr_remap=remap, count=count))
        # logits that agree with the labels at ~70% of the points
        lg = rng.randn(2, 300, k).astype(np.float32)
        hit = (rng.rand(2, 300) < 0.7) & (remap >= 0)
        lg[hit, remap[hit]] += 5.0
        logits.append(lg)
    cfg = dict(data=dict(num_classes=BASE_CLASSES, ignore_index=-1,
                         names=["a", "b", "c", "incr_cls"]),
               incr_label_remap=dict(REMAP), incr_label_select=[3], evaluate=True)

    def run(evaluator_mod, config, to_device, eval_step):
        trainer = _FakeTrainer(config(cfg), batches, logits, to_device, eval_step)
        hook = evaluator_mod.IncrSegEvaluator()
        hook.trainer = trainer
        hook.before_train()
        hook.after_epoch()
        return trainer

    port = run(port_evaluator, Config, torch.from_numpy,
               lambda lg: {"seg_logits": torch.from_numpy(lg),
                           "loss": torch.tensor(0.5)})
    jax_run = run(jax_evaluator, JaxConfig, jnp.asarray,
                  lambda lg: {"seg_logits": jnp.asarray(lg), "loss": jnp.asarray(0.5)})
    assert (port.comm_info["current_metric_name"]
            == jax_run.comm_info["current_metric_name"]
            == ["mIoU_known", "mIoU_incr", "mIoU_remap"])
    np.testing.assert_allclose(port.comm_info["current_metric_value"],
                               jax_run.comm_info["current_metric_value"],
                               rtol=0, atol=1e-6)
    assert 0.2 < min(port.comm_info["current_metric_value"]) < 1.0
    assert port.capture.lines == jax_run.capture.lines
    assert sum("mIoU/mAcc/Acc" in line for line in port.capture.lines) == 3


_ROOM_TEST = dict(
    type="S3DISDataset", split="Area_5",
    transform=[dict(type="NormalizeColor", mode="zeroOne")], test_mode=True,
    test_cfg=dict(
        voxelize=dict(type="GridSample", grid_size=0.05, hash_type="fnv",
                      mode="test", keys=("coord", "color"), return_grid_coord=True),
        crop=None,
        post_transform=[
            dict(type="ToTensor"),
            dict(type="Collect", keys=("coord", "grid_coord", "index"),
                 feat_keys=("coord", "color")),
        ],
        aug_transform=[[dict(type="RandomScale", scale=[1, 1])],
                       [dict(type="RandomScale", scale=[1.1, 1.1])]],
    ),
)


def test_incr_tester_matches_jax(tmp_path):
    """Both packages' ``IncrSegTester`` over two synthetic rooms, each
    fragment's forward replaced by fixed logits (a seeded table over the
    room's points plus a per-fragment draw): the fragment voting gives equal
    predictions, and the known/incr/remap lines (remapped full-resolution
    ground truth) are equal."""
    rng = np.random.RandomState(9)
    data_root = tmp_path / "s3dis"
    os.makedirs(data_root / "Area_5")
    for i in range(2):
        scene = _scene(rng, 500 + 40 * i)
        np.savez(data_root / "Area_5" / f"room_{i}.npz", **scene)
    k = BASE_CLASSES + 1
    table = rng.randn(600, k).astype(np.float32)
    lines = {}
    preds = {}
    for name, testers, config in (("port", TESTERS, Config),
                                  ("jax", JAX_TESTERS, JaxConfig)):
        cfg = dict(copy.deepcopy(INCR_CFG), save_path=str(tmp_path / name),
                   weight=None, test=dict(type="IncrSegTester"),
                   data=dict(INCR_CFG["data"],
                             test=dict(_ROOM_TEST, data_root=str(data_root))))
        tester = testers.build(dict(type="IncrSegTester", cfg=config(cfg)))
        draws = np.random.RandomState(10)

        def forward_fragment(fragment):
            index = np.asarray(fragment["index"]).reshape(-1)
            return {"seg_logits": table[index] + 0.5 * draws.randn(
                index.size, k).astype(np.float32)}

        tester.forward_fragment = forward_fragment
        capture = _Capture()
        tester.logger.addHandler(capture)
        try:
            tester.test()
        finally:
            tester.logger.removeHandler(capture)
        lines[name] = [line for line in capture.lines if "mIoU/mAcc/Acc" in line]
        preds[name] = [np.load(tmp_path / name / "result" / f"room_{i}_pred.npy")
                       for i in range(2)]
    assert len(lines["port"]) == 3 and lines["port"] == lines["jax"]
    for a, b in zip(preds["port"], preds["jax"]):
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() < k


# -- the entry points ---------------------------------------------------------------------------

_CONFIG = '''
_base_ = [{base!r}]
batch_size = 2
num_worker = 0
mix_prob = 0.0
enable_amp = False
seed = 7
unknown_label = [3]
incr_label_remap = {{3: 4}}
incr_label_select = [3]
base_ckpt = {base_ckpt!r}
model = dict(
    type="DefaultSegmentor",
    backbone=dict(type="PointTransformer-Seg26", in_channels=6, num_classes=4),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
)
incremental_learner = dict(
    type="PointPdf-incr-v1m1",
    backbone=dict(type="PointTransformer-Seg26", in_channels=6, num_classes=5),
    eval_criteria=[dict(type="CrossEntropyLoss", loss_weight=1, ignore_index=-1)],
)
epoch = 2
eval_epoch = 2
optimizer = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=0.0001)
scheduler = dict(type="MultiStepLR", milestones=[0.6, 0.8], gamma=0.1)
_train_tf = [
    dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
         keys=("coord", "color", "segment"), return_grid_coord=True),
    dict(type="NormalizeColor", mode="zeroOne"),
    dict(type="RemapLabel", remap_dict=incr_label_remap,
         remap_select=incr_label_select),
    dict(type="ToTensor"),
    dict(type="Collect", keys=("coord", "grid_coord", "segment", "segment_incr",
                               "segment_incr_remap"),
         feat_keys=("coord", "color")),
]
data = dict(
    num_classes=4, ignore_index=-1, names=["a", "b", "c", "incr_cls"],
    train=dict(type="S3DISDataset", split="Area_1", data_root={data_root!r},
               transform=_train_tf, test_mode=False),
    val=dict(type="S3DISDataset", split="Area_5", data_root={data_root!r},
             transform=_train_tf, test_mode=False),
    test=dict(
        type="S3DISDataset", split="Area_5", data_root={data_root!r},
        transform=[dict(type="NormalizeColor", mode="zeroOne")],
        test_mode=True,
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


def test_train_and_test_cli_on_an_incr_config(tmp_path):
    """``tools/train_torch.py --device cpu`` on an incremental config built
    on ``configs/_base_/incrseg_runtime.py`` as shipped (its hooks, trainer and
    tester): two epochs from an open-set base checkpoint, the
    known/incr/remap triple after each, the late bests saved; then
    ``tools/test_torch.py --device cpu`` on the student it saved: the triple
    logged once and every point predicted in [0, 5)."""
    from pointcloudpdf_tpu_torch.models import build_model

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.RandomState(0)
    data_root = tmp_path / "s3dis"
    for area, count in (("Area_1", 4), ("Area_5", 1)):
        os.makedirs(data_root / area)
        for i in range(count):
            np.savez(data_root / area / f"room_{i}.npz",
                     **_scene(rng, int(rng.uniform(300, 420))))
    torch.manual_seed(0)
    teacher = build_model(INCR_CFG["model"])
    tree = state_dict_to_jax(teacher.state_dict())
    base = str(tmp_path / "base.pth")
    save_checkpoint(base, dict(epoch=1, state={
        k: {"model": v, "recognizer": {}} for k, v in tree.items()}))
    config = tmp_path / "incrseg-seg26.py"
    config.write_text(_CONFIG.format(
        base=os.path.join(root, "configs", "_base_", "incrseg_runtime.py"),
        data_root=str(data_root), base_ckpt=base))
    save = str(tmp_path / "exp")
    log = _run_tool("train_torch.py", ["--config-file", str(config), "--device",
                                       "cpu", "--options", f"save_path={save}"])
    assert "Loading base weights into the student (trim_base_weight_head)" in log
    losses = [float(v) for v in re.findall(r"Train: \[.*? loss: ([-+.\w]+) ", log)]
    assert len(losses) == 4 and all(np.isfinite(losses))
    for tag in ("known", "incr", "remap"):
        assert len(re.findall(rf"Val result: mIoU/mAcc/Acc {tag} ", log)) == 2
    model_dir = os.path.join(save, "model")
    for name in ("model_last.pth", "model_best_mIoU_known.pth",
                 "model_best_mIoU_incr.pth", "model_best_mIoU_remap.pth"):
        assert os.path.isfile(os.path.join(model_dir, name)), name
    with open(os.path.join(model_dir, "model_last.pth"), "rb") as f:
        saved = pickle.load(f)
    assert set(saved["state"]["params"]) == {"incr"}
    assert saved["state"]["step"] == 4
    student = {k: saved["state"][k]["incr"] for k in ("params", "batch_stats")}
    assert student["params"]["cls2"]["kernel"].shape[-1] == BASE_CLASSES + 1
    back = backbone_state_dict_to_jax(jax_to_backbone_state_dict(student))
    fa, fb = flatten_tree(back), flatten_tree(student)
    assert set(fa) == set(fb)
    for path in fb:
        np.testing.assert_array_equal(fa[path], fb[path])

    test_save = str(tmp_path / "exp_test")
    log = _run_tool("test_torch.py", [
        "--config-file", str(config), "--device", "cpu", "--options",
        f"weight={os.path.join(model_dir, 'model_last.pth')}",
        f"save_path={test_save}"])
    for tag in ("known", "incr", "remap"):
        assert len(re.findall(rf"Val result: mIoU/mAcc/Acc {tag} ", log)) == 1
    pred = np.load(os.path.join(test_save, "result", "room_0_pred.npy"))
    assert pred.min() >= 0 and pred.max() < BASE_CLASSES + 1
