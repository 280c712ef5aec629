"""The port's training pieces against the JAX package on the CPU: the
cross-entropy loss, the six lr schedules, ``build_optimizer``, and three
SGD steps of Seg26 ``DefaultSegmentor`` through both packages' ``Trainer``
on one padded batch made with numpy, weights carried over by the bridge.
JAX runs its exact kNN path in f32.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.datasets import DATASETS as JAX_DATASETS
from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.models.losses import build_criteria as jax_build_criteria
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.datasets import DATASETS
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models.losses import build_criteria
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config
from pointcloudpdf_tpu_torch.utils.optimizer import build_optimizer
from pointcloudpdf_tpu_torch.utils.scheduler import build_scheduler

torch.set_num_threads(1)


class _EightScenes:
    """Stands in for the datasets a trainer builds: only its length (8
    scenes, so 4 iterations of batch 2) reaches the step."""

    def __init__(self, **kwargs):
        pass

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        raise IndexError("the parity tests feed their own batch")


for registry in (DATASETS, JAX_DATASETS):
    registry.register_module("TorchParityDataset", module=_EightScenes, force=True)

CFG = dict(
    batch_size=2, num_worker=0, mix_prob=0.0, enable_amp=False, evaluate=False,
    seed=3, epoch=2, eval_epoch=2, weight=None, resume=False, save_path=None,
    device="cpu",
    model=dict(
        type="DefaultSegmentor",
        backbone=dict(type="PointTransformer-Seg26", in_channels=6, num_classes=5),
        criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
    ),
    optimizer=dict(type="SGD", lr=0.0005, momentum=0.9, weight_decay=0.0001),
    # 8 steps in all: the rate falls at step 2 and again at step 4
    scheduler=dict(type="MultiStepLR", milestones=[0.25, 0.5], gamma=0.1),
    data=dict(num_classes=5, ignore_index=-1,
              train=dict(type="TorchParityDataset")),
    hooks=[],
)


def make_batch(seed, num_classes=5, n=2048, counts=(2048, 1607)):
    """One padded batch as the collate function leaves it."""
    rng = np.random.RandomState(seed)
    b = len(counts)
    coord = rng.rand(b, n, 3).astype(np.float32)
    color = rng.rand(b, n, 3).astype(np.float32)
    segment = rng.randint(0, num_classes, (b, n)).astype(np.int64)
    segment[rng.rand(b, n) < 0.05] = -1
    count = np.asarray(counts, np.int32)
    pad = np.arange(n)[None, :] >= count[:, None]
    coord[pad], color[pad], segment[pad] = 0.0, 0.0, -1
    return dict(coord=coord, feat=np.concatenate([coord, color], -1),
                segment=segment, count=count)


@pytest.fixture
def exact_knn():
    old = jgeo.FORCE_KNN_PATH
    jgeo.FORCE_KNN_PATH = "exact"
    yield
    jgeo.FORCE_KNN_PATH = old


def assert_trees_close(port_tree, jax_tree, tol, what):
    """Every leaf within ``tol`` of that leaf's max |value| in the JAX tree."""
    port_flat = flatten_tree(port_tree)
    jax_flat = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert set(port_flat) == set(jax_flat)
    for path, ref in jax_flat.items():
        err = np.abs(port_flat[path] - ref).max()
        assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, path, err)


GRADIENT_TOL = 0.25         # one tensor's gradient, of its max |grad|
GRADIENT_TOL_WHOLE = 0.05   # the whole gradient, in L2


def assert_gradients_close(tree, ref_tree, what):
    """Every parameter's gradient within ``GRADIENT_TOL`` of that tensor's
    max |grad| in the reference tree, and the gradient as a whole within
    ``GRADIENT_TOL_WHOLE`` of the reference's length.  A bias ahead of a
    batch-statistic BatchNorm or the softmax has an exact gradient of 0
    (both sides hold rounding noise), so a bias is held to the larger of
    its own and its kernel's scale.  Returns (worst tensor, whole).

    The tolerances are the f32 noise of this network's backward pass, not
    a margin for the port: through some twenty batch-statistic BatchNorms
    either package's f32 gradient departs from the float64 gradient by
    percents (``test_three_sgd_steps_match_jax_trainer`` measures and
    holds all three pairs; run it with ``-s`` for the numbers).  One
    layer's gradients are held to 1e-3 in ``test_torch_layer.py``.  What
    this check adds is a whole-network comparison that the learning rate
    cannot dilute: a missing or wrong term in a tensor's gradient is an
    error of order 1."""
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, tree))
    ref_flat = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_tree))
    assert set(flat) == set(ref_flat)
    worst, diff2, norm2 = (0.0, None), 0.0, 0.0
    for path, ref in ref_flat.items():
        scale = np.abs(ref).max()
        kernel = path.rsplit("/", 1)[0] + "/kernel"
        if path.endswith("/bias") and kernel in ref_flat:
            scale = max(scale, np.abs(ref_flat[kernel]).max())
        err = float(np.abs(flat[path] - ref).max() / max(scale, 1e-30))
        worst = max(worst, (err, path))
        diff2 += float(((flat[path] - ref).astype(np.float64) ** 2).sum())
        norm2 += float((ref.astype(np.float64) ** 2).sum())
    whole = (diff2 / norm2) ** 0.5
    assert worst[0] <= GRADIENT_TOL, (what, worst)
    assert whole <= GRADIENT_TOL_WHOLE, (what, whole)
    return worst[0], whole


def float64_gradients(trainer, np_batch):
    """The gradient of the port's loss at the trainer's present state,
    computed in float64 on a copy of its model, as a tree in the JAX
    layout.  The port casts to f32 at its boundaries (``.float()``); for
    this one pass a float64 tensor goes through those casts as it is."""
    to_float = torch.Tensor.float
    model = copy.deepcopy(trainer.model).double().train()
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in trainer.device_batch(np_batch).items()}
    torch.Tensor.float = lambda t, *args, **kwargs: (
        t if t.dtype == torch.float64 else to_float(t, *args, **kwargs))
    try:
        out = model(batch)
        model.loss(out["seg_logits"], batch["segment"]).backward()
    finally:
        torch.Tensor.float = to_float
    tensors = dict(model.state_dict())
    tensors.update({n: p.grad for n, p in model.named_parameters()})
    return state_dict_to_jax({k: to_float(v) if v.is_floating_point() else v
                              for k, v in tensors.items()})["params"]


def record_gradients(jtrainer):
    """Have the JAX trainer's own step keep the gradient it computed: a
    pass-through transformation ahead of its optimizer stores the gradient
    as the first part of the optimizer state and hands it on unchanged.
    Call before ``initialize_state``; read with ``recorded_gradients``."""
    import optax

    build = jtrainer.build_optimizer_tx
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    jtrainer.build_optimizer_tx = lambda params: optax.chain(keep, build(params))


def recorded_gradients(jtrainer):
    return jtrainer.state.opt_state[0]


def port_gradients(trainer, step):
    """Run ``step()`` (one trainer step) and return the gradients its
    optimizer was handed, as trees in the JAX layout."""
    seen = {}
    optimizer_step = trainer.optimizer.step

    def recording_step():
        for name, module in trainer.modules().items():
            tensors = dict(module.state_dict())
            tensors.update({n: p.grad.detach().clone()
                            for n, p in module.named_parameters()})
            seen[name] = trainer.to_jax_tree(name, tensors)["params"]
        return optimizer_step()

    trainer.optimizer.step = recording_step
    try:
        step()
    finally:
        del trainer.optimizer.step
    return seen[""] if "" in seen else seen


# -- loss -----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "class-weights", "all-ignored",
                                  "smoothing-sum"])
def test_cross_entropy_matches_jax(case):
    """rtol 1e-6: the same f32 formula on both sides."""
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((2, 50, 7)).astype(np.float32) * 3
    target = rng.randint(0, 7, (2, 50)).astype(np.int64)
    target[rng.rand(2, 50) < 0.2] = -1
    cfg = dict(type="CrossEntropyLoss", loss_weight=0.7, ignore_index=-1)
    if case == "class-weights":
        cfg["weight"] = (0.5 + rng.rand(7)).tolist()
    if case == "all-ignored":
        target[:] = -1
    if case == "smoothing-sum":
        cfg.update(label_smoothing=0.1, reduction="sum")
    ref = float(jax_build_criteria([cfg])(jnp.asarray(logits), jnp.asarray(target)))
    got = float(build_criteria([cfg])(torch.from_numpy(logits),
                                      torch.from_numpy(target)))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)
    if case == "all-ignored":
        assert got == 0.0


def test_cross_entropy_gradient_skips_ignored_points():
    logits = torch.randn(1, 10, 4, requires_grad=True)
    target = torch.tensor([[0, 1, -1, 2, -1, 3, 0, 1, 2, 3]])
    build_criteria([dict(type="CrossEntropyLoss")])(logits, target).backward()
    assert (logits.grad[0, [2, 4]] == 0).all() and (logits.grad[0, 0] != 0).any()


# -- schedules and optimizer -----------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(type="MultiStepLR", milestones=[0.3, 0.7], gamma=0.1),
    dict(type="MultiStepWithWarmupLR", milestones=[0.5, 0.8], gamma=0.2,
         warmup_rate=0.1, warmup_scale=1e-3),
    dict(type="PolyLR", power=0.9),
    dict(type="ExpLR", gamma=0.5),
    dict(type="CosineAnnealingLR", eta_min=0.001),
    dict(type="OneCycleLR", max_lr=0.5, pct_start=0.25, div_factor=10.0,
         final_div_factor=100.0),
], ids=lambda c: c["type"])
def test_scheduler_matches_jax_at_every_step(cfg):
    """Every step of a 40-step run, to 1e-7 absolute."""
    total = 40
    ref = jax_build_scheduler(copy.deepcopy(cfg), 0.5, total)
    got = build_scheduler(copy.deepcopy(cfg), 0.5, total)
    for step in range(total + 1):
        assert float(got(step)) == pytest.approx(float(ref(step)), abs=1e-7), step


def test_build_optimizer_param_dicts_groups():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    named = [(f"block.{n}" if n.startswith("1") else n, p)
             for n, p in model.named_parameters()]
    opt = build_optimizer(dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.01),
                          named, param_dicts=[dict(keyword="block", lr=0.01)])
    default, block = opt.param_groups
    assert len(default["params"]) == 2 and len(block["params"]) == 2
    assert block["params"][0] is model[1].weight
    assert default["lr_scale"] == 1.0 and block["lr_scale"] == pytest.approx(0.1)
    assert block["lr"] == pytest.approx(0.01) and block["momentum"] == 0.9
    for name in ("Adam", "AdamW"):
        o = build_optimizer(dict(type=name, lr=1e-3, weight_decay=0.05),
                            model.named_parameters())
        assert type(o).__name__ == name and len(o.param_groups) == 1


def test_sgd_update_rule_matches_optax():
    """The same gradients through both optimizers for five steps of a
    falling schedule, one group with its own lr: parameters within 1e-6.
    Weight decay -> momentum -> lr, with the lr read at the step's index."""
    from pointcloudpdf_tpu.utils.optimizer import build_optimizer as jax_build

    rng = np.random.RandomState(2)
    shapes = {"block": {"kernel": (4, 3)}, "head": {"kernel": (3, 2), "bias": (2,)}}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    sched_cfg = dict(type="MultiStepLR", milestones=[0.4, 0.8], gamma=0.1)
    opt_cfg = dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.01)
    groups = [dict(keyword="block", lr=0.01)]
    tx = jax_build(dict(opt_cfg), params=params, param_dicts=groups,
                   lr_schedule=jax_build_scheduler(dict(sched_cfg), 0.1, 5))
    jparams, opt_state = params, tx.init(params)
    flat = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in flatten_tree(params).items()}
    opt = build_optimizer(dict(opt_cfg), flat.items(), param_dicts=groups)
    sched = build_scheduler(dict(sched_cfg), 0.1, 5)
    import optax

    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, g in flatten_tree(grads).items():
            flat[k].grad = torch.from_numpy(g.copy())
        for group in opt.param_groups:
            group["lr"] = sched(step) * group["lr_scale"]
        opt.step()
    for k, ref in flatten_tree(jax.tree_util.tree_map(np.asarray, jparams)).items():
        np.testing.assert_allclose(flat[k].detach().numpy(), ref, rtol=1e-6, atol=1e-6)


# -- three SGD steps ---------------------------------------------------------------


def perturbed_start(jtrainer, seed):
    """The JAX trainer's initial state with seeded noise on every parameter,
    set on the JAX trainer and returned as numpy trees.  A fresh
    initialisation has all biases at exactly 0, which puts pre-activations
    of the attention's positional MLP exactly on a ReLU kink wherever a
    query has fewer valid neighbours than slots (stage 5 here); there the
    two frameworks pick different subgradients, and the JAX gradient
    departs from its own finite differences.  No trained state sits on
    such a point."""
    from pointcloudpdf_tpu.parallel.mesh import replicate_tree

    rng = np.random.RandomState(seed)
    state = jtrainer.state
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        state.params)
    jtrainer.state = replicate_tree(state.replace(params=params), jtrainer.mesh)
    return {"params": params,
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


def test_three_sgd_steps_match_jax_trainer(exact_knn, tmp_path):
    """Loss at each of three steps within 1e-4 relative; the first step's
    gradient of every parameter, port against JAX and each of the two
    against the port's float64 gradient, as ``assert_gradients_close``
    holds it (measured, worst tensor / whole: port-JAX 1.3e-1 / 1.4e-2,
    port-float64 7.0e-2 / 1.3e-2, JAX-float64 1.3e-1 / 9.7e-3);
    parameters and BatchNorm running statistics within 1e-4 of each
    tensor's max |value| after the first step and within 1e-2 after the
    third (measured after each step, statistics: 5.5e-6, 3.6e-4, 4.7e-3).
    The schedule drops the rate at step 2, so the lr path is part of what
    is compared.

    The rate is small on purpose.  This network's gradients are
    ill-conditioned at a test's size (in the port alone, a 1e-6 relative
    change of the parameters moves them by ~2%, up to 12%: few points per
    batch-statistic BatchNorm at the deep stages, ReLU gates), so two f32
    trajectories separate by a factor of ~70 a step, from a start set by
    the rate; at lr 0.002 the third loss already differs by 2.4e-4.  The update rule itself, momentum included,
    is held exactly in ``test_sgd_update_rule_matches_optax``."""
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path))
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(cfg)))
    assert trainer.total_steps == jtrainer.total_steps == 8
    record_gradients(jtrainer)

    np_batch = make_batch(0)
    jbatch = jtrainer.device_batch(np_batch)
    jtrainer.initialize_state(jbatch)
    start = perturbed_start(jtrainer, seed=1)
    trainer.model.load_state_dict(jax_to_state_dict(start), strict=True)
    truth = float64_gradients(trainer, np_batch)

    for step in range(3):
        rng = jax.random.fold_in(jtrainer._base_rng, step + 1)
        jtrainer.state, jout = jtrainer._train_step(jtrainer.state, jbatch, rng)
        trainer.comm_info["input_dict"] = np_batch
        grads = port_gradients(trainer, trainer.run_step)
        out = trainer.comm_info["model_output_dict"]
        assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4), step
        if step == 0:
            jgrads = recorded_gradients(jtrainer)
            for what, a, b in (("port-JAX", grads, jgrads),
                               ("port-float64", grads, truth),
                               ("JAX-float64", jgrads, truth)):
                print(f"gradients {what}: worst tensor %.3e, whole %.3e"
                      % assert_gradients_close(a, b, what))
        assert trainer.comm_info["lr"] == pytest.approx(
            float(jtrainer.scheduler(step)), abs=1e-9)
        if step in (0, 2):
            tol = 1e-4 if step == 0 else 1e-2
            end = state_dict_to_jax(trainer.model.state_dict())
            assert_trees_close(end["params"], jtrainer.state.params, tol, "params")
            assert_trees_close(end["batch_stats"], jtrainer.state.batch_stats,
                               tol, "batch_stats")
    assert trainer.comm_info["lr"] == pytest.approx(0.00005)

    assert trainer.state_dict()["step"] == 3
