"""The per-rank side of ``test_torch_ddp.py``: computations that run the
same way in one process on the global batch (the reference) and in each
rank of a gloo group started by the port's ``launch``, where a rank takes
items ``rank::world`` of every global batch (the loader's shard order).

The ranks are fresh processes that import this module by name, so it
imports no JAX.  Every function returns numpy results; ``run_ranks`` runs
them all in a rank and pickles what it got to ``<out>/rank<r>.pkl``.
"""

from __future__ import annotations

import contextlib
import copy
import os
import pickle
import tempfile

import numpy as np
import torch

from pointcloudpdf_tpu_torch.datasets import DATASETS
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.incr_learners import incr_distill_kl_loss
from pointcloudpdf_tpu_torch.models.losses import build_criteria
from pointcloudpdf_tpu_torch.models.norm import MaskedBatchNorm, PDMaskedBatchNorm
from pointcloudpdf_tpu_torch.ops.vector_attention import attention_train_affines
from pointcloudpdf_tpu_torch.recognizers import build_recognizer
from pointcloudpdf_tpu_torch.utils import comm
from pointcloudpdf_tpu_torch.utils.config import Config


class _EightScenes:
    """Only the length of a trainer's dataset (16 scenes: 2 steps an epoch
    at either world) reaches the step: the checks feed their own batches."""

    def __init__(self, **kwargs):
        pass

    def __len__(self):
        return 16

    def __getitem__(self, idx):
        raise IndexError("the checks feed their own batches")


DATASETS.register_module("DdpParityDataset", module=_EightScenes, force=True)

SEG26 = dict(type="PointTransformer-Seg26", in_channels=6, num_classes=5)
CE = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
RECOGNIZER = dict(
    type="PointPdf-v1m1",
    recognizer=dict(type="PointTransformer-Recognizer"),
    criteria=CE, loss_weight=0.01, step_loss_weight=True, num_classes=5,
    start_epoch=1, kp_ball_radius=0.12, kp_max_neighbor=8, condition_from="msp",
    beta=1.5, seed_from="ml", seed_range=0.05, num_seed=5, slide_window=True,
    pseudo_jobs=1)
# the global batch is 8: four items a rank at world 2, one a device of the
# JAX trainer's 8-device mesh
TRAIN_CFG = dict(
    batch_size=8, num_worker=0, mix_prob=0.0, enable_amp=False, evaluate=False,
    seed=3, epoch=2, eval_epoch=2, weight=None, resume=False, save_path=None,
    device="cpu",
    model=dict(type="DefaultSegmentor", backbone=SEG26, criteria=CE),
    optimizer=dict(type="SGD", lr=0.0001, momentum=0.9, weight_decay=0.0001),
    scheduler=dict(type="MultiStepLR", milestones=[0.5], gamma=0.1),
    data=dict(num_classes=5, ignore_index=-1, train=dict(type="DdpParityDataset")),
    hooks=[])
OPEN_CFG = dict(copy.deepcopy(TRAIN_CFG), recognizer=RECOGNIZER,
                unknown_label=[4], train=dict(type="OpenSegTrainer"))
PTV2 = dict(
    type="PT-v2m2", in_channels=6, num_classes=5, patch_embed_depth=1,
    patch_embed_channels=16, patch_embed_groups=2, patch_embed_neighbours=8,
    enc_depths=(1, 1), enc_channels=(16, 32), enc_groups=(2, 4),
    enc_neighbours=(8, 8), dec_depths=(1, 1), dec_channels=(16, 16),
    dec_groups=(2, 2), dec_neighbours=(8, 8), grid_sizes=(0.15, 0.3),
    drop_path_rate=0.0)
PTV2_CFG = dict(copy.deepcopy(TRAIN_CFG), batch_size=2,
                model=dict(type="DefaultSegmentor", backbone=PTV2, criteria=CE),
                optimizer=dict(type="AdamW", lr=0.0005, weight_decay=0.05))
INCR_CFG = dict(
    copy.deepcopy(TRAIN_CFG), batch_size=2,
    model=dict(type="DefaultSegmentor", backbone=dict(SEG26, num_classes=4),
               criteria=CE),
    incremental_learner=dict(
        type="PointPdf-incr-v1m1", backbone=SEG26,
        eval_criteria=[dict(type="CrossEntropyLoss", loss_weight=1, ignore_index=-1)]),
    data=dict(num_classes=4, ignore_index=-1, train=dict(type="DdpParityDataset")),
    unknown_label=[3], incr_label_remap={3: 4}, incr_label_select=[3],
    base_ckpt=None, incr_ckpt=None, incr_resume=False,
    train=dict(type="IncrSegTrainer"))


def shard(tree, rank, world):
    """Items ``rank::world`` of every array's leading (batch) dim."""
    if isinstance(tree, dict):
        return {k: shard(v, rank, world) for k, v in tree.items()}
    return tree[rank::world]


def to_numpy(tree):
    """A copy of a tree of tensors or arrays as numpy (a trainer's
    ``state_dict`` holds views of its live tensors)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def scene_batch(seed, counts=(512, 400, 480, 300, 512, 350, 450, 420), n=512,
                num_classes=5):
    """A padded global batch of rooms with a low-confidence-looking corner
    cluster; every count in one bucket, so a rank's shard keeps the pad."""
    rng = np.random.RandomState(seed)
    b = len(counts)
    coord = (rng.rand(b, n, 3) * 2.0).astype(np.float32)
    coord[:, :40] = (rng.rand(b, 40, 3) * 0.3).astype(np.float32)
    color = rng.rand(b, n, 3).astype(np.float32)
    segment = rng.randint(0, num_classes, (b, n)).astype(np.int64)
    segment[rng.rand(b, n) < 0.05] = -1
    count = np.asarray(counts, np.int32)
    pad = np.arange(n)[None, :] >= count[:, None]
    coord[pad], color[pad], segment[pad] = 0.0, 0.0, -1
    return dict(coord=coord, feat=np.concatenate([coord, color], -1),
                segment=segment, count=count)


# -- the statistics --------------------------------------------------------------


def norm_inputs(seed=0, b=4, n=48, c=8):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, n, c) * 2 + 1).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n, 30, 12, 41])[:, None]
    g = rng.randn(b, n, c).astype(np.float32)
    return dict(x=x, mask=mask, g=g)


def make_norm(kind, c=8):
    torch.manual_seed(0)
    if kind == "bn":
        norm = MaskedBatchNorm(c)
    else:
        norm = PDMaskedBatchNorm(c, conditions=("a", "b"), condition="b",
                                 adaptive=True, context_channels=4, zero_init=False)
        norm.context = torch.linspace(-1.0, 1.0, 4)
    with torch.no_grad():
        for p in norm.parameters():
            p.add_(torch.randn(p.shape) * 0.3)
    return norm.train()


def check_norm(kind, rank, world):
    """Forward, input and parameter gradients of (y * g).sum() and the
    running statistics of one training-mode forward on this rank's items."""
    inputs = shard(norm_inputs(), rank, world)
    norm = make_norm(kind)
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y = norm(x, torch.from_numpy(inputs["mask"]))
    (y * torch.from_numpy(inputs["g"])).sum().backward()
    grads = {f"grad.{k}": p.grad for k, p in norm.named_parameters()
             if p.grad is not None}
    return to_numpy(dict(y=y, x_grad=x.grad, **grads,
                         **{f"buf.{k}": v for k, v in norm.state_dict().items()}))


def affine_inputs(seed=1, b=4, n=40, k=6, c=16):
    rng = np.random.RandomState(seed)
    nmask = rng.rand(b, n, k) > 0.25
    nmask[1, 30:] = False
    return dict(
        x_q=rng.randn(b, n, c).astype(np.float32),
        x_k=rng.randn(b, n, c).astype(np.float32),
        coord=rng.rand(b, n, 3).astype(np.float32),
        idx=rng.randint(0, n, (b, n, k)).astype(np.int64),
        nmask=nmask)


def check_attention_affines(rank, world):
    """``attention_train_affines`` (the stats pass beside K4): the six
    affines, the gradients of a loss of them, and the three BatchNorms'
    running statistics."""
    inputs = shard(affine_inputs(), rank, world)
    gen = torch.Generator().manual_seed(2)
    c = inputs["x_q"].shape[-1]
    shapes = dict(p1_w=(3, 3), p1_b=(3,), p2_w=(3, c), p2_b=(c,),
                  w1_w=(c, c // 8), w1_b=(c // 8,))
    params = {k: (torch.randn(s, generator=gen) * 0.5).requires_grad_(True)
              for k, s in shapes.items()}
    bns = [MaskedBatchNorm(3), MaskedBatchNorm(c), MaskedBatchNorm(c // 8)]
    x_q = torch.from_numpy(inputs["x_q"]).requires_grad_(True)
    x_k = torch.from_numpy(inputs["x_k"]).requires_grad_(True)
    affines = attention_train_affines(
        x_q, x_k, torch.from_numpy(inputs["coord"]), torch.from_numpy(inputs["idx"]),
        torch.from_numpy(inputs["nmask"]), *params.values(), *bns)
    weights = [torch.randn(a.shape, generator=gen) for a in affines]
    # every rank holds the whole affines: its loss is its share of them
    comm.rank_share(sum((a * w).sum() for a, w in zip(affines, weights))).backward()
    out = dict(affines=torch.stack([a.detach() for a in affines[:2]]),
               x_q_grad=x_q.grad, x_k_grad=x_k.grad)
    out.update({f"affine{i}": a for i, a in enumerate(affines)})
    out.update({f"grad.{k}": p.grad for k, p in params.items()})
    for i, bn in enumerate(bns):
        out[f"bn{i}.mean"], out[f"bn{i}.var"] = bn.running_mean, bn.running_var
    return to_numpy(out)


# -- the losses ----------------------------------------------------------------------


def loss_inputs(seed=2, n=64, k=5):
    """Two items: the first whole, the second mostly padding (10 valid)."""
    rng = np.random.RandomState(seed)
    mask = np.arange(n)[None, :] < np.array([n, 10])[:, None]
    segment = rng.randint(0, k, (2, n)).astype(np.int64)
    segment[rng.rand(2, n) < 0.1] = -1
    segment[~mask] = -1
    return dict(
        logits=(rng.randn(2, n, k) * 2).astype(np.float32),
        raw=rng.randn(2, n, 1).astype(np.float32),
        teacher=(rng.randn(2, n, k - 1) * 2).astype(np.float32),
        segment=segment, mask=mask,
        pseudo=np.where(rng.rand(2, n) < 0.2, k, segment) * mask - ~mask,
        segment_incr=np.where(segment == k - 1, k - 1, -1),
        binary=(rng.rand(2, n) < 0.3).astype(np.float32))


LOSSES = {
    "ce": [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1,
                weight=[1.0, 2.0, 0.5, 1.0, 1.5])],
    "ce_smooth": [dict(type="CrossEntropyLoss", label_smoothing=0.1,
                       ignore_index=-1)],
    "smooth_ce": [dict(type="SmoothCELoss", smoothing_ratio=0.1)],
    "focal": [dict(type="FocalLoss", ignore_index=-1)],
    "dice": [dict(type="DiceLoss", ignore_index=-1)],
    "binary_focal": [dict(type="BinaryFocalLoss")],
    "lovasz": [dict(type="LovaszLoss", mode="multiclass", ignore_index=-1)],
}


def check_loss(name, rank, world, inputs=None):
    """This rank's loss and the gradient of its logits."""
    inputs = shard(inputs or loss_inputs(), rank, world)
    logits = torch.from_numpy(inputs["logits"]).requires_grad_(True)
    segment = torch.from_numpy(inputs["segment"])
    if name == "kl":
        loss = incr_distill_kl_loss(
            logits, torch.from_numpy(inputs["teacher"]),
            torch.from_numpy(inputs["segment_incr"]), torch.from_numpy(inputs["mask"]),
            2.0, 0.5, 0.3)
    elif name == "pdf":
        rec = build_recognizer(RECOGNIZER)
        loss = rec.rec_loss(logits, torch.from_numpy(inputs["raw"]),
                            torch.from_numpy(inputs["pseudo"]))
    elif name == "binary_focal":
        loss = build_criteria(LOSSES[name])(logits[..., 0],
                                            torch.from_numpy(inputs["binary"]))
    else:
        loss = build_criteria(LOSSES[name])(logits, segment)
    loss.backward()
    return dict(loss=float(loss.detach()), grad=logits.grad.numpy().copy())


# -- trainer steps ---------------------------------------------------------------------


def perturb(modules, seed, scale=0.02):
    """Seeded noise on every parameter (a fresh initialisation puts biases
    at exactly 0, on ReLU kinks)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in sorted(modules):
            for p in modules[name].parameters():
                p.add_(torch.randn(p.shape, generator=gen) * scale)


def build_trainer(cfg, seed):
    """A trainer whose modules start from ``seed`` in any process (its
    writer's events go to a temporary directory)."""
    torch.manual_seed(seed)
    cfg = dict(copy.deepcopy(cfg), save_path=tempfile.mkdtemp(prefix="ddp_ranks_"))
    trainer = TRAINERS.build(dict(type=cfg["train"]["type"] if "train" in cfg
                                  else "DefaultTrainer", cfg=Config(cfg)))
    perturb(trainer.modules(), seed + 1)
    if hasattr(trainer, "student"):
        perturb({"teacher": trainer.model}, seed + 2)
    return trainer


def record_steps(trainer):
    """Wrap the trainer so each train step records its outputs, the
    pseudo-labels it trained on and, for the first step, the gradients
    the optimizer was handed (JAX layout)."""
    steps = []
    dispatch = trainer._dispatch_train
    optimizer_step = trainer.optimizer.step

    def recording_step():
        if len(steps) == 1 and "grads" not in steps[0]:
            grads = {}
            for name, module in trainer.modules().items():
                tensors = dict(module.state_dict())
                tensors.update({n: p.grad.detach().clone()
                                for n, p in module.named_parameters()
                                if p.grad is not None})
                grads[name] = trainer.to_jax_tree(name, tensors)["params"]
            steps[0]["grads"] = to_numpy(grads)
        return optimizer_step()

    def recording_dispatch(batch, *args):
        steps.append({"segment_pseudo": batch.get("segment_pseudo")})
        steps[-1]["segment_pseudo"] = to_numpy(steps[-1]["segment_pseudo"])
        dispatch(batch, *args)
        out = trainer.comm_info["model_output_dict"]
        steps[-1]["out"] = {k: float(v) for k, v in out.items()}
        steps[-1]["state"] = {k: to_numpy(v) for k, v in trainer.state_dict().items()
                              if k in ("params", "batch_stats")}

    trainer._dispatch_train = recording_dispatch
    trainer.optimizer.step = recording_step
    return steps


def open_seg_steps(rank, world):
    """Three ``OpenSegTrainer`` steps through ``run_step``: one in epoch 0
    (recognizer frozen), two in epoch 1 (score pass, host pseudo-labels,
    the pipelined step; the last flushed as an epoch's end does).  Returns
    the start state, each batch's pseudo-labels from the start's weights
    (``OpenSegTrainer.pseudo_masks`` on the score pass) and the steps."""
    trainer = build_trainer(OPEN_CFG, seed=11)
    start = {k: to_numpy(v) for k, v in trainer.state_dict().items()
             if k in ("params", "batch_stats")}
    batches = [shard(scene_batch(seed), rank, world) for seed in (21, 22, 23)]
    masks = []
    for input_dict in batches:
        sheets = trainer.pseudo_forward(trainer.device_batch(input_dict))
        masks.append(trainer.pseudo_masks(input_dict, *to_numpy(list(sheets))))
    steps = record_steps(trainer)
    for epoch, input_dict in zip((0, 1, 1), batches):
        trainer.epoch = epoch
        trainer.comm_info["input_dict"] = input_dict
        trainer.run_step()
    trainer._flush_pending()
    return dict(start=start, masks=masks, steps=steps)


def ptv2_batch(seed=40, n=2048, tail=405):
    """Two uniform rooms in a box, the second with a padded tail."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(2, n, 3) * np.array([1.6, 1.2, 0.8])).astype(np.float32)
    feat = rng.rand(2, n, 6).astype(np.float32)
    count = np.array([n, n - tail], np.int32)
    pad = np.arange(n)[None, :] >= count[:, None]
    coord[pad], feat[pad] = 0.0, 0.0
    segment = rng.randint(0, 5, (2, n)).astype(np.int64)
    segment[pad | (rng.rand(2, n) < 0.05)] = -1
    return dict(coord=coord, feat=feat, segment=segment, count=count)


def ptv2_step(rank, world):
    """One PT-v2m2 ``DefaultTrainer`` step (AdamW, CE, drop path 0)."""
    trainer = build_trainer(PTV2_CFG, seed=31)
    steps = record_steps(trainer)
    trainer.comm_info["input_dict"] = shard(ptv2_batch(), rank, world)
    trainer.run_step()
    return steps


def incr_step(rank, world):
    """One ``IncrSegTrainer`` step: a frozen Seg26 teacher of 4 classes
    distilled into a Seg26 student of 5; the teacher's state after it."""
    trainer = build_trainer(INCR_CFG, seed=41)
    steps = record_steps(trainer)
    # the deepest level holds N / 256 points a room: at 512 points its
    # BatchNorm statistics over ~3 points take float32 rounding magnified
    batch = scene_batch(42, counts=(2048, 1400), n=2048, num_classes=4)
    segment = batch["segment"]
    batch["segment_incr"] = np.where(segment == 3, 4, -1).astype(np.int64)
    batch["segment_incr_remap"] = np.where(segment == 3, 4, segment).astype(np.int64)
    trainer.comm_info["input_dict"] = shard(batch, rank, world)
    trainer.run_step()
    steps[0]["teacher"] = to_numpy(trainer.model.state_dict())
    return steps


@contextlib.contextmanager
def float64_casts():
    """The port casts to f32 at its boundaries (``.float()``); inside this
    a float64 tensor goes through them as it is."""
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda t, *args, **kwargs: (
        t if t.dtype == torch.float64 else to_float(t, *args, **kwargs))
    try:
        yield
    finally:
        torch.Tensor.float = to_float


def float64_gradient(rank, world):
    """The open-set backbone's loss and gradient in float64: the
    data-parallel sums then agree with one process to float64's rounding,
    where a float32 gradient of this network moves by percents with the
    order of its sums."""
    trainer = build_trainer(OPEN_CFG, seed=11)
    model = trainer.model.double().train()
    batch = {k: v.double() if v.is_floating_point() else v for k, v in
             trainer.device_batch(shard(scene_batch(21), rank, world)).items()}
    with float64_casts():
        loss = model.loss(model(batch)["seg_logits"], batch["segment"])
        loss.backward()
    trainer.sum_gradients()
    tensors = dict(model.state_dict())
    tensors.update({n: p.grad for n, p in model.named_parameters()})
    return dict(loss=float(comm.sum_over_ranks(loss.detach())),
                grads=to_numpy(trainer.to_jax_tree("model", tensors)["params"]))


def open_seg_float64(rank, world):
    """Two ``OpenSegTrainer`` steps through ``run_step`` in float64 at a
    rate of 0.01: one in epoch 0, then one past ``start_epoch``, which
    trains on the pseudo-labels of the score pass on the first update's
    weights and the host graph stage.  Returns each step's running
    statistics and the pseudo-labels it trained on."""
    cfg = copy.deepcopy(OPEN_CFG)
    cfg["optimizer"]["lr"] = 0.01
    trainer = build_trainer(cfg, seed=11)
    for module in trainer.modules().values():
        module.double()
    device_batch = trainer.device_batch
    trainer.device_batch = lambda input_dict: {
        k: v.double() if v.is_floating_point() else v
        for k, v in device_batch(input_dict).items()}
    steps = record_steps(trainer)
    with float64_casts():
        for epoch, seed in ((0, 21), (1, 22)):
            trainer.epoch = epoch
            trainer.comm_info["input_dict"] = shard(scene_batch(seed), rank, world)
            trainer.run_step()
        trainer._flush_pending()
    return [dict(stats=s["state"]["batch_stats"], segment_pseudo=s["segment_pseudo"],
                 out=s["out"]) for s in steps]


def fail_on_rank_one():
    """``launch``'s ``main_func`` for a run whose rank 1 raises while rank 0
    waits for it at a barrier."""
    if comm.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    comm.synchronize()


def check_comm():
    """The host-side queries and collectives, and the tensor ones."""
    rank = comm.get_rank()
    comm.synchronize()
    x = torch.tensor(float(rank + 1), requires_grad=True)
    (comm.sum_over_ranks(x * x) * (rank + 1)).backward()
    return dict(
        rank=rank, world=comm.get_world_size(), local_rank=comm.get_local_rank(),
        main=comm.is_main_process(),
        gathered=comm.all_gather({"rank": rank, "items": np.arange(rank + 2)}),
        gather=comm.gather(rank * 10),
        reduced=comm.reduce_dict({"a": float(rank + 1), "b": 2.0 * rank}),
        reduced_sum=comm.reduce_dict({"a": float(rank + 1)}, average=False),
        seed=comm.shared_random_seed(),
        summed=comm.sum_over_ranks(torch.tensor([1.0, float(rank)])).numpy(),
        x_grad=float(x.grad),
        broadcast=comm.broadcast_(torch.tensor([float(rank) + 5.0])).numpy())


CHECKS = dict(
    **{f"norm.{kind}": (check_norm, kind) for kind in ("bn", "pd")},
    affines=(check_attention_affines,),
    **{f"loss.{name}": (check_loss, name) for name in (*LOSSES, "kl", "pdf")},
    open_seg=(open_seg_steps,), ptv2=(ptv2_step,), incr=(incr_step,),
    float64=(float64_gradient,), open_seg_float64=(open_seg_float64,))


def run_ranks(out_dir):
    """``launch``'s ``main_func``: every check on this rank's shard."""
    torch.set_num_threads(1)
    rank, world = comm.get_rank(), comm.get_world_size()
    results = dict(comm=check_comm())
    for key, (fn, *args) in CHECKS.items():
        results[key] = fn(*args, rank, world)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
