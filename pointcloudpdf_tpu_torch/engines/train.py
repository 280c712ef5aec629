"""Trainers: hook-driven epoch loops over an eager PyTorch train step.

Counterpart of ``pointcloudpdf_tpu/engines/train.py`` (``TrainerBase``,
``Trainer`` / ``DefaultTrainer``, ``OpenSegTrainer``, ``IncrSegTrainer``,
``MultiDatasetTrainer``).  The JAX ``TrainState`` pytree becomes the
modules, a ``torch.optim`` optimizer and a host step counter; the jitted
step becomes forward + loss + backward + ``optimizer.step()``; the learning
rate is set on every parameter group from the schedule before each step.
The hook lifecycle (before/after train/epoch/step) and the ``comm_info``
keys match the reference.  After the backward every optimizer parameter the
step did not reach takes a zero gradient (``reduce_gradients``), so the
optimizer decays and moves it as optax moves every leaf of the JAX tree.
Drop path draws from the trainer's own generator, seeded at each step from
``(seed, step)`` as the JAX step folds the step into its dropout key, so a
resumed run replays the same draws; the global RNG is not touched.  Checkpoints keep the JAX package's tree
(``state = {params, batch_stats, opt_state, step}`` through ``bridge``), so
either package's testers load what this trainer saves.

Data-parallel over ranks (``launch``), a step computes what one process
computes on the global batch, as the JAX step does under GSPMD: each rank's
loader takes its share of the batch (the shard order interleaves, so
step k's union over ranks is global batch k), the BatchNorm statistics are
the global batch's, the losses divide by the global batch's weight counts,
and the gradients are summed over ranks before the optimizer steps; the
logged losses are summed too.  Parameters are broadcast from rank 0 at
start.  Mix3D pairs crops within a rank's batch, as the reference does.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..bridge import (backbone_state_dict_to_jax, jax_to_backbone_state_dict,
                      jax_to_state_dict, state_dict_to_jax)
from ..datasets import build_dataset, padded_collate_fn
from ..datasets.loader import DataLoader, MultiDatasetDataloader, Subset
from ..models import build_model
from ..models.default import takes_generator
from ..utils import comm
from ..utils.checkpoint import load_weights_into
from ..utils.events import EventStorage
from ..utils.logger import get_root_logger
from ..utils.optimizer import build_optimizer
from ..utils.registry import Registry
from ..utils.scheduler import build_scheduler
from .defaults import batch_condition, default_setup, per_rank_batch
from .hooks import HookBase, build_hooks
from .test import resolve_device

TRAINERS = Registry("trainers")


class TrainerBase:
    def __init__(self):
        self.hooks = []
        self.epoch = 0
        self.start_epoch = 0
        self.max_epoch = 0
        self.comm_info: Dict = {}
        self.storage: Optional[EventStorage] = None
        self.logger = get_root_logger()

    def register_hooks(self, hooks_cfg) -> None:
        self.hooks = build_hooks(hooks_cfg)
        for hook in self.hooks:
            assert isinstance(hook, HookBase)
            hook.trainer = self

    def _call_hooks(self, stage: str) -> None:
        for hook in self.hooks:
            getattr(hook, stage)()

    def train(self):
        with EventStorage(self.start_epoch) as self.storage:
            self._call_hooks("before_train")
            for epoch in range(self.start_epoch, self.max_epoch):
                self.epoch = epoch
                if hasattr(self.train_loader, "set_epoch"):
                    self.train_loader.set_epoch(epoch)
                self._call_hooks("before_epoch")
                for i, input_dict in enumerate(self.train_loader):
                    self.comm_info["iter"] = i
                    self.comm_info["input_dict"] = input_dict
                    self._call_hooks("before_step")
                    self.run_step()
                    self._call_hooks("after_step")
                self._call_hooks("after_epoch")
                self.storage.reset_histories()
            self._call_hooks("after_train")

    def run_step(self):
        raise NotImplementedError


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The drop-path generator's seed at host step ``step``, the JAX step's
    ``fold_in(PRNGKey(seed), step + 1)``: the numbers hashed into 63 bits
    (a CPU generator keeps the low 32 of them, so every bit must mix).
    Ranks past 0 fold in their rank, so each draws its own masks; rank 0
    draws a one-process run's."""
    entropy = [int(seed), int(step) + 1] + ([int(rank)] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def global_outputs(out: Dict) -> Dict:
    """A step's logged losses summed over ranks, in one all-reduce: each
    rank holds its part of the global batch's loss."""
    if not comm.is_distributed() or not out:
        return out
    summed = comm.all_reduce_(torch.stack([v.float() for v in out.values()]))
    return dict(zip(out, summed))


def train_worker(cfg):
    """One rank of ``tools/train_torch.py`` (``launch``'s ``main_func``)."""
    cfg = default_setup(cfg)
    trainer = TRAINERS.build(
        dict(type=cfg.get("train", {}).get("type", "DefaultTrainer"), cfg=cfg))
    trainer.train()


def _to_numpy(tree):
    """Tensors of a nested dict/list -> numpy (host) arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_tensor(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _to_tensor(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensor(v) for v in tree)
    return tree


@TRAINERS.register_module("DefaultTrainer")
class Trainer(TrainerBase):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.best_metric_value = -1e9
        self.device = resolve_device(cfg.get("device", "cuda"))
        # the JAX step runs its float32 matmuls at HIGHEST precision; TF32
        # would keep ~3 decimal digits and break agreement with it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.logger.info(f"Device: {self.device}")
        self.max_epoch = cfg.eval_epoch
        self.model = self.build_model().to(self.device)
        self.train_loader = self.build_train_loader()
        self.val_loader = self.build_val_loader()
        self.writer = self.build_writer()
        self.total_steps = len(self.train_loader) * self.max_epoch
        self.scheduler = self.build_scheduler()
        self.optimizer = self.build_optimizer()
        self._host_step = 0
        self.generator = torch.Generator(device=self.device)
        n_params = sum(p.numel() for _, p in self.named_parameters())
        self.logger.info(f"Initialized state: {n_params / 1e6:.2f}M params")
        self.replicate()
        self.register_hooks(cfg.get("hooks"))

    # -- building ----------------------------------------------------------
    def build_model(self):
        model = build_model(dict(self.cfg.model))
        self.logger.info(f"Model: {self.cfg.model.type}")
        return model

    def build_train_loader(self):
        dataset = build_dataset(dict(self.cfg.data.train))
        collate = functools.partial(
            padded_collate_fn,
            mix_prob=self.cfg.get("mix_prob", 0.0),
            ignore_index=self.cfg.data.get("ignore_index", -1),
        )
        return DataLoader(
            dataset,
            batch_size=per_rank_batch(self.cfg.batch_size),
            shuffle=True,
            drop_last=True,
            collate_fn=collate,
            num_workers=self.cfg.get("num_worker", 4),
            seed=self.cfg.get("seed") or 0,
            shard_id=comm.get_rank(),
            num_shards=comm.get_world_size(),
        )

    def build_val_loader(self):
        if not self.cfg.get("evaluate", True) or "val" not in self.cfg.data:
            return None
        dataset = build_dataset(dict(self.cfg.data.val))
        collate = functools.partial(
            padded_collate_fn,
            ignore_index=self.cfg.data.get("ignore_index", -1),
        )
        return DataLoader(
            dataset,
            batch_size=per_rank_batch(self.cfg.get("batch_size_val") or None),
            shuffle=False,
            drop_last=False,
            collate_fn=collate,
            num_workers=self.cfg.get("num_worker", 4),
            shard_id=comm.get_rank(),
            num_shards=comm.get_world_size(),
        )

    def build_scheduler(self):
        return build_scheduler(
            dict(self.cfg.scheduler), self.cfg.optimizer.lr, self.total_steps
        )

    def build_writer(self):
        if not comm.is_main_process():
            return None
        try:
            from tensorboardX import SummaryWriter

            return SummaryWriter(self.cfg.save_path)
        except Exception:
            return None

    def modules(self) -> Dict[str, torch.nn.Module]:
        """The modules this trainer owns, by checkpoint subtree name
        ("" = the tree's root)."""
        return {"": self.model}

    def named_parameters(self) -> Iterator[Tuple[str, torch.nn.Parameter]]:
        for prefix, module in self.modules().items():
            for name, param in module.named_parameters():
                yield (f"{prefix}.{name}" if prefix else name), param

    def replicate(self):
        """Every rank takes rank 0's parameters and buffers (the JAX
        ``replicate_tree``): ranks build their modules from one seed, and
        this makes them equal whatever the initialisation drew."""
        if not comm.is_distributed():
            return
        modules = {id(m): m for m in (self.model, *self.modules().values())}
        for module in modules.values():
            for tensor in module.state_dict().values():
                comm.broadcast_(tensor)

    def reduce_gradients(self):
        """After the backward: every optimizer parameter the step did not
        reach (an idle PD bank, an idle PPT head, an unused embedding) takes
        a zero gradient, so that weight decay, momentum and Adam's moments
        move it as the JAX step's optimizer moves every leaf; then the
        gradients are summed over ranks."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.sum_gradients()

    def sum_gradients(self):
        """The gradients summed over ranks, in one flat bucket.  With every
        loss normalised by the global batch's counts the sum is the
        gradient of the global batch's loss, where DDP's mean would not
        be.  ``reduce_gradients`` has given every optimizer parameter a
        gradient, so every rank sums the same tensors."""
        if not comm.is_distributed():
            return
        grads = [p.grad for _, p in self.named_parameters() if p.grad is not None]
        if not grads:
            return
        flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def build_optimizer(self):
        return build_optimizer(
            dict(self.cfg.optimizer), self.named_parameters(),
            param_dicts=self.cfg.get("param_dicts"),
        )

    def _amp(self):
        """Mixed precision: with ``enable_amp`` the step's forward runs
        under bfloat16 autocast (parameters stay f32; every kernel casts to
        f32 at its boundary)."""
        if self.cfg.get("enable_amp"):
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    # -- state management ----------------------------------------------------
    def to_jax_tree(self, name: str, state_dict: Dict) -> Dict:
        """A state_dict of the module ``name`` -> its ``{params,
        batch_stats}`` tree in the JAX layout."""
        return state_dict_to_jax(state_dict)

    def from_jax_tree(self, name: str, tree: Dict) -> Dict:
        """A JAX-layout tree -> the state_dict of the module ``name``."""
        return jax_to_state_dict(tree)

    def state_dict(self) -> Dict:
        """Host numpy trees in the JAX package's checkpoint layout."""
        params, stats = {}, {}
        for name, module in self.modules().items():
            tree = self.to_jax_tree(name, module.state_dict())
            if name:
                params[name], stats[name] = tree["params"], tree["batch_stats"]
            else:
                params, stats = tree["params"], tree["batch_stats"]
        return dict(
            params=params,
            batch_stats=stats,
            opt_state=_to_numpy(self.optimizer.state_dict()),
            step=self._host_step,
        )

    def load_state_dict(self, state: Dict, rewrite=None, strict=False,
                        allow_partial_rows=False):
        """Merge a checkpoint's ``{params, batch_stats}`` into the modules
        (matching paths only; key rewrites and partial rows as the JAX
        loader)."""
        own = self.state_dict()
        merged = load_weights_into(
            {"params": own["params"], "batch_stats": own["batch_stats"]},
            {"params": state.get("params", {}),
             "batch_stats": state.get("batch_stats", {})},
            rewrite=rewrite,
            allow_partial_rows=allow_partial_rows,
        )
        for name, module in self.modules().items():
            tree = ({k: merged[k].get(name, {}) for k in merged} if name
                    else merged)
            module.load_state_dict(self.from_jax_tree(name, tree), strict=True)

    def resume_optimizer_state(self, state: Dict):
        if "opt_state" in state:
            self.optimizer.load_state_dict(_to_tensor(state["opt_state"]))
        self._host_step = int(state.get("step", 0))

    # -- the step -------------------------------------------------------------
    def device_batch(self, input_dict: Dict) -> Dict:
        """The batch's arrays on the device, its validity ``mask``, and its
        dataset condition as ``condition_name`` where its samples carry one
        (PD norms and PPT read it)."""
        batch = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device, non_blocking=True)
            for k, v in input_dict.items()
            if isinstance(v, np.ndarray) and v.dtype != object
        }
        if "count" in batch:
            n_pad = batch["coord"].shape[1]
            batch["mask"] = (torch.arange(n_pad, device=self.device)[None, :]
                             < batch["count"][:, None])
        condition = batch_condition(input_dict)
        if condition is not None:
            batch["condition_name"] = condition
        return batch

    def _set_lr(self):
        lr = float(self.scheduler(self._host_step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        return lr

    def _train_mode(self, training: bool):
        for module in self.modules().values():
            module.train(training)

    def forward_train(self, model, batch: Dict):
        """``model(batch)`` in a train step: a model that takes a generator
        (drop path) gets the trainer's."""
        if takes_generator(model):
            return model(batch, generator=self.generator)
        return model(batch)

    def compute_loss(self, out: Dict, batch: Dict):
        """(total loss, its 0-d parts) per the reference contract
        (models/default.py:46-62), as the JAX ``Trainer.compute_loss``: a
        model that computed its own ``loss`` (CAC, later PointGroup and
        MSC) hands it over with its scalar parts for the log; otherwise the
        loss is ``model.loss`` of the segmentation logits."""
        if "loss" in out:
            parts = {k: v for k, v in out.items()
                     if k != "loss" and torch.is_tensor(v) and v.dim() == 0}
            return out["loss"], parts
        if "seg_logits" in out:
            return self.model.loss(out["seg_logits"], batch["segment"]), {}
        if "cls_logits" in out:
            raise NotImplementedError(
                "cls_logits: DefaultClassifier is not ported; see ROADMAP")
        raise KeyError("model output lacks loss / seg_logits / cls_logits")

    def train_step(self, batch: Dict) -> Dict:
        """Forward, loss, backward and one optimizer step; the output dict
        holds ``loss`` and the loss's parts as 0-d tensors (no host
        synchronisation here)."""
        self._train_mode(True)
        self.optimizer.zero_grad(set_to_none=True)
        with self._amp():
            out = self.forward_train(self.model, batch)
            loss, parts = self.compute_loss(out, batch)
        loss.backward()
        self.reduce_gradients()
        self.optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    def eval_step(self, batch: Dict) -> Dict:
        self._train_mode(False)
        with torch.inference_mode():
            return self.model(batch)

    def run_step(self):
        batch = self.device_batch(self.comm_info["input_dict"])
        self._dispatch_train(batch)

    def _dispatch_train(self, batch, *args):
        lr = self._set_lr()
        self.generator.manual_seed(step_seed(self.cfg.get("seed") or 0,
                                             self._host_step, comm.get_rank()))
        out = self.train_step(batch, *args)
        self._host_step += 1
        self.comm_info["model_output_dict"] = global_outputs(out)
        self.comm_info["lr"] = lr

    def train(self):
        self.logger.info(
            f">>>>>>>>>>>>>>>> Start Training ({self.max_epoch} epochs, "
            f"{len(self.train_loader)} iters/epoch) >>>>>>>>>>>>>>>>"
        )
        super().train()
        if self.writer is not None:
            self.writer.close()
        self.logger.info("==>> Training done.")


@TRAINERS.register_module("OpenSegTrainer")
class OpenSegTrainer(Trainer):
    """Open-set trainer: backbone + recognizer trained jointly.

    Reference: pointcept/engines/train.py:313-499.  The forward-hook
    machinery is the backbone's ``intermediates`` return; backbone and
    recognizer share one optimizer (the reference's joint
    build_open_optimizer, train.py:393-399); while the recognizer's loss
    weight is zero its parameters are frozen as the JAX step freezes them:
    they take a zero gradient, the optimizer steps (its state moves: the
    momentum trace gathers weight decay, Adam's step count advances) and
    the parameters are put back bit for bit.  The PDF pseudo-labelling runs
    on the host between a device score pass and the train step.
    """

    def __init__(self, cfg):
        from ..recognizers import build_recognizer

        self.recognizer = build_recognizer(cfg.recognizer)
        self._rec_module = (self.recognizer.model
                            if getattr(self.recognizer, "has_params", False)
                            else None)
        if self._rec_module is not None:
            self._rec_module.to(resolve_device(cfg.get("device", "cuda")))
        super().__init__(cfg)
        if self._rec_module is not None:
            n_rec = sum(p.numel() for p in self._rec_module.parameters())
            self.logger.info(f"Num params of recognizer: {n_rec}")
        self.eval_only = cfg.get("eval_only", False)
        self.best_metric_value = {}  # metric name -> best value
        self._pending = None  # pipelined (batch, rec_w, flagged) awaiting train

    def modules(self):
        modules = {"model": self.model}
        if self._rec_module is not None:
            modules["recognizer"] = self._rec_module
        return modules

    def state_dict(self):
        state = super().state_dict()
        state["params"].setdefault("recognizer", {})
        state["batch_stats"].setdefault("recognizer", {})
        return state

    # -- label handling ------------------------------------------------------
    def device_batch(self, input_dict: Dict) -> Dict:
        input_dict = dict(input_dict)
        # open-set label rename (reference train.py:387-391): train on
        # known-masked labels, keep the oracle for evaluation
        if "segment_known" in input_dict:
            input_dict["segment_oracle"] = input_dict["segment"]
            input_dict["segment"] = input_dict["segment_known"]
        if "segment_pseudo" not in input_dict and "segment" in input_dict:
            input_dict["segment_pseudo"] = input_dict["segment"]
        return super().device_batch(input_dict)

    # -- data ------------------------------------------------------------------
    def build_train_loader(self):
        loader = super().build_train_loader()
        # optional random subsampling of the train scenes (reference
        # engines/train.py:428-436, train_subsampling_ratio)
        ratio = self.cfg.get("train_subsampling_ratio", -1.0)
        if ratio > 0.0:
            n = len(loader.dataset)
            keep = int(ratio * n)
            rng = np.random.RandomState(self.cfg.get("seed") or 0)
            picked = np.sort(rng.permutation(n)[:keep])
            loader.dataset = Subset(loader.dataset, picked)
            self.logger.info(
                f"Train subsampling: kept {keep}/{n} scenes (ratio={ratio})"
            )
        return loader

    # -- steps -------------------------------------------------------------------
    def train_step(self, batch: Dict, rec_w: float = 0.0) -> Dict:
        rec = self.recognizer
        self._train_mode(True)
        frozen = self._rec_module is not None and not rec_w > 0
        if self._rec_module is not None:
            # no backward pass through a frozen recognizer: its gradient is
            # exactly zero (the loss holds it times a weight of 0)
            self._rec_module.requires_grad_(not frozen)
        self.optimizer.zero_grad(set_to_none=True)
        with self._amp():
            out = self.forward_train(self.model, batch)
            seg_logits = out["seg_logits"]
            seg_loss = self.model.loss(seg_logits, batch["segment"])
            parts = {"seg_loss": seg_loss}
            loss = seg_loss
            if self._rec_module is not None:
                rec_raw = self._rec_module(out["intermediates"])
                rec_l = rec.rec_loss(seg_logits, rec_raw,
                                     batch["segment_pseudo"])
                loss = seg_loss + rec_w * rec_l
                parts["loss_rec"] = rec_l
            parts["loss"] = loss
        loss.backward()
        self.reduce_gradients()
        if frozen:
            # the optimizer state of a frozen recognizer moves as in the JAX
            # step (which zeroes its updates, not its gradients): step on a
            # zero gradient, then put the parameters back
            rec_params = list(self._rec_module.parameters())
            kept = [p.detach().clone() for p in rec_params]
            for p in rec_params:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        if frozen:
            with torch.no_grad():
                for p, old in zip(rec_params, kept):
                    p.copy_(old)
        return {k: v.detach() for k, v in parts.items()}

    def eval_step(self, batch: Dict) -> Dict:
        self._train_mode(False)
        with torch.inference_mode():
            out = self.model(batch)
            seg_logits = out["seg_logits"]
            if self._rec_module is not None:
                score = self.recognizer.score(
                    seg_logits, self._rec_module(out["intermediates"]))
            else:
                score = self.recognizer.score(seg_logits)
        return {"seg_logits": seg_logits, "score": score}

    def pseudo_forward(self, batch: Dict):
        """Eval forward -> the two (B, N) score sheets the host graph stage
        reads (2 floats per point to fetch instead of the logits)."""
        self._train_mode(False)
        with torch.inference_mode():
            out = self.model(batch)
            return self.recognizer.pseudo_scores(out["seg_logits"],
                                                 batch["mask"])

    def _host_radii(self, coord_h, count_h):
        """Per-sample ball radius: static, or the reference's adaptive
        min-extent/16 (pointpdf_v1m1_base.py:118-137)."""
        rec = self.recognizer
        radii = np.full((coord_h.shape[0],), rec.kp_ball_radius, np.float64)
        if rec.adaptive_radius:
            for i in range(coord_h.shape[0]):
                c = int(count_h[i])
                if c:
                    pts = coord_h[i, :c]
                    radii[i] = float((pts.max(0) - pts.min(0) + 1e-6).min()
                                     / 16.0)
        return radii

    # -- the step ---------------------------------------------------------------
    #
    # Pseudo-labelling pipeline (one-batch delay): the train step for batch
    # t-1 is launched right after the score pass for batch t, so the device
    # works on t-1's forward + backward WHILE the host waits for t's two
    # score sheets (copied to pinned memory behind the score pass, ahead of
    # the train step on the stream) and runs the graph stage (mean-shift ->
    # MST -> GMM -> CC).  This only makes the scores one optimizer update
    # staler than the reference's in-step computation.  Neighbour tables are
    # lazy cKDTree rows (LazyNeighborTable): the chain reads ~2% of the
    # cloud.
    def _dispatch_train(self, batch, rec_w, pseudo_flagged=None):
        super()._dispatch_train(batch, rec_w)
        if pseudo_flagged is not None:
            self.comm_info["model_output_dict"]["pseudo_flagged"] = pseudo_flagged

    def _flush_pending(self):
        if self._pending is not None:
            batch, rec_w, flagged = self._pending
            self._pending = None
            self._dispatch_train(batch, rec_w, flagged)

    def _call_hooks(self, stage: str) -> None:
        # evaluation/checkpointing must see the fully-trained state
        if stage in ("after_epoch", "after_train"):
            self._flush_pending()
        super()._call_hooks(stage)

    def _fetch(self, *tensors):
        """Start copying device tensors to the host through pinned memory;
        returns the host tensors and a ``ready()`` that waits only for the
        work queued before this call."""
        if self.device.type != "cuda":
            return list(tensors), lambda: None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done.synchronize

    def pseudo_masks(self, input_dict: Dict, msp: np.ndarray, ml: np.ndarray
                     ) -> np.ndarray:
        """The host graph stage on a batch's two score sheets: (B, N) masks
        of the points to pseudo-label unknown.  An item's seed follows its
        place in the global batch (rank r's j-th item is item j * world + r
        of it, the loader's shard order) and the host step."""
        coord_h = np.asarray(input_dict["coord"], np.float32)
        count_h = np.asarray(input_dict["count"])
        items = np.arange(len(count_h)) * comm.get_world_size() + comm.get_rank()
        return self.recognizer.pseudo_masks_from_scores(
            coord_h, msp, ml, count_h,
            seed=(self.cfg.get("seed") or 0) + self._host_step + items,
            neighbors=None,
            ball_radius=self._host_radii(coord_h, count_h),
        )

    def run_step(self):
        input_dict = self.comm_info["input_dict"]
        batch = self.device_batch(input_dict)
        rec = self.recognizer
        rec.set_epoch(self.epoch)
        rec_w = rec.loss_weight(self.epoch)
        if not (getattr(rec, "has_pseudo_labeling", False)
                and rec.needs_pseudo(self.epoch)):
            self._dispatch_train(batch, rec_w)
            return

        # 1. device: score pass for THIS batch, and its copy to the host
        (msp_h, ml_h), ready = self._fetch(*self.pseudo_forward(batch))
        # 2. device: train step for the PREVIOUS batch (mask ready)
        self._flush_pending()
        # 3. host: the score sheets + graph stage, overlapped with step 2
        ready()
        masks = self.pseudo_masks(input_dict, msp_h.numpy(), ml_h.numpy())
        # host copy of the TRAIN labels (post label-rename semantics:
        # device_batch substitutes segment_known when present)
        segment = np.asarray(input_dict.get("segment_known",
                                            input_dict["segment"]))
        segment_pseudo = np.where(masks, rec.num_classes, segment)
        batch["segment_pseudo"] = torch.from_numpy(segment_pseudo).to(
            self.device, non_blocking=True)
        # surfaced via InformationWriter so runs can see the
        # pseudo-labelling fire
        count_h = np.asarray(input_dict["count"])
        valid = np.arange(masks.shape[1])[None, :] < count_h.reshape(-1, 1)
        n_flagged, n_valid = np.sum(comm.all_gather(
            (int(masks[valid].sum()), int(valid.sum()))), axis=0)
        flagged = float(n_flagged / n_valid) if n_valid else 0.0
        self._pending = (batch, rec_w, flagged)

    def train(self):
        if self.eval_only:
            self.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
            with EventStorage(self.start_epoch) as self.storage:
                self._call_hooks("before_train")
                for epoch in range(self.start_epoch, self.max_epoch):
                    self.epoch = epoch
                    self._call_hooks("after_epoch")
                self._call_hooks("after_train")
            return
        super().train()


@TRAINERS.register_module("IncrSegTrainer")
class IncrSegTrainer(Trainer):
    """Incremental-learning trainer: a frozen teacher distils into an
    extended student.

    Reference: pointcept/engines/train.py:502-566.  ``self.model`` is the
    base (teacher) segmentor: loaded from the base checkpoint
    (``load_teacher_state``), kept in eval mode, never optimised, its
    forward under ``torch.no_grad()``.  The student (the learner's
    ``model``, a bare backbone) is the only module the optimizer and the
    checkpoints hold, under ``incr`` as in the JAX package.
    """

    def __init__(self, cfg):
        from ..incr_learners import build_incremental_learner

        self.incr_learner = build_incremental_learner(cfg.incremental_learner)
        self.student = self.incr_learner.model.to(
            resolve_device(cfg.get("device", "cuda")))
        super().__init__(cfg)
        self.model.requires_grad_(False)
        self.model.eval()
        self.best_metric_value = {}

    def modules(self):
        return {"incr": self.student}

    def to_jax_tree(self, name, state_dict):
        return backbone_state_dict_to_jax(state_dict)

    def from_jax_tree(self, name, tree):
        return jax_to_backbone_state_dict(tree)

    def load_teacher_state(self, state: Dict):
        """Merge a base checkpoint's ``{params, batch_stats}`` (a segmentor
        tree) into the teacher, matching paths only."""
        own = state_dict_to_jax(self.model.state_dict())
        merged = load_weights_into(
            own, {"params": state.get("params", {}),
                  "batch_stats": state.get("batch_stats", {})})
        self.model.load_state_dict(jax_to_state_dict(merged), strict=True)

    @staticmethod
    def logits_of(out):
        if isinstance(out, tuple):
            return out[0]
        if isinstance(out, dict):
            return out["seg_logits"]
        return out

    def teacher_logits(self, batch: Dict) -> torch.Tensor:
        with torch.no_grad():
            return self.logits_of(self.model(batch))

    def train_step(self, batch: Dict) -> Dict:
        self._train_mode(True)
        self.optimizer.zero_grad(set_to_none=True)
        with self._amp():
            student = self.logits_of(self.forward_train(self.student, batch))
            loss = self.incr_learner.distill_loss(
                student, self.teacher_logits(batch), batch["segment_incr"],
                batch["mask"])
        loss.backward()
        self.reduce_gradients()
        self.optimizer.step()
        return {"loss": loss.detach()}

    def eval_step(self, batch: Dict) -> Dict:
        self._train_mode(False)
        with torch.inference_mode():
            seg_logits = self.logits_of(self.student(batch))
            loss = self.incr_learner.eval_loss(seg_logits,
                                               batch["segment_incr_remap"])
        return {"seg_logits": seg_logits, "loss": loss}


@TRAINERS.register_module("MultiDatasetTrainer")
class MultiDatasetTrainer(Trainer):
    """Joint training over several datasets (Point Prompt Training).

    Reference: pointcept/engines/train.py:296-310, the JAX
    ``MultiDatasetTrainer``: the train loader is a ``MultiDatasetDataloader``
    over the config's ``ConcatDataset``, whose batches each hold one
    dataset's samples.  A batch's condition (its samples' ``condition``)
    reaches the model as ``condition_name`` (``Trainer.device_batch``) in
    the training, evaluator and ``PreciseEvaluator`` forwards alike.  Over
    several ranks every rank takes the same dataset at every step (the
    sub-loaders' lengths are checked equal once, each step's condition
    every step), so a PD bank's statistics are summed within one condition
    and every rank's step reaches the same parameters."""

    def build_train_loader(self):
        dataset = build_dataset(dict(self.cfg.data.train))
        collate = functools.partial(
            padded_collate_fn,
            mix_prob=self.cfg.get("mix_prob", 0.0),
            ignore_index=self.cfg.data.get("ignore_index", -1),
        )
        loader = MultiDatasetDataloader(
            dataset,
            batch_size=per_rank_batch(self.cfg.batch_size),
            collate_fn=collate,
            num_workers=self.cfg.get("num_worker", 4),
            seed=self.cfg.get("seed") or 0,
            shard_id=comm.get_rank(),
            num_shards=comm.get_world_size(),
        )
        if comm.is_distributed():
            lengths = comm.all_gather(loader.lengths())
            if any(n != lengths[0] for n in lengths):
                raise RuntimeError(f"sub-loader lengths differ between ranks: {lengths}")
        return loader

    def run_step(self):
        input_dict = self.comm_info["input_dict"]
        condition = batch_condition(input_dict)
        if condition is None:
            raise ValueError("MultiDatasetTrainer: the batch's samples carry no condition")
        if comm.is_distributed():
            conditions = comm.all_gather(condition)
            if len(set(conditions)) != 1:
                raise RuntimeError(f"ranks took different conditions at one step: "
                                   f"{conditions}")
        self.comm_info["condition"] = condition
        super().run_step()
