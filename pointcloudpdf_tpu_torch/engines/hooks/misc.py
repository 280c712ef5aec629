# Copied from pointcloudpdf_tpu/engines/hooks/misc.py (the timer, writer and
# checkpoint hooks, the incremental ones included, and PreciseEvaluator; the
# trainer's state_dict is already host numpy, so to_host is gone); keep in
# step.
"""Misc hooks: timing, logging, checkpoint save/load.

Equivalents of the reference hook zoo (pointcept/engines/hooks/misc.py):
IterationTimer (step timing + ETA), InformationWriter (console +
tensorboard scalars), CheckpointSaver (last + per-metric best snapshots,
atomic), CheckpointLoader (resume / finetune with key rewrites),
PreciseEvaluator (the configured tester after training).  The
checkpoints keep the JAX package's keys and tree layout, so either
package's testers load them.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from ...utils import comm
from ...utils.checkpoint import load_checkpoint, save_checkpoint
from .builder import HOOKS
from .default import HookBase


@HOOKS.register_module()
class IterationTimer(HookBase):
    """Tracks data/batch time and logs an ETA (reference misc.py:34-77)."""

    def __init__(self, warmup_iter: int = 2):
        self._warmup_iter = warmup_iter
        self._start_time = time.perf_counter()
        self._iter_timer = time.perf_counter()
        self._remain_iter = 0

    def before_train(self):
        self._start_time = time.perf_counter()
        self._remain_iter = self.trainer.max_epoch * len(self.trainer.train_loader)

    def before_epoch(self):
        self._iter_timer = time.perf_counter()

    def before_step(self):
        data_time = time.perf_counter() - self._iter_timer
        self.trainer.storage.put_scalar("data_time", data_time)

    def after_step(self):
        batch_time = time.perf_counter() - self._iter_timer
        self._iter_timer = time.perf_counter()
        self.trainer.storage.put_scalar("batch_time", batch_time)
        self._remain_iter -= 1
        remain_time = self._remain_iter * self.trainer.storage.history(
            "batch_time"
        ).avg(50)
        t_m, t_s = divmod(remain_time, 60)
        t_h, t_m = divmod(t_m, 60)
        self.trainer.comm_info["iter_info"] = self.trainer.comm_info.get(
            "iter_info", ""
        ) + (
            f"Data {self.trainer.storage.history('data_time').latest():.3f} "
            f"({self.trainer.storage.history('data_time').avg(50):.3f}) "
            f"Batch {batch_time:.3f} "
            f"({self.trainer.storage.history('batch_time').avg(50):.3f}) "
            f"Remain {int(t_h):02d}:{int(t_m):02d}:{int(t_s):02d} "
        )


@HOOKS.register_module()
class InformationWriter(HookBase):
    """Per-iteration console log + scalar writer (reference misc.py:80-145)."""

    def __init__(self, log_interval: int = 1):
        self.log_interval = log_interval
        self.curr_iter = 0

    def before_train(self):
        self.trainer.comm_info["iter_info"] = ""
        self.curr_iter = self.trainer.start_epoch * len(self.trainer.train_loader)

    def before_step(self):
        self.curr_iter += 1
        info = (
            f"Train: [{self.trainer.epoch + 1}/{self.trainer.max_epoch}]"
            f"[{self.trainer.comm_info.get('iter', 0) + 1}"
            f"/{len(self.trainer.train_loader)}] "
        )
        self.trainer.comm_info["iter_info"] = info + self.trainer.comm_info.get(
            "iter_info", ""
        )

    def after_step(self):
        if "model_output_dict" in self.trainer.comm_info:
            output = self.trainer.comm_info["model_output_dict"]
            for key, value in output.items():
                if np.isscalar(value) or getattr(value, "ndim", 1) == 0:
                    self.trainer.storage.put_scalar(key, float(value))
                    self.trainer.comm_info["iter_info"] += (
                        f"{key}: {float(value):.4f} "
                    )
        lr = self.trainer.comm_info.get("lr")
        if lr is not None:
            self.trainer.comm_info["iter_info"] += f"Lr: {lr:.5g}"
        if (self.trainer.comm_info.get("iter", 0) + 1) % self.log_interval == 0:
            self.trainer.logger.info(self.trainer.comm_info["iter_info"])
        self.trainer.comm_info["iter_info"] = ""
        if self.trainer.writer is not None:
            self.trainer.writer.add_scalar(
                "lr", lr if lr is not None else 0.0, self.curr_iter
            )
            for key in ("loss", "seg_loss", "recognizer_loss"):
                if key in self.trainer.comm_info.get("model_output_dict", {}):
                    self.trainer.writer.add_scalar(
                        "train_batch/" + key,
                        float(self.trainer.comm_info["model_output_dict"][key]),
                        self.curr_iter,
                    )

    def after_epoch(self):
        epoch_info = f"Train result: [{self.trainer.epoch + 1}/{self.trainer.max_epoch}] "
        for name, his in self.trainer.storage.histories().items():
            if name in ("data_time", "batch_time"):
                continue
            epoch_info += f"{name}: {his.avg(len(self.trainer.train_loader)):.4f} "
            if self.trainer.writer is not None:
                self.trainer.writer.add_scalar(
                    "train/" + name,
                    his.avg(len(self.trainer.train_loader)),
                    self.trainer.epoch + 1,
                )
        self.trainer.logger.info(epoch_info)


@HOOKS.register_module()
class CheckpointSaver(HookBase):
    """Save model_last + model_best snapshots each epoch
    (reference misc.py:148-206)."""

    def __init__(self, save_freq=None):
        self.save_freq = save_freq  # None: only last+best

    def after_epoch(self):
        if not comm.is_main_process():
            return
        trainer = self.trainer
        is_best = False
        current_metric_value = trainer.comm_info.get("current_metric_value")
        current_metric_name = trainer.comm_info.get("current_metric_name")
        if current_metric_value is not None:
            if current_metric_value > trainer.best_metric_value:
                trainer.best_metric_value = current_metric_value
                is_best = True
                trainer.logger.info(
                    f"Best validation {current_metric_name} updated to "
                    f"{current_metric_value:.4f}"
                )
            trainer.logger.info(
                f"Currently Best {current_metric_name}: "
                f"{trainer.best_metric_value:.4f}"
            )

        save_dir = os.path.join(trainer.cfg.save_path, "model")
        payload = dict(
            epoch=trainer.epoch + 1,
            state=trainer.state_dict(),
            best_metric_value=trainer.best_metric_value,
        )
        last_path = os.path.join(save_dir, "model_last.pth")
        save_checkpoint(last_path, payload)
        if is_best:
            shutil.copyfile(last_path, os.path.join(save_dir, "model_best.pth"))
            trainer.logger.info(f"Saved model_best at epoch {trainer.epoch + 1}")
        if self.save_freq and (trainer.epoch + 1) % self.save_freq == 0:
            shutil.copyfile(
                last_path,
                os.path.join(save_dir, f"epoch_{trainer.epoch + 1}.pth"),
            )


@HOOKS.register_module()
class CheckpointLoader(HookBase):
    """Resume / finetune weight loading (reference misc.py:454-560)."""

    def __init__(self, keywords="", replacement=None, strict=False):
        self.keywords = keywords
        self.replacement = replacement if replacement is not None else keywords
        self.strict = strict

    def before_train(self):
        trainer = self.trainer
        cfg = trainer.cfg
        weight_path = cfg.get("weight")
        if not weight_path:
            return
        if not os.path.isfile(weight_path):
            raise FileNotFoundError(f"checkpoint not found: {weight_path}")
        trainer.logger.info(f"Loading checkpoint: {weight_path}")
        payload = load_checkpoint(weight_path)
        rewrite = {self.keywords: self.replacement} if self.keywords else None
        trainer.load_state_dict(
            payload["state"], rewrite=rewrite, strict=self.strict
        )
        if cfg.get("resume"):
            trainer.start_epoch = payload.get("epoch", 0)
            trainer.best_metric_value = payload.get("best_metric_value", -1e9)
            trainer.resume_optimizer_state(payload["state"])
            trainer.logger.info(f"Resuming at epoch {trainer.start_epoch}")


@HOOKS.register_module()
class OpenSegCheckpointSaver(HookBase):
    """Multi-metric best tracking for open-set training.

    Reference: pointcept/engines/hooks/misc.py:209-321 — the evaluator
    hands a [mIoU, aupr, auroc] triple; each metric keeps its own
    ``model_best_<name>.pth`` snapshot plus the rolling ``model_last``.
    """

    def __init__(self, save_freq=None):
        self.save_freq = save_freq

    def after_epoch(self):
        if not comm.is_main_process():
            return
        trainer = self.trainer
        values = trainer.comm_info.get("current_metric_value")
        names = trainer.comm_info.get("current_metric_name")
        best_names = []
        if values is not None and names is not None:
            if not isinstance(trainer.best_metric_value, dict):
                trainer.best_metric_value = {}
            for name, value in zip(names, values):
                if not np.isfinite(value):
                    continue
                prev = trainer.best_metric_value.get(name, -np.inf)
                if value > prev:
                    trainer.best_metric_value[name] = value
                    best_names.append(name)
                    trainer.logger.info(
                        f"Best validation {name} updated to {value:.4f}"
                    )
                trainer.logger.info(
                    f"Currently Best {name}: "
                    f"{trainer.best_metric_value.get(name, -np.inf):.4f}"
                )

        save_dir = os.path.join(trainer.cfg.save_path, "model")
        payload = dict(
            epoch=trainer.epoch + 1,
            state=trainer.state_dict(),
            best_metric_value=trainer.best_metric_value,
        )
        last_path = os.path.join(save_dir, "model_last.pth")
        save_checkpoint(last_path, payload)
        for name in best_names:
            shutil.copyfile(
                last_path, os.path.join(save_dir, f"model_best_{name}.pth")
            )
            trainer.logger.info(
                f"Saved model_best_{name} at epoch {trainer.epoch + 1}"
            )
        if self.save_freq and (trainer.epoch + 1) % self.save_freq == 0:
            shutil.copyfile(
                last_path,
                os.path.join(save_dir, f"epoch_{trainer.epoch + 1}.pth"),
            )


@HOOKS.register_module()
class OpenSegCheckpointLoader(HookBase):
    """Checkpoint loading into the joint {model, recognizer} state.

    Reference: pointcept/engines/hooks/misc.py:555-593 — supports loading
    a closed-set checkpoint (params tree without the recognizer split) as
    backbone initialization for open-set finetune, plus plain resume.
    """

    def __init__(self, keywords="", replacement=None, strict=False):
        self.keywords = keywords
        self.replacement = replacement if replacement is not None else keywords
        self.strict = strict

    def before_train(self):
        trainer = self.trainer
        cfg = trainer.cfg
        weight_path = cfg.get("weight")
        if not weight_path:
            return
        if not os.path.isfile(weight_path):
            raise FileNotFoundError(f"checkpoint not found: {weight_path}")
        trainer.logger.info(f"Loading checkpoint: {weight_path}")
        payload = load_checkpoint(weight_path)
        state = dict(payload["state"])
        params = state.get("params", {})
        if not ("model" in params and "recognizer" in params):
            # closed-set checkpoint: nest under the open-set layout
            state["params"] = {"model": params, "recognizer": {}}
            state["batch_stats"] = {
                "model": state.get("batch_stats", {}),
                "recognizer": {},
            }
            trainer.logger.info(
                "Closed-set checkpoint detected: loading as backbone weights"
            )
        rewrite = {self.keywords: self.replacement} if self.keywords else None
        trainer.load_state_dict(state, rewrite=rewrite, strict=self.strict)
        if cfg.get("resume"):
            trainer.start_epoch = payload.get("epoch", 0)
            best = payload.get("best_metric_value", {})
            trainer.best_metric_value = best if isinstance(best, dict) else {}
            trainer.resume_optimizer_state(state)
            trainer.logger.info(f"Resuming at epoch {trainer.start_epoch}")


@HOOKS.register_module()
class IncrSegCheckpointSaver(OpenSegCheckpointSaver):
    """Multi-metric saver for incremental training; adds late-epoch best
    snapshots (reference misc.py:324-451 ``tracked_epoch`` variants)."""

    def __init__(self, save_freq=None, tracked_best_metrics=None,
                 tracked_epoch=None):
        super().__init__(save_freq)
        self.tracked_best_metrics = tracked_best_metrics
        self.tracked_epoch = tracked_epoch
        self._late_best = {}

    def after_epoch(self):
        super().after_epoch()
        if not comm.is_main_process() or self.tracked_epoch is None:
            return
        trainer = self.trainer
        if trainer.epoch + 1 < self.tracked_epoch:
            return
        values = trainer.comm_info.get("current_metric_value")
        names = trainer.comm_info.get("current_metric_name")
        if values is None or names is None:
            return
        save_dir = os.path.join(trainer.cfg.save_path, "model")
        last_path = os.path.join(save_dir, "model_last.pth")
        for name, value in zip(names, values):
            if self.tracked_best_metrics and name not in self.tracked_best_metrics:
                continue
            if np.isfinite(value) and value > self._late_best.get(name, -np.inf):
                self._late_best[name] = value
                shutil.copyfile(
                    last_path,
                    os.path.join(
                        save_dir, f"model_best_{name}_late{self.tracked_epoch}.pth"
                    ),
                )


@HOOKS.register_module()
class IncrSegCheckpointLoader(HookBase):
    """Base->incremental weight transfer.

    Reference: pointcept/engines/hooks/misc.py:596-725.  The base (teacher)
    checkpoint loads into the frozen teacher; with
    ``load_base_weight_to_incr_learner`` its backbone also initializes the
    student with the class-head rows trimmed/partial-copied
    (``trim_base_weight_head``) or only exact-shape matches kept
    (``reserve_matched``).
    """

    def __init__(self, keywords="", replacement=None, strict=False):
        self.keywords = keywords
        self.replacement = replacement if replacement is not None else keywords
        self.strict = strict

    def before_train(self):
        trainer = self.trainer
        cfg = trainer.cfg
        if cfg.get("incr_resume") and cfg.get("resume"):
            raise RuntimeError(
                "Incremental model cannot resume from base and incremental "
                "checkpoints at the same time."
            )

        base_state = None
        base_path = cfg.get("base_ckpt") or cfg.get("weight")
        if base_path:
            if not os.path.isfile(base_path):
                raise FileNotFoundError(f"base checkpoint not found: {base_path}")
            trainer.logger.info(f"Loading base checkpoint: {base_path}")
            payload = load_checkpoint(base_path)
            base_state = dict(payload["state"])
            params = base_state.get("params", {})
            if isinstance(params, dict) and "model" in params:
                # open-set checkpoint: teacher = its model subtree
                base_state = dict(
                    params=params["model"],
                    batch_stats=base_state.get("batch_stats", {}).get("model", {}),
                )
            trainer.load_teacher_state(base_state)

        if cfg.get("incr_resume") and cfg.get("incr_ckpt"):
            trainer.logger.info(f"Resuming student from {cfg.incr_ckpt}")
            payload = load_checkpoint(cfg.incr_ckpt)
            trainer.load_state_dict(payload["state"])
            trainer.start_epoch = payload.get("epoch", 0)
            best = payload.get("best_metric_value", {})
            trainer.best_metric_value = best if isinstance(best, dict) else {}
            trainer.resume_optimizer_state(payload["state"])
        elif cfg.get("load_base_weight_to_incr_learner", True) and base_state:
            # student init from base backbone with head trim / reserve-match
            process = cfg.get("base_weight_process_func", "trim_base_weight_head")
            partial = process == "trim_base_weight_head"
            trainer.logger.info(
                f"Loading base weights into the student ({process}) ..."
            )
            trainer.load_state_dict(
                {
                    "params": {"incr": base_state.get("params", {})},
                    "batch_stats": {"incr": base_state.get("batch_stats", {})},
                },
                # DefaultSegmentor nests the backbone under backbone_module;
                # the student tree is the bare backbone
                rewrite={"backbone_module/": ""},
                allow_partial_rows=partial,
            )


@HOOKS.register_module()
class PreciseEvaluator(HookBase):
    """Run the full fragment tester in-process after training
    (reference misc.py:769-793), on ``model_best.pth`` (``model_best_mIoU``
    after a multi-metric saver), or on ``model_last.pth`` with
    ``test_last``.  Every rank runs it, once rank 0 has saved: the tester
    shares the scenes out and reports on rank 0."""

    def __init__(self, test_last: bool = False):
        self.test_last = test_last

    def after_train(self):
        trainer = self.trainer
        trainer.logger.info(
            ">>>>>>>>>>>>>>>> Start Precise Evaluation >>>>>>>>>>>>>>>>"
        )
        from ..test import TESTERS

        comm.synchronize()
        cfg = trainer.cfg
        if self.test_last:
            cfg.weight = os.path.join(cfg.save_path, "model", "model_last.pth")
        else:
            best = (
                "model_best.pth"
                if not isinstance(trainer.best_metric_value, dict)
                else "model_best_mIoU.pth"
            )
            cfg.weight = os.path.join(cfg.save_path, "model", best)
        test_cfg = cfg.get("test", {}) or {}
        tester = TESTERS.build(
            dict(type=test_cfg.get("type", "SemSegTester"), cfg=cfg)
        )
        tester.test()
