"""Testers: full-scene inference via complementary voxel fragments.

Counterpart of ``pointcloudpdf_tpu/engines/test.py`` (``TesterBase``,
``SemSegTester``, ``OpenSegTester``, ``IncrSegTester``): each fragment is
padded to its bucket (its dataset ``condition``, where the test transform
adds one, carried to the model), run through the model under
``torch.inference_mode()`` on ``cfg.device``, and its softmax vote / score
scatter-mean back to full resolution happens on the host in numpy.  The
checkpoint is the JAX package's pickled numpy tree, carried onto the
torch modules by ``bridge.jax_to_state_dict`` and loaded with
``strict=True``.  Over several ranks each takes every world-th scene and
writes its predictions; rank 0 gathers the per-scene records and reports
the metrics, in scene order, as one process would.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict

import numpy as np
import torch

from ..bridge import jax_to_backbone_state_dict, jax_to_state_dict
from ..datasets import build_dataset
from ..datasets.utils import padded_collate_fn
from ..models import build_model
from ..utils import comm
from ..utils.checkpoint import load_checkpoint
from ..utils.events import AverageMeter
from ..utils.logger import get_root_logger
from ..utils.misc import (
    aupr_and_auroc,
    intersection_and_union_np,
    make_dirs,
    selected_mask,
)
from ..utils.registry import Registry
from .defaults import batch_condition
from .hooks.evaluator import incr_class_sets, metric_triple

TESTERS = Registry("testers")


def resolve_device(name) -> torch.device:
    """The device a run asked for; CUDA that is absent raises (the CPU
    runs only when asked for by name)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{name}' asked for but CUDA is not available; pass "
            "device=cpu to run on the CPU")
    if device.type == "cuda" and device.index is None and comm.is_distributed():
        # a rank's card, as ``launch`` set it
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class TesterBase:
    """Owns the model, its weights and the test dataset; subclasses drive
    the scenes."""

    def __init__(self, cfg):
        self.logger = get_root_logger(
            log_file=os.path.join(cfg.save_path, "test.log")
            if cfg.save_path and comm.is_main_process() else None,
        )
        self.logger.info("=> Loading config ...")
        self.cfg = cfg
        self.device = resolve_device(cfg.get("device", "cuda"))
        # the JAX forward runs its float32 matmuls at HIGHEST precision;
        # TF32 would keep ~3 decimal digits and break agreement with it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = self.build_model()
        self.model.to(self.device).eval()
        self.test_dataset = self.build_test_dataset()
        self._checkpoint = None
        self._weights_loaded = False

    # -- building ------------------------------------------------------------
    def build_model(self):
        self.logger.info("=> Building model ...")
        return build_model(dict(self.cfg.model))

    def build_test_dataset(self):
        self.logger.info("=> Building test dataset ...")
        return build_dataset(dict(self.cfg.data.test))

    def load_checkpoint_payload(self) -> Dict:
        if self._checkpoint is None:
            weight = self.cfg.get("weight")
            if not weight or not os.path.isfile(weight):
                raise RuntimeError(f"=> No checkpoint found at '{weight}'")
            self.logger.info(f"Loading weight at: {weight}")
            self._checkpoint = load_checkpoint(weight)
            self.logger.info(
                f"=> Loaded weight '{weight}' "
                f"(epoch {self._checkpoint.get('epoch')})"
            )
        return self._checkpoint

    def checkpoint_model_state(self):
        """(params, batch_stats) of the segmentor from either a closed-set
        or an open-set (joint {model, recognizer}) checkpoint."""
        state = self.load_checkpoint_payload()["state"]
        params = state["params"]
        stats = state.get("batch_stats", {})
        if isinstance(params, dict) and "model" in params and "recognizer" in params:
            return params["model"], stats.get("model", {})
        return params, stats

    def load_weights(self):
        params, stats = self.checkpoint_model_state()
        self.model.load_state_dict(
            jax_to_state_dict({"params": params, "batch_stats": stats}),
            strict=True)

    def device_batch(self, collated: Dict) -> Dict:
        """A fragment's arrays on the device, its ``mask``, and its dataset
        condition as ``condition_name`` where the test transform put one
        on it (PD norms and PPT read it)."""
        batch = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in collated.items()
            if isinstance(v, np.ndarray) and v.dtype != object
        }
        if "count" in batch:
            n_pad = batch["coord"].shape[1]
            batch["mask"] = (torch.arange(n_pad, device=self.device)[None, :]
                             < batch["count"][:, None])
        condition = batch_condition(collated)
        if condition is not None:
            batch["condition_name"] = condition
        return batch

    def forward(self, batch: Dict) -> Dict:
        return self.model(batch)

    def forward_fragment(self, fragment: Dict) -> Dict:
        """Pad one fragment to its bucket, run the forward, return host
        arrays trimmed to the valid point count."""
        collated = padded_collate_fn(
            [fragment], ignore_index=self.cfg.data.get("ignore_index", -1)
        )
        if not self._weights_loaded:
            self.load_weights()
            self._weights_loaded = True
        batch = self.device_batch(collated)
        with torch.inference_mode():
            out = self.forward(batch)
        n = int(collated["count"][0])
        return {
            k: v[0, :n].float().cpu().numpy()
            for k, v in out.items()
            if isinstance(v, torch.Tensor) and v.dim() >= 2
        }

    def write_submit(self, save_path, data_name, pred):
        """The benchmark submission file of one scene, by the test dataset's
        type, byte for byte the JAX tester's: ScanNet / ScanNet200 class
        ids as text, SemanticKITTI raw ids (``learning_map_inv``) as uint32,
        nuScenes ``pred + 1`` as uint8; other datasets write none."""
        ds_type = self.cfg.data.test.type
        if ds_type in ("ScanNetDataset", "ScanNet200Dataset"):
            submit_dir = make_dirs(os.path.join(save_path, "submit"))
            np.savetxt(os.path.join(submit_dir, f"{data_name}.txt"),
                       self.test_dataset.class2id[pred].reshape(-1, 1), fmt="%d")
        elif ds_type == "SemanticKITTIDataset":
            sequence_name, frame_name = data_name.split("_")
            submit_dir = make_dirs(os.path.join(
                save_path, "submit", "sequences", sequence_name, "predictions"))
            inv = self.test_dataset.learning_map_inv
            # a lookup array over the table's keys (the JAX tester's
            # np.vectorize of the dict gives the same int64 values)
            low = min(inv)
            lut = np.zeros(max(inv) - low + 1, np.int64)
            for key, raw in inv.items():
                lut[key - low] = raw
            raw = lut[pred.astype(np.int64) - low]
            raw.astype(np.uint32).tofile(os.path.join(submit_dir, f"{frame_name}.label"))
        elif ds_type == "NuScenesDataset":
            submit_dir = make_dirs(os.path.join(save_path, "submit", "lidarseg", "test"))
            (pred + 1).astype(np.uint8).tofile(
                os.path.join(submit_dir, f"{data_name}_lidarseg.bin"))

    def scene_indices(self):
        """This rank's scenes: every world-th from its rank."""
        return range(comm.get_rank(), len(self.test_dataset),
                     comm.get_world_size())

    def gather_records(self, record):
        """Every rank's per-scene records on rank 0, in scene order (each
        record holds its scene's ``index``); None on the other ranks."""
        self.logger.info("Syncing ...")
        gathered = comm.gather(record, dst=0)
        if not comm.is_main_process():
            return None
        merged = {k: v for r in gathered for k, v in r.items()}
        return dict(sorted(merged.items(), key=lambda kv: kv[1]["index"]))

    def test(self):
        raise NotImplementedError


@TESTERS.register_module()
class SemSegTester(TesterBase):
    """Closed-set fragment-voting semantic segmentation tester."""

    def test(self):
        logger = self.logger
        cfg = self.cfg
        num_classes = cfg.data.num_classes
        ignore_index = cfg.data.get("ignore_index", -1)
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        batch_time = AverageMeter()
        save_path = make_dirs(os.path.join(cfg.save_path, "result"))
        record = {}

        for idx in self.scene_indices():
            end = time.time()
            data_dict = self.test_dataset[idx]
            fragment_list = data_dict.pop("fragment_list")
            segment = np.asarray(data_dict.pop("segment")).reshape(-1)
            data_name = data_dict.pop("name")
            pred_save_path = os.path.join(save_path, f"{data_name}_pred.npy")
            if os.path.isfile(pred_save_path):
                logger.info(f"{idx + 1}/{len(self.test_dataset)}: {data_name}, "
                            "loaded pred.")
                pred = np.load(pred_save_path)
            else:
                vote = np.zeros((segment.size, num_classes), np.float32)
                for i, fragment in enumerate(fragment_list):
                    index = np.asarray(fragment["index"]).reshape(-1)
                    out = self.forward_fragment(fragment)
                    np.add.at(vote, index, _softmax_np(out["seg_logits"]))
                    logger.info(
                        f"Test: {idx + 1}/{len(self.test_dataset)}-{data_name}, "
                        f"Batch: {i}/{len(fragment_list)}"
                    )
                pred = vote.argmax(-1)
                np.save(pred_save_path, pred)
            if "origin_segment" in data_dict:
                assert "inverse" in data_dict
                pred = pred[data_dict["inverse"]]
                segment = np.asarray(data_dict["origin_segment"]).reshape(-1)
            inter, union, target = intersection_and_union_np(
                pred, segment, num_classes, ignore_index
            )
            record[data_name] = dict(intersection=inter, union=union,
                                     target=target, index=idx)
            batch_time.update(time.time() - end)
            mask = union != 0
            iou = np.mean((inter / np.maximum(union, 1e-10))[mask])
            acc = inter.sum() / max(target.sum(), 1e-10)
            logger.info(
                f"Test: {data_name} [{idx + 1}/{len(self.test_dataset)}]-"
                f"{segment.size} Batch {batch_time.val:.3f} "
                f"({batch_time.avg:.3f}) Accuracy {acc:.4f} mIoU {iou:.4f}"
            )
            self.write_submit(save_path, data_name, pred)
        record = self.gather_records(record)
        if record is not None:
            self.finalize(record, save_path)

    def finalize(self, record, save_path):
        cfg = self.cfg
        inter = np.sum([m["intersection"] for m in record.values()], axis=0)
        union = np.sum([m["union"] for m in record.values()], axis=0)
        target = np.sum([m["target"] for m in record.values()], axis=0)
        if cfg.data.test.type == "S3DISDataset":
            # 6-fold record consumed by tools/test_s3dis_6fold.py
            with open(os.path.join(
                save_path, f"{self.test_dataset.split}.pickle"
            ), "wb") as f:
                pickle.dump(
                    dict(intersection=inter, union=union, target=target), f
                )
        iou_class = inter / np.maximum(union, 1e-10)
        acc_class = inter / np.maximum(target, 1e-10)
        m_iou = float(np.mean(iou_class))
        m_acc = float(np.mean(acc_class))
        all_acc = float(inter.sum() / max(target.sum(), 1e-10))
        self.logger.info(
            f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}"
        )
        for c in range(cfg.data.num_classes):
            self.logger.info(
                f"Class_{c} - {cfg.data.names[c]} Result: iou/accuracy "
                f"{iou_class[c]:.4f}/{acc_class[c]:.4f}"
            )
        self.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")


@TESTERS.register_module()
class OpenSegTester(TesterBase):
    """Open-set fragment tester: softmax vote + recognizer score
    scatter-mean, known-masked mIoU, global AUPR/AUROC."""

    def __init__(self, cfg):
        super().__init__(cfg)
        from ..recognizers import build_recognizer

        self.recognizer = build_recognizer(cfg.recognizer)
        self.recognizer.model.to(self.device).eval()
        self.mask_known = ~selected_mask(cfg.unknown_label, cfg.data.num_classes)

    def build_test_dataset(self):
        # the open-set configs also list ``unknown_label`` under data.test;
        # it is the tester's (cfg.unknown_label), no dataset takes it
        self.logger.info("=> Building test dataset ...")
        cfg = dict(self.cfg.data.test)
        cfg.pop("unknown_label", None)
        return build_dataset(cfg)

    def load_weights(self):
        super().load_weights()
        state = self.load_checkpoint_payload()["state"]
        self.recognizer.model.load_state_dict(jax_to_state_dict({
            "params": state["params"].get("recognizer", {}),
            "batch_stats": state.get("batch_stats", {}).get("recognizer", {}),
        }), strict=True)

    def forward(self, batch: Dict) -> Dict:
        out = self.model(batch)
        seg_logits = out["seg_logits"]
        rec_raw = self.recognizer.model(out["intermediates"])
        return {"seg_logits": seg_logits,
                "score": self.recognizer.score(seg_logits, rec_raw)}

    def test(self):
        logger = self.logger
        cfg = self.cfg
        num_classes = cfg.data.num_classes
        ignore_index = cfg.data.get("ignore_index", -1)
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        batch_time = AverageMeter()
        aupr_meter, auroc_meter = AverageMeter(), AverageMeter()
        save_path = make_dirs(os.path.join(cfg.save_path, "result"))
        record = {}

        for idx in self.scene_indices():
            end = time.time()
            data_dict = self.test_dataset[idx]
            fragment_list = data_dict.pop("fragment_list")
            segment = np.asarray(data_dict.pop("segment")).reshape(-1)
            data_name = data_dict.pop("name")
            pred_save_path = os.path.join(save_path, f"{data_name}_pred.npy")
            score_save_path = os.path.join(save_path, f"{data_name}_score.npy")
            if os.path.isfile(pred_save_path) and os.path.isfile(score_save_path):
                logger.info(
                    f"{idx + 1}/{len(self.test_dataset)}: {data_name}, "
                    "loaded pred and score."
                )
                pred = np.load(pred_save_path)
                score = np.load(score_save_path)
            else:
                vote = np.zeros((segment.size, num_classes), np.float32)
                score_sum = np.zeros((segment.size,), np.float64)
                score_cnt = np.zeros((segment.size,), np.int64)
                for i, fragment in enumerate(fragment_list):
                    index = np.asarray(fragment["index"]).reshape(-1)
                    out = self.forward_fragment(fragment)
                    np.add.at(vote, index, _softmax_np(out["seg_logits"]))
                    np.add.at(score_sum, index, out["score"].astype(np.float64))
                    np.add.at(score_cnt, index, 1)
                    logger.info(
                        f"Test: {idx + 1}/{len(self.test_dataset)}-{data_name}, "
                        f"Batch: {i}/{len(fragment_list)}"
                    )
                pred = vote.argmax(-1)
                score = (score_sum / np.maximum(score_cnt, 1)).astype(np.float32)
                np.save(pred_save_path, pred)
                np.save(score_save_path, score)
            if "origin_segment" in data_dict:
                assert "inverse" in data_dict
                pred = pred[data_dict["inverse"]]
                score = score[data_dict["inverse"]]
                segment = np.asarray(data_dict["origin_segment"]).reshape(-1)
            inter, union, target = intersection_and_union_np(
                pred, segment, num_classes, ignore_index
            )
            aupr, auroc = aupr_and_auroc(
                score, segment, cfg.unknown_label, ignore_index
            )
            record[data_name] = dict(
                intersection=inter, union=union, target=target,
                score=score, segment=segment, aupr=aupr, auroc=auroc,
                index=idx,
            )
            if aupr is not None:
                aupr_meter.update(aupr)
                auroc_meter.update(auroc)
            batch_time.update(time.time() - end)
            cls_mask = (union != 0) & self.mask_known
            iou = np.mean((inter / np.maximum(union, 1e-10))[cls_mask])
            acc = inter[cls_mask].sum() / max(target[cls_mask].sum(), 1e-10)
            logger.info(
                f"Test: {data_name} [{idx + 1}/{len(self.test_dataset)}]-"
                f"{segment.size} Batch {batch_time.val:.3f} "
                f"({batch_time.avg:.3f}) Accuracy {acc:.4f} mIoU {iou:.4f} "
                f"aupr {aupr if aupr is None else format(aupr, '.4f')} "
                f"({aupr_meter.avg:.4f}) "
                f"auroc {auroc if auroc is None else format(auroc, '.4f')} "
                f"({auroc_meter.avg:.4f})"
            )
            self.write_submit(save_path, data_name, pred)
        record = self.gather_records(record)
        if record is not None:
            self.finalize(record)

    def finalize(self, record):
        cfg = self.cfg
        # the per-scene means over every rank's scenes, in scene order
        aupr_meter, auroc_meter = AverageMeter(), AverageMeter()
        for m in record.values():
            if m["aupr"] is not None:
                aupr_meter.update(m["aupr"])
                auroc_meter.update(m["auroc"])
        inter = np.sum([m["intersection"] for m in record.values()], axis=0)
        union = np.sum([m["union"] for m in record.values()], axis=0)
        target = np.sum([m["target"] for m in record.values()], axis=0)
        iou_class = inter / np.maximum(union, 1e-10)
        acc_class = inter / np.maximum(target, 1e-10)
        m_iou = float(np.mean(iou_class[self.mask_known]))
        m_acc = float(np.mean(acc_class[self.mask_known]))
        all_acc = float(
            inter[self.mask_known].sum()
            / max(target[self.mask_known].sum(), 1e-10)
        )
        self.logger.info(
            f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}"
        )
        all_score = np.concatenate([m["score"] for m in record.values()])
        all_segment = np.concatenate([m["segment"] for m in record.values()])
        all_aupr, all_auroc = aupr_and_auroc(
            all_score, all_segment, cfg.unknown_label
        )
        self.logger.info(
            f"Val result: aupr/auroc {aupr_meter.avg:.4f}/{auroc_meter.avg:.4f}"
        )
        if all_aupr is not None:
            self.logger.info(
                f"Val result: all points aupr/auroc {all_aupr:.4f}/{all_auroc:.4f}"
            )
        for c in range(cfg.data.num_classes):
            self.logger.info(
                f"Class_{c} - {cfg.data.names[c]} Result: iou/accuracy "
                f"{iou_class[c]:.4f}/{acc_class[c]:.4f}"
            )
        self.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")


@TESTERS.register_module()
class IncrSegTester(TesterBase):
    """Incremental-learning tester: fragment voting with the student
    (base+new classes), known/incr/remap metric triple
    (reference test.py:512-894)."""

    def __init__(self, cfg):
        from ..incr_learners import build_incremental_learner

        # built before super().__init__ so build_model (called there) hands
        # on this learner's student instead of building a second one
        self.incr_learner = build_incremental_learner(cfg.incremental_learner)
        super().__init__(cfg)
        self.remap = dict(cfg.incr_label_remap)
        self.base_num_classes = cfg.data.num_classes
        self.remap_num_classes = self.base_num_classes + len(self.remap)
        select = cfg.get("incr_label_select", list(self.remap.keys()))
        self.mask_known, self.incr_label_idx, self.mask_incr_remap = (
            incr_class_sets(self.remap, select, self.base_num_classes))

    def build_model(self):
        # the tested model is the student of the learner built in __init__
        return self.incr_learner.model

    def checkpoint_model_state(self):
        state = self.load_checkpoint_payload()["state"]
        params = state["params"]
        stats = state.get("batch_stats", {})
        if isinstance(params, dict) and "incr" in params:
            return params["incr"], stats.get("incr", {})
        return params, stats

    def load_weights(self):
        params, stats = self.checkpoint_model_state()
        self.model.load_state_dict(
            jax_to_backbone_state_dict({"params": params, "batch_stats": stats}),
            strict=True)

    def forward(self, batch: Dict) -> Dict:
        out = self.model(batch)
        return {"seg_logits": out[0] if isinstance(out, tuple) else out}

    def test(self):
        logger = self.logger
        cfg = self.cfg
        k = self.remap_num_classes
        ignore_index = cfg.data.get("ignore_index", -1)
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        save_path = make_dirs(os.path.join(cfg.save_path, "result"))
        # remap lookup for the full-resolution ground truth
        lut_size = max([k] + [o + 1 for o in self.remap])
        lut = np.arange(lut_size)
        for old, new in self.remap.items():
            lut[old] = new
        record = {}

        for idx in self.scene_indices():
            data_dict = self.test_dataset[idx]
            fragment_list = data_dict.pop("fragment_list")
            segment = np.asarray(data_dict.pop("segment")).reshape(-1)
            data_name = data_dict.pop("name")
            pred_save_path = os.path.join(save_path, f"{data_name}_pred.npy")
            if os.path.isfile(pred_save_path):
                pred = np.load(pred_save_path)
            else:
                vote = np.zeros((segment.size, k), np.float32)
                for i, fragment in enumerate(fragment_list):
                    index = np.asarray(fragment["index"]).reshape(-1)
                    out = self.forward_fragment(fragment)
                    np.add.at(vote, index, _softmax_np(out["seg_logits"]))
                    logger.info(
                        f"Test: {idx + 1}/{len(self.test_dataset)}-{data_name}, "
                        f"Batch: {i}/{len(fragment_list)}"
                    )
                pred = vote.argmax(-1)
                np.save(pred_save_path, pred)
            if "origin_segment" in data_dict:
                pred = pred[data_dict["inverse"]]
                segment = np.asarray(data_dict["origin_segment"]).reshape(-1)
            target = np.where(
                segment == ignore_index, ignore_index,
                lut[np.clip(segment, 0, lut_size - 1)],
            )
            inter, union, tgt = intersection_and_union_np(
                pred, target, k, ignore_index
            )
            record[data_name] = dict(intersection=inter, union=union,
                                     target=tgt, index=idx)
            logger.info(f"Test: {data_name} [{idx + 1}/{len(self.test_dataset)}]")

        record = self.gather_records(record)
        if record is not None:
            self.finalize(record)

    def finalize(self, record):
        logger = self.logger
        inter = np.sum([m["intersection"] for m in record.values()], axis=0)
        union = np.sum([m["union"] for m in record.values()], axis=0)
        target = np.sum([m["target"] for m in record.values()], axis=0)
        iou_class = inter / np.maximum(union, 1e-10)
        acc_class = inter / np.maximum(target, 1e-10)
        for tag, sel in (
            ("known", np.where(self.mask_known)[0]),
            ("incr", np.asarray(self.incr_label_idx)),
            ("remap", np.where(self.mask_incr_remap)[0]),
        ):
            m_iou, m_acc, acc = metric_triple(inter, target, iou_class,
                                              acc_class, sel)
            logger.info(
                f"Val result: mIoU/mAcc/Acc {tag} "
                f"{m_iou:.4f}/{m_acc:.4f}/{acc:.4f}."
            )
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")


def test_worker(cfg):
    """One rank of ``tools/test_torch.py`` (``launch``'s ``main_func``)."""
    from .defaults import default_setup

    cfg = default_setup(cfg)
    tester = TESTERS.build(
        dict(type=cfg.get("test", {}).get("type", "SemSegTester"), cfg=cfg))
    tester.test()


def _softmax_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)
