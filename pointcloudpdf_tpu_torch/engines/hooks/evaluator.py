"""Per-epoch evaluation hooks (counterpart of
``pointcloudpdf_tpu/engines/hooks/evaluator.py``: ``SemSegEvaluator``,
``OpenSegEvaluator``, ``IncrSegEvaluator`` and ``InsSegEvaluator``).

The forward runs on the trainer's device; the IoU histogram and the
AUPR/AUROC records are numpy on the host, with padded points carrying
``ignore_index``.  mIoU/mAcc/allAcc follow the reference
(utils/misc.py:55-87).  Over several ranks each evaluates its shard of the
val set; the histograms and records are gathered, and a batch's loss is
summed over the ranks (each holds its part of the global batch's).
"""

from __future__ import annotations

import time

import numpy as np

from ...utils import comm
from ...utils.misc import (aupr_and_auroc, intersection_and_union_np,
                           selected_mask)
from .builder import HOOKS
from .default import HookBase


def _batch_counts(out, segment, mask, num_classes, ignore_index):
    """(intersection, union, target) of one padded batch."""
    pred = out["seg_logits"].argmax(dim=-1).cpu().numpy()
    target = np.where(mask.cpu().numpy(), segment.cpu().numpy(), ignore_index)
    return np.stack(intersection_and_union_np(
        pred.reshape(-1), target.reshape(-1), num_classes, ignore_index))


@HOOKS.register_module()
class SemSegEvaluator(HookBase):
    """Closed-set semantic segmentation mIoU/mAcc/allAcc
    (reference evaluator.py:492-588)."""

    def __init__(self, write_cls_iou: bool = True):
        self.write_cls_iou = write_cls_iou

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader:
            self.eval()

    def eval(self):
        trainer = self.trainer
        num_classes = trainer.cfg.data.num_classes
        ignore_index = trainer.cfg.data.get("ignore_index", -1)
        totals = np.zeros((3, num_classes), np.float64)
        loss_sum, loss_cnt = 0.0, 0

        for i, input_dict in enumerate(trainer.val_loader):
            batch = trainer.device_batch(input_dict)
            out = trainer.eval_step(batch)
            if "origin_coord" in input_dict:
                totals += self._origin_counts(
                    input_dict, out, num_classes, ignore_index)
            else:
                totals += _batch_counts(out, batch["segment"], batch["mask"],
                                        num_classes, ignore_index)
            loss = float(comm.sum_over_ranks(
                trainer.model.loss(out["seg_logits"], batch["segment"])))
            loss_sum += loss
            loss_cnt += 1
            if (i + 1) % 10 == 0:
                trainer.logger.info(
                    f"Test: [{i + 1}/{len(trainer.val_loader)}] Loss {loss:.4f}"
                )

        totals_all = np.sum(np.stack(comm.all_gather(totals)), axis=0)
        inter, union, target = totals_all
        iou_class = inter / np.maximum(union, 1e-10)
        acc_class = inter / np.maximum(target, 1e-10)
        m_iou = float(np.mean(iou_class))
        m_acc = float(np.mean(acc_class))
        all_acc = float(inter.sum() / max(target.sum(), 1e-10))

        trainer.logger.info(
            f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}"
        )
        if self.write_cls_iou:
            names = trainer.cfg.data.get("names", list(range(num_classes)))
            for c in range(num_classes):
                trainer.logger.info(
                    f"Class_{c}-{names[c]} Result: iou/accuracy "
                    f"{iou_class[c]:.4f}/{acc_class[c]:.4f}"
                )
        epoch = trainer.epoch + 1
        if trainer.writer is not None:
            trainer.writer.add_scalar("val/loss", loss_sum / max(loss_cnt, 1), epoch)
            trainer.writer.add_scalar("val/mIoU", m_iou, epoch)
            trainer.writer.add_scalar("val/mAcc", m_acc, epoch)
            trainer.writer.add_scalar("val/allAcc", all_acc, epoch)
        trainer.comm_info["current_metric_value"] = m_iou
        trainer.comm_info["current_metric_name"] = "mIoU"

    @staticmethod
    def _origin_counts(input_dict, out, num_classes, ignore_index):
        """Re-project voxel predictions to the original full-resolution
        points with a 1-NN lookup, then score against ``origin_segment``
        (the reference's "Interp." eval, hooks/evaluator.py:512-520), on
        the host (cKDTree)."""
        from scipy.spatial import cKDTree

        pred = out["seg_logits"].argmax(dim=-1).cpu().numpy()
        coord = np.asarray(input_dict["coord"])
        counts = np.asarray(input_dict["count"]).reshape(-1)
        ocoord = np.asarray(input_dict["origin_coord"])
        oseg = np.asarray(input_dict["origin_segment"])
        if ocoord.ndim == 2:
            ocoord, oseg = ocoord[None], oseg[None]
        totals = np.zeros((3, num_classes), np.float64)
        for b in range(pred.shape[0]):
            n = int(counts[b])
            _, nn = cKDTree(coord[b, :n]).query(ocoord[b], k=1)
            re_pred = pred[b, :n][nn]
            totals += np.stack(intersection_and_union_np(
                re_pred, oseg[b].reshape(-1), num_classes, ignore_index))
        return totals

    def after_train(self):
        self.trainer.logger.info(
            f"Best mIoU: {self.trainer.best_metric_value:.4f}"
        )


@HOOKS.register_module()
class OpenSegEvaluator(HookBase):
    """Open-set evaluation: known-class mIoU + unknown AUPR/AUROC.

    Reference: pointcept/engines/hooks/evaluator.py:27-229.  The oracle
    labels (with unknown classes intact) score the recognizer; the
    closed-set histogram is reduced over known classes only; AUPR/AUROC
    are per-batch records averaged across batches and processes.
    """

    def before_train(self):
        cfg = self.trainer.cfg
        self.num_classes = cfg.data.num_classes
        self.ignore_index = cfg.data.get("ignore_index", -1)
        self.unknown_label = cfg.unknown_label
        self.mask_known = ~selected_mask(self.unknown_label, self.num_classes)

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader:
            self.eval()

    def eval(self):
        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        num_classes = self.num_classes
        ignore_index = self.ignore_index
        totals = np.zeros((3, num_classes), np.float64)
        auprs, aurocs = [], []
        loss_sum, loss_cnt = 0.0, 0

        for i, input_dict in enumerate(trainer.val_loader):
            batch = trainer.device_batch(input_dict)
            out = trainer.eval_step(batch)
            oracle = batch.get("segment_oracle", batch["segment"])
            totals += _batch_counts(out, oracle, batch["mask"], num_classes,
                                    ignore_index)
            loss = float(comm.sum_over_ranks(
                trainer.model.loss(out["seg_logits"], batch["segment"])))
            loss_sum += loss
            loss_cnt += 1
            # padded slots drop out of the score records through the
            # oracle's ignore padding (collation pads label keys with
            # ignore_index)
            aupr, auroc = aupr_and_auroc(
                out["score"].float().cpu().numpy(), oracle.cpu().numpy(),
                self.unknown_label, ignore_index,
            )
            if aupr is not None:
                auprs.append(aupr)
                aurocs.append(auroc)
            trainer.logger.info(
                f"Test: [{i + 1}/{len(trainer.val_loader)}] Loss {loss:.4f}"
            )

        totals_all = np.sum(np.stack(comm.all_gather(totals)), axis=0)
        records = comm.all_gather({"aupr": auprs, "auroc": aurocs})
        auprs = [a for r in records for a in r["aupr"]]
        aurocs = [a for r in records for a in r["auroc"]]
        aupr_avg = float(np.mean(auprs)) if auprs else float("nan")
        auroc_avg = float(np.mean(aurocs)) if aurocs else float("nan")

        inter, union, target = totals_all
        iou_class = inter / np.maximum(union, 1e-10)
        acc_class = inter / np.maximum(target, 1e-10)
        m_iou = float(np.mean(iou_class[self.mask_known]))
        m_acc = float(np.mean(acc_class[self.mask_known]))
        all_acc = float(
            inter[self.mask_known].sum()
            / max(target[self.mask_known].sum(), 1e-10)
        )
        trainer.logger.info(
            f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}."
        )
        trainer.logger.info(
            f"Val result: aupr/auroc {aupr_avg:.4f}/{auroc_avg:.4f}"
        )
        names = trainer.cfg.data.get("names", list(range(num_classes)))
        for c in range(num_classes):
            trainer.logger.info(
                f"Class_{c}-{names[c]} Result: iou/accuracy "
                f"{iou_class[c]:.4f}/{acc_class[c]:.4f}"
            )
        epoch = trainer.epoch + 1
        if trainer.writer is not None:
            trainer.writer.add_scalar("val/loss", loss_sum / max(loss_cnt, 1), epoch)
            trainer.writer.add_scalar("val/mIoU", m_iou, epoch)
            trainer.writer.add_scalar("val/mAcc", m_acc, epoch)
            trainer.writer.add_scalar("val/allAcc", all_acc, epoch)
            trainer.writer.add_scalar("val/aupr", aupr_avg, epoch)
            trainer.writer.add_scalar("val/auroc", auroc_avg, epoch)
        trainer.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        trainer.comm_info["current_metric_value"] = [m_iou, aupr_avg, auroc_avg]
        trainer.comm_info["current_metric_name"] = ["mIoU", "aupr", "auroc"]

    def after_train(self):
        best = self.trainer.best_metric_value
        if isinstance(best, dict):
            for name, value in best.items():
                self.trainer.logger.info(f"Best {name}: {value:.4f}")


@HOOKS.register_module()
class IncrSegEvaluator(HookBase):
    """Incremental-learning evaluation: known/incr/remap metric triple.

    Reference: pointcept/engines/hooks/evaluator.py:232-405.  Targets are
    ``segment_incr_remap`` over base+new classes; mIoU is reported for the
    retained base classes (known), the newly learned classes (incr), and
    the remapped union (remap).
    """

    def before_train(self):
        cfg = self.trainer.cfg
        self.base_num_classes = cfg.data.num_classes
        self.remap = dict(cfg.incr_label_remap)
        self.remap_num_classes = self.base_num_classes + len(self.remap)
        self.ignore_index = cfg.data.get("ignore_index", -1)
        select = cfg.get("incr_label_select", list(self.remap.keys()))
        self.mask_known, self.incr_label_idx, self.mask_incr_remap = (
            incr_class_sets(self.remap, select, self.base_num_classes))
        self.map_reverse = {v: k for k, v in self.remap.items()}

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader:
            self.eval()

    def eval(self):
        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        k = self.remap_num_classes
        totals = np.zeros((3, k), np.float64)
        loss_sum, loss_cnt = 0.0, 0

        for i, input_dict in enumerate(trainer.val_loader):
            batch = trainer.device_batch(input_dict)
            out = trainer.eval_step(batch)
            totals += _batch_counts(out, batch["segment_incr_remap"],
                                    batch["mask"], k, self.ignore_index)
            loss = float(comm.sum_over_ranks(out["loss"]))
            loss_sum += loss
            loss_cnt += 1
            trainer.logger.info(
                f"Test: [{i + 1}/{len(trainer.val_loader)}] Loss {loss:.4f}"
            )

        totals = np.sum(np.stack(comm.all_gather(totals)), axis=0)
        inter, union, target = totals
        iou_class = inter / np.maximum(union, 1e-10)
        acc_class = inter / np.maximum(target, 1e-10)
        known, incr, remap = (
            metric_triple(inter, target, iou_class, acc_class, sel)
            for sel in (np.where(self.mask_known)[0],
                        np.asarray(self.incr_label_idx),
                        np.where(self.mask_incr_remap)[0]))
        for tag, m in (("known", known), ("incr", incr), ("remap", remap)):
            trainer.logger.info(
                f"Val result: mIoU/mAcc/Acc {tag} "
                f"{m[0]:.4f}/{m[1]:.4f}/{m[2]:.4f}."
            )
        names = trainer.cfg.data.get("names", list(range(k)))
        for c in range(k):
            base_c = self.map_reverse.get(c, c)
            prefix = "Increment " if c >= self.base_num_classes else ""
            trainer.logger.info(
                f"{prefix}Class_{c}-{names[base_c]} Result: iou/accuracy "
                f"{iou_class[c]:.4f}/{acc_class[c]:.4f}"
            )
        epoch = trainer.epoch + 1
        if trainer.writer is not None:
            trainer.writer.add_scalar("val/loss", loss_sum / max(loss_cnt, 1), epoch)
            for tag, m in (("", known), ("_incr", incr), ("_remap", remap)):
                trainer.writer.add_scalar(f"val/mIoU{tag}", m[0], epoch)
                trainer.writer.add_scalar(f"val/mAcc{tag}", m[1], epoch)
                trainer.writer.add_scalar(f"val/allAcc{tag}", m[2], epoch)
        trainer.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        trainer.comm_info["current_metric_value"] = [known[0], incr[0], remap[0]]
        trainer.comm_info["current_metric_name"] = [
            "mIoU_known", "mIoU_incr", "mIoU_remap"
        ]

    def after_train(self):
        best = self.trainer.best_metric_value
        if isinstance(best, dict):
            for name, value in best.items():
                self.trainer.logger.info(f"Best {name}: {value:.4f}")


def incr_class_sets(remap, select, base_num_classes):
    """The incremental metrics' class sets: the known (base) classes left
    after the remap, the new classes' ids, and the remapped union."""
    remap_num_classes = base_num_classes + len(remap)
    mask_known = ~selected_mask(list(remap.keys()), base_num_classes)
    incr_label_idx = [remap[k] for k in select if k in remap]
    mask_incr_remap = ~selected_mask(
        list(remap.keys()) + list(remap.values()), remap_num_classes,
    ) | selected_mask(incr_label_idx, remap_num_classes)
    return mask_known, incr_label_idx, mask_incr_remap


def metric_triple(inter, target, iou_class, acc_class, sel):
    """(mIoU, mAcc, Acc) over the classes ``sel``."""
    return (float(np.mean(iou_class[sel])), float(np.mean(acc_class[sel])),
            float(inter[sel].sum() / max(target[sel].sum(), 1e-10)))


@HOOKS.register_module()
class InsSegEvaluator(HookBase):
    """Instance segmentation mAP (the ScanNet protocol in the JAX package's
    compact form; reference evaluator.py:591-968).

    A val batch's forward runs on the trainer's device (``eval_step``); on
    the host each scene's proposals come from the model's ``propose``
    (radius-graph clustering of the shifted points) and its ground-truth
    instances from ``instance`` by majority class, those of
    ``segment_ignore_index`` left out.  Over several ranks the scenes are
    gathered.  AP a class and IoU threshold (0.5:0.95:0.05, then 0.25) by
    greedy score-ordered matching a scene (``class_ap``); the table of the
    last evaluation stays in ``ap_table``.  The metric is AP50.
    """

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.ap_table = None

    def before_train(self):
        self.num_classes = self.trainer.cfg.data.num_classes
        self.valid_classes = [c for c in range(self.num_classes)
                              if c not in self.segment_ignore_index]

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader:
            self.eval()

    def eval(self):
        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        scenes = []
        for i, input_dict in enumerate(trainer.val_loader):
            out = trainer.eval_step(trainer.device_batch(input_dict))
            batch = self.batch_scenes(trainer.model, input_dict, out)
            scenes += batch
            trainer.logger.info(
                f"Test: [{i + 1}/{len(trainer.val_loader)}] proposals "
                f"{[len(s['classes']) for s in batch]}, clustering ms "
                f"{[round(s['propose_ms'], 1) for s in batch]}")
        all_scenes = [s for r in comm.all_gather(scenes) for s in r]
        self.ap_table = ap_table(all_scenes, self.valid_classes)
        m_ap, m_ap50, m_ap25 = ap_summary(self.ap_table)
        trainer.logger.info(
            f"Val result: mAP/AP50/AP25 {m_ap:.4f}/{m_ap50:.4f}/{m_ap25:.4f}.")
        trainer.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        trainer.comm_info["current_metric_value"] = m_ap50
        trainer.comm_info["current_metric_name"] = "AP50"

    def batch_scenes(self, model, input_dict, out):
        """A padded val batch's scenes on the host: each one's proposals
        (masks, classes, scores; ``propose_ms`` the host's clustering time)
        and ground-truth instances (``gt_masks``, ``gt_classes``)."""
        seg_logits = out["seg_logits"].float().cpu().numpy()
        bias_pred = out["bias_pred"].float().cpu().numpy()
        coord = np.asarray(input_dict["coord"])
        segment = np.asarray(input_dict["segment"])
        instance = np.asarray(input_dict["instance"])
        scenes = []
        for b, n in enumerate(np.asarray(input_dict["count"]).tolist()):
            t0 = time.perf_counter()
            masks, classes, scores = model.propose(
                coord[b, :n], seg_logits[b, :n], bias_pred[b, :n], np.ones(n, bool))
            propose_ms = 1e3 * (time.perf_counter() - t0)
            gt_masks, gt_classes = gt_instances(
                instance[b, :n], segment[b, :n], self.num_classes,
                self.segment_ignore_index, self.instance_ignore_index)
            scenes.append(dict(masks=masks, classes=classes, scores=scores,
                               gt_masks=gt_masks, gt_classes=gt_classes,
                               propose_ms=propose_ms))
        return scenes


def gt_instances(instance, segment, num_classes, segment_ignore_index,
                 instance_ignore_index):
    """One scene's ground-truth instances: (masks (I, n) bool, classes (I,)),
    each instance of the majority class of its labelled points, those of
    ``segment_ignore_index`` (or with no labelled point) left out."""
    masks, classes = [], []
    for iid in np.unique(instance):
        if iid == instance_ignore_index:
            continue
        m = instance == iid
        labelled = segment[m][segment[m] >= 0]
        cls = np.bincount(labelled, minlength=num_classes).argmax() if labelled.size else -1
        if cls in segment_ignore_index:
            continue
        masks.append(m)
        classes.append(int(cls))
    return (np.stack(masks) if masks else np.zeros((0, len(instance)), bool),
            np.asarray(classes, np.int64))


# IoU thresholds of the AP table's rows: 0.5:0.95:0.05, then 0.25
AP_OVERLAPS = np.append(np.arange(0.5, 0.96, 0.05), 0.25)


def ap_table(scenes, valid_classes):
    """AP (len(AP_OVERLAPS), classes) over the scenes; NaN for a class
    without a ground-truth instance."""
    table = np.zeros((len(AP_OVERLAPS), len(valid_classes)))
    for oi, overlap in enumerate(AP_OVERLAPS):
        for ci, cls in enumerate(valid_classes):
            table[oi, ci] = class_ap(scenes, cls, overlap)
    return table


def ap_summary(table):
    """(mAP over 0.5:0.95, AP50, AP25), NaN classes left out."""
    return (float(np.nanmean(table[:-1])), float(np.nanmean(table[0])),
            float(np.nanmean(table[-1])))


def class_ap(scenes, cls, overlap):
    """One class's AP at one IoU threshold: a scene's proposals of the
    class in descending score each take the unmatched ground truth of the
    highest IoU, a hit where that IoU reaches ``overlap``; the precision
    envelope integrated over recall (VOC).  The JAX hook's ``_class_ap``."""
    records = []   # (score, is_tp)
    n_gt = 0
    for sc in scenes:
        gt_sel = np.where(sc["gt_classes"] == cls)[0]
        n_gt += len(gt_sel)
        pr_sel = np.where(sc["classes"] == cls)[0]
        if len(pr_sel) == 0:
            continue
        order = pr_sel[np.argsort(-sc["scores"][pr_sel])]
        matched = np.zeros(len(gt_sel), bool)
        for p in order:
            pm = sc["masks"][p]
            best_iou, best_j = 0.0, -1
            for j, g in enumerate(gt_sel):
                if matched[j]:
                    continue
                gm = sc["gt_masks"][g]
                iou = (pm & gm).sum() / max((pm | gm).sum(), 1)
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou >= overlap and best_j >= 0:
                matched[best_j] = True
                records.append((sc["scores"][p], 1))
            else:
                records.append((sc["scores"][p], 0))
    if n_gt == 0:
        return np.nan
    if not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records])
    fp = np.cumsum([1 - r[1] for r in records])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-12)
    rec = np.concatenate([[0.0], recall, [recall[-1]]])
    pre = np.concatenate([[1.0], precision, [0.0]])
    for k in range(len(pre) - 2, -1, -1):
        pre[k] = max(pre[k], pre[k + 1])
    return float(np.sum((rec[1:] - rec[:-1]) * pre[1:]))
