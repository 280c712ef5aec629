"""Where one training step of the PyTorch port goes, on one GPU.

    python3 tools/profile_train_torch.py [--workload pt|st|incr|ptv2|spunet|ptv3|swin3d|octformer|
                                          pointgroup|oacnns] [--batch-size N] [--steps 3]
        [--out FILE]

Builds synthetic S3DIS rooms (``chip_smoke.synthetic_room``) and a trainer
on a shipped config at full width: ``pt`` (default) ``OpenSegTrainer`` on
the PT-v1 open-set config (Seg50 + PDF recognizer), ``st`` the same trainer
on the S3DIS Stratified Transformer config (ST-v1m1 + ST recognizer, AdamW,
drop path 0.3), ``incr`` ``IncrSegTrainer`` on the incremental config (a
seeded Seg50 teacher, Seg50 student with two more classes), ``ptv2``
``DefaultTrainer`` on the S3DIS PT-v2m2 config (AdamW, Mix3D 0.8, drop path
0.3, level capacity 0.5), ``spunet`` the same trainer on the S3DIS
SpUNet-v1m1 config (SGD, PolyLR, Mix3D 0.8, level capacity 0.5), ``ptv3``
the same trainer on the S3DIS PT-v3m1 ``-rpe`` config (AdamW, OneCycleLR,
Mix3D 0.8, drop path 0.3, level capacity 0.5), ``swin3d`` the S3DIS
Swin3D-small config (AdamW, MultiStepLR, the ``blocks`` group, Mix3D 0.8,
drop path 0.3), ``octformer`` the ScanNet OctFormer config (AdamW,
Mix3D 0.8, drop path 0.5; its displacement projected on the normal,
``chip_smoke.octformer_config``), ``pointgroup`` the S3DIS PointGroup
config (PointGroup over SpUNet-v1m1 at 4 cm, SGD, PolyLR, the model's own
loss) and ``oacnns`` the ScanNet OA-CNNs config (AdamW, OneCycleLR, CE +
Lovasz, Mix3D 0.8), ``octformer`` and ``oacnns`` over the rooms relabelled
into ScanNet's layout (``chip_smoke.scannet_layout``), the last five over
rooms made as ``chip_smoke.PTV3_ROOM`` makes them (with normals, at 2,800
points a square metre; each plane and box an instance); autocast as each
config ships.  The batch size is ``--batch-size``, else 16, and for the
closed-set workloads (``ptv2``, ``spunet``, ``ptv3``, ``swin3d``,
``octformer``, ``pointgroup``, ``oacnns``) the largest of
``chip_smoke.PTV2_TRAIN_BATCHES`` (12 shipped, 6, 3, 2, 1) that fits the
card's memory.  Prints, for one fixed batch:
milliseconds per train step
(CUDA events and host clock), the device's busy time and idle share and its
split by kind of kernel (``torch.profiler``), every kernel's launches in a
step, peak device memory; for ``pt`` also the forward share of the
batch-statistics pass (CUDA events around ``attention_train_affines``); for
``pt`` and ``st`` the host side of the pseudo-label pipeline (score pass,
fetch, graph stage) beside the train step it is meant to hide behind; for
``incr`` the teacher's forward alone; for the closed-set workloads
the share of the step in PyTorch's sort-based backward of advanced indexing
(the plain grouped attention's gathers; SpUNet's rulebook conv and PT-v3's
gathers and RPE lookup use ``index_select`` and should show none) and one
evaluator forward over the val room (K7 and K1 by the profiler); for
``ptv3`` also the step's cost of the RPE lookup and of the patch
attention's core, for ``octformer`` that of the RPE lookup and for
``swin3d`` that of the cRSE terms, by taking each out (``ablations``); for
``swin3d``, ``octformer`` and ``oacnns`` the valid and held rows of each
level of the batch (``chip_smoke.window_levels``); for ``pointgroup`` the
proposals of the val room and the host clustering's ms
(``PointGroup.propose``).  ``--out`` also
writes the numbers as JSON.
Needs a CUDA device.
"""

import argparse
import gc
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from _profile_torch import card_line, knn_calls, profile_call, write_result  # noqa: E402


def ablations(workload, step, start, end, steps, step_ms):
    """The step with a part taken out, by CUDA events: ``rpe`` (PT-v3,
    OctFormer) the RPE lookup (a 0 bias: its gather and scatter-add gone,
    the add kept); ``attention_core`` (PT-v3) the patch attention's core
    (each block's attention its qkv Linear's first third through ``proj``:
    the gathers, logits, softmax, RPE and p v gone); ``crse`` (Swin3D) the
    cRSE terms (the q, k and value tables' gathers, scatter-adds and
    products gone, plain masked attention kept).  The step's ms less each
    is that part's cost, forward and backward.  Only a measurement: the
    ablated steps compute another network."""
    import torch

    from pointcloudpdf_tpu_torch.models.point_transformer_v3 import ptv3
    from pointcloudpdf_tpu_torch.models.swin3d import swin3d
    from pointcloudpdf_tpu_torch.models.utils.structure import where_valid

    def no_rpe(self, index):
        return torch.zeros((), device=index.device)

    def no_core(self, feat, level, oi):
        return where_valid(level.mask, self.proj(self.qkv(feat)[..., :self.channels]))

    crse = swin3d.CRSEAttention.forward

    def no_crse(ctx, q, k, v, scale, tq, tk, tv, bins, pair_valid, offsets):
        return crse(ctx, q, k, v, scale, tq, tk, tv, bins, pair_valid, [])

    patches = {"rpe": (ptv3.RPE, no_rpe),
               "attention_core": (ptv3.SerializedAttention, no_core),
               "crse": (swin3d.CRSEAttention, staticmethod(no_crse))}
    parts = {"ptv3": ("rpe", "attention_core"), "octformer": ("rpe",),
             "swin3d": ("crse",)}[workload]
    out = {}
    for name in parts:
        cls, patch = patches[name]
        orig = cls.__dict__["forward"]
        setattr(cls, "forward", patch)
        try:
            step()
            torch.cuda.synchronize()
            start.record()
            for _ in range(steps):
                step()
            end.record()
            torch.cuda.synchronize()
        finally:
            setattr(cls, "forward", orig)
        ms = start.elapsed_time(end) / steps
        out[name] = {"step_ms_without": ms, "cost_ms": step_ms - ms,
                     "share": (step_ms - ms) / step_ms}
        print(f"step without the {name.replace('_', ' ')}: {ms:.1f} ms, so it costs "
              f"{step_ms - ms:.1f} ms ({(step_ms - ms) / step_ms:.3f} of the step)")
    return out


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", choices=("pt", "st", "incr", "ptv2", "spunet", "ptv3",
                                               "swin3d", "octformer", "pointgroup", "oacnns"),
                        default="pt")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--no-amp", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = card_line()
    print(card)

    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.train import TRAINERS
    from pointcloudpdf_tpu_torch.ops import vector_attention as va
    from pointcloudpdf_tpu_torch.models.point_transformer import modules

    config, trainer_type = {
        "pt": (chip_smoke.CONFIG, "OpenSegTrainer"),
        "st": (chip_smoke.ST_CONFIG, "OpenSegTrainer"),
        "incr": (chip_smoke.INCR_CONFIG, "IncrSegTrainer"),
        "ptv2": (chip_smoke.PTV2_CONFIG, "DefaultTrainer"),
        "spunet": (chip_smoke.SPUNET_CONFIG, "DefaultTrainer"),
        "ptv3": (chip_smoke.PTV3_CONFIG, "DefaultTrainer"),
        "swin3d": (chip_smoke.SWIN3D_CONFIG, "DefaultTrainer"),
        "octformer": (chip_smoke.OCTFORMER_CONFIG, "DefaultTrainer"),
        "pointgroup": (chip_smoke.PG_CONFIG, "DefaultTrainer"),
        "oacnns": (chip_smoke.OACNNS_CONFIG, "DefaultTrainer")}[args.workload]
    closed_set = args.workload in ("ptv2", "spunet", "ptv3", "swin3d", "octformer",
                                   "pointgroup", "oacnns")
    window = args.workload in ("swin3d", "octformer", "oacnns")
    scannet = args.workload in ("octformer", "oacnns")
    room = (chip_smoke.PTV3_ROOM if args.workload in ("ptv3", "swin3d", "octformer",
                                                      "pointgroup", "oacnns") else {})
    sizes = ([args.batch_size] if args.batch_size else
             list(chip_smoke.PTV2_TRAIN_BATCHES) if closed_set else [16])
    result = {"card": card, "workload": args.workload, "config": os.path.relpath(config, ROOT)}
    with tempfile.TemporaryDirectory() as work:
        data_root = os.path.join(work, "s3dis")
        rng = np.random.RandomState(1)
        for area in (*chip_smoke.TRAIN_AREAS, "Area_5"):
            os.makedirs(os.path.join(data_root, area))
        for i in range(2 * max(sizes)):
            chip_smoke.synthetic_room(rng, os.path.join(
                data_root, chip_smoke.TRAIN_AREAS[i % 5], f"office_{i}.npz"), **room)
        chip_smoke.synthetic_room(rng, os.path.join(data_root, "Area_5", "office_1.npz"),
                                  **room)
        if args.workload == "octformer":
            config = chip_smoke.octformer_config(work)
        if scannet:
            data_root, _ = chip_smoke.scannet_layout(work, data_root)
        open_set = trainer_type == "OpenSegTrainer"
        result["batch_sizes_out_of_memory"] = []
        for batch_size in sizes:
            options = {
                "data_root": data_root, "data.train.data_root": data_root,
                "data.val.data_root": data_root, "save_path": os.path.join(work, "exp"),
                "device": "cuda", "batch_size": batch_size, "num_worker": 0,
                "evaluate": closed_set, "hooks": [], "seed": 0}
            if scannet:
                options["data.train.split"] = (f"Batch{batch_size}",)
            if args.no_amp:
                options["enable_amp"] = False
            cfg = default_config_parser(config, options)
            result["amp"] = bool(cfg.get("enable_amp"))
            torch.manual_seed(0)
            trainer = TRAINERS.build(dict(type=trainer_type, cfg=cfg))
            input_dict = next(iter(trainer.train_loader))
            batch = trainer.device_batch(input_dict)
            # past start_epoch: the recognizer's loss on
            step_args = (trainer.recognizer.alpha,) if open_set else ()

            def step():
                trainer._dispatch_train(batch, *step_args)

            try:
                step()  # warm-up: builds the kernels, allocates
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:
                print(f"batch size {batch_size} does not fit the card's memory")
                result["batch_sizes_out_of_memory"].append(batch_size)
                del trainer, batch, input_dict
                gc.collect()
                torch.cuda.empty_cache()
                continue
            break
        else:
            raise SystemExit("no batch size fits the card's memory")
        result["batch_size"] = batch_size
        result["shape"] = list(batch["coord"].shape)
        result["valid_points"] = input_dict["count"].tolist()
        print(f"batch size {batch_size}: batch {result['shape']}, valid points "
              f"{result['valid_points']}")

        # the batch-statistics pass, forward, by CUDA events
        spans = []
        plain_affines = modules.attention_train_affines

        def timed_affines(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = plain_affines(*a, **k)
            end.record()
            spans.append((start, end))
            return out

        torch.cuda.reset_peak_memory_stats()
        modules.attention_train_affines = timed_affines
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(args.steps):
            step()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        modules.attention_train_affines = plain_affines
        result["step_ms_events"] = start.elapsed_time(end) / args.steps
        result["step_ms_host"] = host_ms
        result["stats_pass_forward_ms"] = sum(
            a.elapsed_time(b) for a, b in spans) / args.steps
        result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"train step: {result['step_ms_events']:.1f} ms (CUDA events), "
              f"{host_ms:.1f} ms (host clock, synced at the end of {args.steps}); "
              f"stats pass forward {result['stats_pass_forward_ms']:.1f} ms; "
              f"peak memory {result['peak_memory_gib']:.2f} GiB")

        chip_smoke.reset_launches()
        step()
        torch.cuda.synchronize()
        result["launches_a_step"] = chip_smoke.read_launches()
        print(f"launches a step: {result['launches_a_step']}")
        result.update(profile_call(step, host_ms, "step", top=16))
        if not result["device_busy_ms"]:
            # CUPTI did not start (its warning is above): no device time to split
            raise SystemExit("the profiler recorded no device time; run again")
        result["knn_calls_a_step"] = knn_calls(step)
        torch.cuda.synchronize()  # the timings below start on an idle device

        if closed_set:
            # PyTorch's sort-based backward of advanced indexing
            result["indexing_backward_share"] = (result["indexing_backward_ms"]
                                                 / result["device_busy_ms"])
            print(f"indexing backward: {result['indexing_backward_ms']:.1f} ms, "
                  f"{result['indexing_backward_share']:.3f} of busy")
            if args.workload in ("ptv3", "swin3d", "octformer"):
                result["ablations"] = ablations(args.workload, step, start, end, args.steps,
                                                result["step_ms_events"])
            if window:
                result["levels"] = chip_smoke.window_levels(trainer.model, batch)
                print(f"levels: valid rows {result['levels']['valid_rows']}, held "
                      f"{result['levels']['held_rows']}")
            # one evaluator forward over the val room (K7 and K1)
            val = trainer.device_batch(next(iter(trainer.val_loader)))
            result["eval_shape"] = list(val["coord"].shape)
            start.record()
            for _ in range(args.steps):
                trainer.eval_step(val)
            end.record()
            torch.cuda.synchronize()
            eval_ms = start.elapsed_time(end) / args.steps
            chip_smoke.reset_launches()
            trainer.eval_step(val)
            result["launches_an_eval_forward"] = chip_smoke.read_launches()
            prof = profile_call(lambda: trainer.eval_step(val), eval_ms,
                                "evaluator forward", top=12)
            result["eval_forward"] = dict(prof, ms_events=eval_ms)
            print(f"evaluator forward ({result['eval_shape']}): {eval_ms:.1f} ms; "
                  f"launches {result['launches_an_eval_forward']}")
            if args.workload == "pointgroup":
                # the host clustering of the val room (the evaluator's propose)
                out = trainer.eval_step(val)
                n = int(val["mask"].sum())
                t0 = time.perf_counter()
                _, classes, _ = trainer.model.propose(*(
                    t[0, :n].float().cpu().numpy() for t in (
                        val["coord"], out["seg_logits"], out["bias_pred"])), np.ones(n, bool))
                result["propose"] = dict(points=n, proposals=len(classes),
                                         ms=(time.perf_counter() - t0) * 1e3)
                print(f"host clustering of the val room: {result['propose']}")
            write_result(result, args.out)
            return

        if not open_set:
            # the frozen teacher's forward alone (K3), by CUDA events
            start.record()
            for _ in range(args.steps):
                with trainer._amp():
                    trainer.teacher_logits(batch)
            end.record()
            torch.cuda.synchronize()
            result["teacher_forward_ms"] = start.elapsed_time(end) / args.steps
            print(f"teacher forward: {result['teacher_forward_ms']:.1f} ms")
            write_result(result, args.out)
            return

        # the pseudo-label pipeline: score pass, fetch, host graph stage
        va_before = va.ATTENTION_LAUNCHES
        t0 = time.perf_counter()
        (msp_h, ml_h), ready = trainer._fetch(*trainer.pseudo_forward(batch))
        ready()
        score_ms = (time.perf_counter() - t0) * 1e3
        coord_h = np.asarray(input_dict["coord"], np.float32)
        count_h = np.asarray(input_dict["count"])
        t0 = time.perf_counter()
        masks = trainer.recognizer.pseudo_masks_from_scores(
            coord_h, msp_h.numpy(), ml_h.numpy(), count_h, seed=0, neighbors=None,
            ball_radius=trainer._host_radii(coord_h, count_h))
        graph_ms = (time.perf_counter() - t0) * 1e3
        result.update(score_pass_and_fetch_ms=score_ms, graph_stage_ms=graph_ms,
                      pseudo_flagged=float(masks.mean()),
                      k3_launches_score_pass=va.ATTENTION_LAUNCHES - va_before,
                      graph_stage_hidden=bool(graph_ms <= result["step_ms_events"]))
        print(f"pseudo-label pipeline: score pass + fetch {score_ms:.1f} ms, host "
              f"graph stage {graph_ms:.1f} ms (train step {result['step_ms_events']:.1f} "
              f"ms: hidden = {result['graph_stage_hidden']}), flagged "
              f"{result['pseudo_flagged']:.4f}")

    write_result(result, args.out)


if __name__ == "__main__":
    main()
