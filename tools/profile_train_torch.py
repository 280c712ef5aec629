"""Where one training step of the PyTorch port goes, on one GPU.

    python3 tools/profile_train_torch.py [--workload pt|st|incr] [--batch-size 16]
        [--steps 3] [--out FILE]

Builds synthetic S3DIS rooms (``chip_smoke.synthetic_room``) and a trainer
on a shipped config at full width: ``pt`` (default) ``OpenSegTrainer`` on
the PT-v1 open-set config (Seg50 + PDF recognizer), ``st`` the same trainer
on the S3DIS Stratified Transformer config (ST-v1m1 + ST recognizer, AdamW,
drop path 0.3), ``incr`` ``IncrSegTrainer`` on the incremental config (a
seeded Seg50 teacher, Seg50 student with two more classes); autocast as
each config ships.  Prints, for one fixed batch: milliseconds per train step
(CUDA events and host clock), the device's busy time and idle share and its
split by kind of kernel (``torch.profiler``), every kernel's launches in a
step, peak device memory; for ``pt`` also the forward share of the
batch-statistics pass (CUDA events around ``attention_train_affines``); for
``pt`` and ``st`` the host side of the pseudo-label pipeline (score pass,
fetch, graph stage) beside the train step it is meant to hide behind; for
``incr`` the teacher's forward alone.  ``--out`` also writes the numbers as
JSON.  Needs a CUDA device.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from _profile_torch import card_line, knn_calls, profile_call, write_result  # noqa: E402


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", choices=("pt", "st", "incr"), default="pt")
    parser.add_argument("--batch-size", type=int, default=16)
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
        "incr": (chip_smoke.INCR_CONFIG, "IncrSegTrainer")}[args.workload]
    result = {"card": card, "workload": args.workload, "config": os.path.relpath(config, ROOT),
              "batch_size": args.batch_size}
    with tempfile.TemporaryDirectory() as work:
        data_root = os.path.join(work, "s3dis")
        rng = np.random.RandomState(1)
        for area in (*chip_smoke.TRAIN_AREAS, "Area_5"):
            os.makedirs(os.path.join(data_root, area))
        for i in range(2 * args.batch_size):
            chip_smoke.synthetic_room(rng, os.path.join(
                data_root, chip_smoke.TRAIN_AREAS[i % 5], f"office_{i}.npz"))
        options = {
            "data_root": data_root, "data.train.data_root": data_root,
            "data.val.data_root": data_root, "save_path": os.path.join(work, "exp"),
            "device": "cuda", "batch_size": args.batch_size, "num_worker": 0,
            "evaluate": False, "hooks": [], "seed": 0}
        if args.no_amp:
            options["enable_amp"] = False
        cfg = default_config_parser(config, options)
        result["amp"] = bool(cfg.get("enable_amp"))
        torch.manual_seed(0)
        trainer = TRAINERS.build(dict(type=trainer_type, cfg=cfg))
        loader = iter(trainer.train_loader)
        input_dict = next(loader)
        batch = trainer.device_batch(input_dict)
        open_set = trainer_type == "OpenSegTrainer"
        # past start_epoch: the recognizer's loss on
        step_args = (trainer.recognizer.alpha,) if open_set else ()
        result["shape"] = list(batch["coord"].shape)
        result["valid_points"] = input_dict["count"].tolist()
        print(f"batch {result['shape']}, valid points {result['valid_points']}")

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

        def step():
            trainer._dispatch_train(batch, *step_args)

        step()  # warm-up: builds the kernels, allocates
        torch.cuda.synchronize()
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
        result["knn_calls_a_step"] = knn_calls(step)
        torch.cuda.synchronize()  # the timings below start on an idle device

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
