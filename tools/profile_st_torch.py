"""Where one serving forward of the Stratified Transformer goes, on one GPU.

    python3 tools/profile_st_torch.py [--iters 5] [--out FILE]

Builds a synthetic S3DIS room (``chip_smoke.synthetic_room``), an
``OpenSegTester`` on the shipped S3DIS ST config (ST-v1m1 + ST recognizer at
full width, seeded random weights through the bridge) and prints, for the
room's largest fragment: milliseconds per forward on the kernels and on the
plain versions (CUDA events and host clock), the launches of every kernel
in one forward, the device's busy time and idle share and its split by kind
of kernel (``torch.profiler``), and peak device memory.  ``--out`` also
writes the numbers as JSON.  Needs a CUDA device.
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
from _profile_torch import card_line, profile_call, write_result  # noqa: E402


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = card_line()
    print(card)

    from pointcloudpdf_tpu_torch.datasets.utils import padded_collate_fn
    from pointcloudpdf_tpu_torch.engines import default_config_parser
    from pointcloudpdf_tpu_torch.engines.test import TESTERS
    from pointcloudpdf_tpu_torch.models import build_model
    from pointcloudpdf_tpu_torch.ops import _cuda
    from pointcloudpdf_tpu_torch.recognizers import build_recognizer

    result = {"card": card}
    with tempfile.TemporaryDirectory() as work:
        data_root = os.path.join(work, "s3dis")
        os.makedirs(os.path.join(data_root, "Area_5"))
        chip_smoke.synthetic_room(np.random.RandomState(0), os.path.join(
            data_root, "Area_5", "office_1.npz"))
        weight = os.path.join(work, "model.pth")
        cfg = default_config_parser(chip_smoke.ST_CONFIG, {
            "data_root": data_root, "data.test.data_root": data_root,
            "weight": weight, "save_path": os.path.join(work, "exp"),
            "device": "cuda"})
        torch.manual_seed(0)
        chip_smoke.random_jax_checkpoint(
            weight, build_model(dict(cfg.model)),
            build_recognizer(cfg.recognizer).model)
        tester = TESTERS.build(dict(type="OpenSegTester", cfg=cfg))
        fragments = tester.test_dataset[0]["fragment_list"]
        sizes = [len(f["coord"]) for f in fragments]
        fragment = fragments[int(np.argmax(sizes))]
        tester.forward_fragment(fragment)  # loads the weights, builds the kernels
        batch = tester.device_batch(padded_collate_fn([fragment]))
        result.update(fragment_points=max(sizes), bucket=batch["coord"].shape[1])
        print(f"fragment of {max(sizes)} points, bucket {batch['coord'].shape[1]}")

        def forward():
            with torch.inference_mode():
                tester.forward(batch)

        def timed(iters):
            forward()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                forward()
            end.record()
            torch.cuda.synchronize()
            return (start.elapsed_time(end) / iters,
                    (time.perf_counter() - t0) * 1e3 / iters)

        # plain, kernels, kernels, plain: the two compared inside one call
        with _cuda.plain_versions():
            plain_a = timed(1)
        torch.cuda.reset_peak_memory_stats()
        kernel_a = timed(args.iters)
        result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        kernel_b = timed(args.iters)
        with _cuda.plain_versions():
            plain_b = timed(1)
        result.update(forward_ms_events=[kernel_a[0], kernel_b[0]],
                      forward_ms_host=[kernel_a[1], kernel_b[1]],
                      plain_forward_ms_events=[plain_a[0], plain_b[0]])
        print(f"forward on the kernels: {kernel_a[0]:.2f} / {kernel_b[0]:.2f} ms (CUDA "
              f"events), {kernel_a[1]:.2f} / {kernel_b[1]:.2f} ms (host clock, synced "
              f"at the end of {args.iters}); on the plain versions {plain_a[0]:.1f} / "
              f"{plain_b[0]:.1f} ms; peak memory {result['peak_memory_gib']:.2f} GiB")

        chip_smoke.reset_launches()
        forward()
        counts = chip_smoke.read_launches()
        result["launches_a_forward"] = {k: v for k, v in counts.items()
                                        if not isinstance(v, tuple)}
        print(f"launches a forward: {result['launches_a_forward']}")

        result.update(profile_call(forward, kernel_b[1], "forward"))

    write_result(result, args.out)


if __name__ == "__main__":
    main()
