"""Where one serving forward of Point Transformer V2 goes, on one GPU.

    python3 tools/profile_ptv2_torch.py [--iters 5] [--out FILE]

Builds a synthetic S3DIS room (``chip_smoke.synthetic_room``), a
``SemSegTester`` on the shipped S3DIS PT-v2m2 config (full width, seeded
random weights through the bridge) and prints, for the room's largest
fragment: milliseconds per forward on the kernels and on the plain versions
(CUDA events and host clock), the launches of every kernel in one forward,
the device's busy time and idle share and its split by kind of kernel
(``torch.profiler``), peak device memory, and the points that the pooling
capacity dropped over every forward of the run (0 expected).  ``--out``
also writes the numbers as JSON.  Needs a CUDA device.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from _profile_torch import card_line, serving_forward_profile, write_result  # noqa: E402


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

    from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2

    result = {"card": card}
    ptv2.capacity_dropped_points(reset=True)
    result.update(serving_forward_profile(chip_smoke.PTV2_CONFIG, "SemSegTester",
                                          False, args.iters))
    result["capacity_dropped_points"] = ptv2.capacity_dropped_points(reset=True)
    print(f"points dropped by the pooling capacity: {result['capacity_dropped_points']}")
    write_result(result, args.out)


if __name__ == "__main__":
    main()
