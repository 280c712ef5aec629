"""Where one serving forward of PT-v1 Seg50 with the PDF recognizer goes, on
one GPU.

    python3 tools/profile_ptv1_torch.py [--iters 5] [--out FILE]

Builds a synthetic S3DIS room (``chip_smoke.synthetic_room``), an
``OpenSegTester`` on the shipped S3DIS open-set PT-v1 config (Seg50 + PDF
recognizer at full width, seeded random weights through the bridge) and
prints, for the room's largest fragment: milliseconds per forward on the
kernels and on the plain versions (CUDA events and host clock), the
launches of every kernel in one forward, the device's busy time and idle
share and its split by kind of kernel (``torch.profiler``), and peak device
memory.  ``--out`` also
writes the numbers as JSON.  Needs a CUDA device.
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
    result = {"card": card}
    result.update(serving_forward_profile(chip_smoke.CONFIG, "OpenSegTester",
                                          True, args.iters))
    write_result(result, args.out)


if __name__ == "__main__":
    main()
