"""Testing entry point of the PyTorch port (counterpart of tools/test.py).

Same flags and config files as tools/test.py, plus ``--device`` (default:
the config's ``device``, else ``cuda``; the CPU runs only when asked for).
``--num-gpus N`` runs N ranks, one a CUDA device (gloo ranks with
``--device cpu``); each takes every N-th scene and rank 0 reports:

    python tools/test_torch.py \
        --config-file configs/s3dis/openseg-pt-v1-0-pointpdf-v1m1-base.py \
        --options weight=model.pth save_path=exp/run --device cuda
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pointcloudpdf_tpu_torch.engines import (  # noqa: E402
    default_argument_parser,
    default_config_parser,
)
from pointcloudpdf_tpu_torch.engines.launch import launch  # noqa: E402
from pointcloudpdf_tpu_torch.engines.test import test_worker  # noqa: E402


def main():
    args = default_argument_parser().parse_args()
    cfg = default_config_parser(args.config_file, args.options)
    if args.device is not None:
        cfg.device = args.device
    launch(test_worker, num_gpus_per_machine=args.num_gpus, cfg=(cfg,),
           device=cfg.device)


if __name__ == "__main__":
    main()
