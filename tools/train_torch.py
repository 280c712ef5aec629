"""Training entry point of the PyTorch port (counterpart of tools/train.py).

Same flags and config files as tools/train.py, plus ``--device`` (default:
the config's ``device``, else ``cuda``; the CPU runs only when asked for).
One process on one device:

    python tools/train_torch.py \
        --config-file configs/s3dis/openseg-pt-v1-0-pointpdf-v1m1-base.py \
        --options save_path=exp/run --device cuda
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pointcloudpdf_tpu_torch.engines import (  # noqa: E402
    default_argument_parser,
    default_config_parser,
    default_setup,
)
from pointcloudpdf_tpu_torch.engines.train import TRAINERS  # noqa: E402


def main():
    args = default_argument_parser().parse_args()
    if args.num_gpus != 1:
        raise SystemExit("tools/train_torch.py runs one process on one device")
    cfg = default_config_parser(args.config_file, args.options)
    if args.device is not None:
        cfg.device = args.device
    cfg = default_setup(cfg)
    trainer = TRAINERS.build(
        dict(type=cfg.get("train", {}).get("type", "DefaultTrainer"), cfg=cfg)
    )
    trainer.train()


if __name__ == "__main__":
    main()
