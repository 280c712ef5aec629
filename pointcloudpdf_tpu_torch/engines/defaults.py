"""Engine defaults: argument parsing, config resolution, run setup.

Counterpart of ``pointcloudpdf_tpu/engines/defaults.py``: the same
config-name protocol (``configs/<dataset>/<name>.py`` or the
``dataset/name`` shorthand), ``--options k=v`` overrides, save-path layout
and ``--num-gpus`` (ranks on this machine, see ``launch``), plus
``--device``.  A config's batch sizes are totals over ranks: each rank's
loader takes ``batch_size // world`` (the reference's
``batch_size_per_gpu``).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..utils import comm
from ..utils.config import Config, DictAction
from ..utils.env import get_random_seed, set_seed
from ..utils.logger import get_root_logger


def default_argument_parser(epilog=None):
    parser = argparse.ArgumentParser(
        epilog=epilog or "pointcloudpdf_tpu_torch launcher", add_help=True)
    parser.add_argument(
        "--config-file", default="", metavar="FILE", help="path to config file")
    parser.add_argument(
        "--num-gpus", type=int, default=1,
        help="ranks on this machine, one a CUDA device (gloo ranks on the "
             "CPU with --device cpu)")
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the config's `device`, else "
             "cuda); cpu only when asked for")
    parser.add_argument(
        "--options", nargs="+", action=DictAction, help="custom options")
    return parser


def default_config_parser(file_path: str, options=None) -> Config:
    # config-name protocol: dataset/name -> configs/dataset/name.py
    if os.path.isfile(file_path):
        path = file_path
    else:
        path = os.path.join("configs", file_path)
        if not path.endswith(".py"):
            path += ".py"
    cfg = Config.fromfile(path)
    if options is not None:
        cfg.merge_from_dict(options)

    if cfg.get("seed", None) is None:
        cfg.seed = get_random_seed()

    cfg.setdefault("data_root", None)
    cfg.setdefault("weight", None)
    cfg.setdefault("resume", False)
    cfg.setdefault("evaluate", True)
    cfg.setdefault("test_only", False)
    cfg.setdefault("device", "cuda")

    if not cfg.get("save_path"):
        # exp/<dataset>/<config-name> layout
        rel = os.path.splitext(os.path.relpath(path, "configs"))[0] \
            if path.startswith("configs") else os.path.splitext(
                os.path.basename(path))[0]
        cfg.save_path = os.path.join("exp", rel)

    cfg.setdefault("eval_epoch", cfg.get("epoch", 1))
    assert cfg.epoch % cfg.eval_epoch == 0
    if "data" in cfg and "train" in cfg.data:
        cfg.data.train.loop = cfg.epoch // cfg.eval_epoch
    return cfg


def per_rank_batch(batch_size) -> int:
    """One rank's share of a config's total batch size (1 when the config
    leaves it None); the total must divide evenly over the ranks."""
    if batch_size is None:
        return 1
    world = comm.get_world_size()
    if batch_size % world:
        raise ValueError(f"batch size {batch_size} does not divide over "
                         f"{world} ranks")
    return batch_size // world


def batch_condition(collated):
    """The dataset condition of a collated batch (the ``condition`` strings
    the configs' ``Add`` transform puts on each sample), or None where the
    samples carry none.  A batch holds one condition: its samples share
    the PD norms' bank and the PPT context."""
    conditions = collated.get("condition")
    if conditions is None:
        return None
    if isinstance(conditions, str):
        return conditions
    if len(set(conditions)) != 1:
        raise ValueError(f"a batch holds one dataset condition, got {sorted(set(conditions))}")
    return conditions[0]


def default_setup(cfg: Config) -> Config:
    for key in ("batch_size", "batch_size_val", "batch_size_test"):
        per_rank_batch(cfg.get(key))
    # the seeds (data augmentation, initialisation) differ by rank, rank 0
    # keeps a one-process run's; the trainer takes rank 0's weights
    seed = set_seed(None if cfg.get("seed") is None
                    else cfg.seed * 2 + comm.get_rank())
    torch.manual_seed(seed)
    os.makedirs(cfg.save_path, exist_ok=True)
    main = comm.is_main_process()
    logger = get_root_logger(
        log_file=os.path.join(cfg.save_path, "train.log") if main else None)
    if comm.is_distributed():
        logger.info(f"Rank {comm.get_rank()} of {comm.get_world_size()}")
    logger.info(f"Save path: {cfg.save_path}")
    logger.info(f"Config:\n{cfg.pretty_text}")
    if main:
        cfg.dump(os.path.join(cfg.save_path, "config.py"))
    return cfg
