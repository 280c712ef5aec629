# Copied from pointcloudpdf_tpu/datasets/waymo.py; keep in step.
"""Waymo Open Dataset semantic segmentation.

Reference: pointcept/datasets/waymo.py — preprocessed sequence folders of
``velodyne/*.bin`` (x,y,z,intensity) + ``labels/*.label`` (pairs of
int32, second column = class id, 0 = unlabeled shifted to -1); intensity
is tanh-squashed.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class WaymoDataset(DefaultDataset):
    def __init__(self, split="training", data_root="data/waymo",
                 ignore_index=-1, **kwargs):
        self.ignore_index = ignore_index
        super().__init__(split=split, data_root=data_root, **kwargs)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for split in splits:
            data_list += glob.glob(
                os.path.join(self.data_root, split, "*", "velodyne", "*.bin")
            )
        return sorted(data_list)

    def get_data(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        coord = scan[:, :3]
        strength = np.tanh(scan[:, 3:4])
        label_path = path.replace("velodyne", "labels").replace(".bin", ".label")
        if os.path.isfile(label_path):
            segment = np.fromfile(label_path, dtype=np.int32).reshape(-1, 2)[:, 1] - 1
        else:
            segment = np.zeros(scan.shape[0], np.int32)
        return dict(coord=coord, strength=strength, segment=segment)

    def get_data_name(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        seq = os.path.basename(os.path.dirname(os.path.dirname(path)))
        frame = os.path.splitext(os.path.basename(path))[0]
        return f"{seq}_{frame}"
