# Copied from pointcloudpdf_tpu/datasets/nuscenes.py; keep in step.
"""nuScenes LiDAR segmentation dataset.

Reference: pointcept/datasets/nuscenes.py — info pickles list scenes with
lidar bin paths (x,y,z,intensity,ring float32 x5) and lidarseg uint8
labels, remapped to 16 training classes via the standard nuScenes
lidarseg mapping.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset

# raw lidarseg id -> train id (None = ignore); nuScenes official mapping
_RAW_TO_TRAIN = {
    0: None, 1: None, 2: 6, 3: 6, 4: 6, 5: None, 6: 6, 7: None, 8: None,
    9: 0, 10: None, 11: None, 12: 7, 13: None, 14: 1, 15: 2, 16: 2,
    17: 3, 18: 4, 19: None, 20: None, 21: 5, 22: 8, 23: 9, 24: 10,
    25: 11, 26: 12, 27: 13, 28: 14, 29: None, 30: 15, 31: None,
}


@DATASETS.register_module()
class NuScenesDataset(DefaultDataset):
    def __init__(self, split="train", data_root="data/nuscenes", sweeps=10,
                 ignore_index=-1, **kwargs):
        self.sweeps = sweeps
        self.ignore_index = ignore_index
        lut = np.full(32, ignore_index, np.int64)
        for raw, train_id in _RAW_TO_TRAIN.items():
            lut[raw] = ignore_index if train_id is None else train_id
        self._lut = lut
        self.learning_map = {
            k: (ignore_index if v is None else v)
            for k, v in _RAW_TO_TRAIN.items()
        }
        super().__init__(split=split, data_root=data_root, **kwargs)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for split in splits:
            info_path = os.path.join(
                self.data_root, "info",
                f"nuscenes_infos_{self.sweeps}sweeps_{split}.pkl",
            )
            with open(info_path, "rb") as f:
                data_list.extend(pickle.load(f))
        return data_list

    def get_data(self, idx):
        info = self.data_list[idx % len(self.data_list)]
        lidar_path = os.path.join(self.data_root, "raw", info["lidar_path"])
        points = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 5)
        coord = points[:, :3]
        strength = points[:, 3:4] / 255.0
        if "gt_segment_path" in info:
            seg_path = os.path.join(self.data_root, "raw", info["gt_segment_path"])
            raw = np.fromfile(seg_path, dtype=np.uint8).reshape(-1)
            segment = self._lut[raw]
        else:
            segment = np.full(points.shape[0], self.ignore_index, np.int64)
        return dict(coord=coord, strength=strength, segment=segment)

    def get_data_name(self, idx):
        return self.data_list[idx % len(self.data_list)]["lidar_token"]
