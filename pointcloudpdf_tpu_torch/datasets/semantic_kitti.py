# Copied from pointcloudpdf_tpu/datasets/semantic_kitti.py; keep in step (one
# repair: ``learning_map_inv``).
"""SemanticKITTI outdoor LiDAR dataset.

Reference: pointcept/datasets/semantic_kitti.py — sequence folders of
``velodyne/*.bin`` (x,y,z,remission float32) with ``labels/*.label``
(lower 16 bits = raw class id), remapped to the 19-class learning set.
The raw→train id tables are the standard semantic-kitti-api mappings;
remapping here uses a dense lookup array instead of np.vectorize.
"""

from __future__ import annotations

import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset

# raw id -> train id (None = ignore); semantic-kitti-api semantic mapping
_RAW_TO_TRAIN = {
    0: None, 1: None, 10: 0, 11: 1, 13: 4, 15: 2, 16: 4, 18: 3, 20: 4,
    30: 5, 31: 6, 32: 7, 40: 8, 44: 9, 48: 10, 49: 11, 50: 12, 51: 13,
    52: None, 60: 8, 70: 14, 71: 15, 72: 16, 80: 17, 81: 18, 99: None,
    252: 0, 253: 6, 254: 5, 255: 7, 256: 4, 257: 4, 258: 3, 259: 4,
}
# train id -> canonical raw id (submission writer)
_TRAIN_TO_RAW = {
    0: 10, 1: 11, 2: 15, 3: 18, 4: 20, 5: 30, 6: 31, 7: 32, 8: 40, 9: 44,
    10: 48, 11: 49, 12: 50, 13: 51, 14: 70, 15: 71, 16: 72, 17: 80, 18: 81,
}

_SPLIT_SEQS = dict(
    train=(0, 1, 2, 3, 4, 5, 6, 7, 9, 10),
    val=(8,),
    test=(11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21),
)


@DATASETS.register_module()
class SemanticKITTIDataset(DefaultDataset):
    def __init__(self, split="train", data_root="data/semantic_kitti",
                 ignore_index=-1, **kwargs):
        self.ignore_index = ignore_index
        lut = np.full(260, ignore_index, np.int32)
        for raw, train_id in _RAW_TO_TRAIN.items():
            lut[raw] = ignore_index if train_id is None else train_id
        self._lut = lut
        self.learning_map = {
            k: (ignore_index if v is None else v)
            for k, v in _RAW_TO_TRAIN.items()
        }
        # the JAX package's ``dict({ignore_index: ignore_index}, **_TRAIN_TO_RAW)``
        # raises (int keywords): its dataset cannot be built (ROADMAP §3 item 39)
        self.learning_map_inv = {ignore_index: ignore_index, **_TRAIN_TO_RAW}
        super().__init__(split=split, data_root=data_root, **kwargs)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for split in splits:
            for seq in _SPLIT_SEQS[split]:
                seq_dir = os.path.join(
                    self.data_root, "dataset", "sequences", f"{seq:02d}"
                )
                vel = os.path.join(seq_dir, "velodyne")
                if os.path.isdir(vel):
                    data_list += [
                        os.path.join(vel, f) for f in sorted(os.listdir(vel))
                    ]
        return data_list

    def get_data(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        coord = scan[:, :3]
        strength = scan[:, 3:4]
        label_path = path.replace("velodyne", "labels").replace(".bin", ".label")
        if os.path.isfile(label_path):
            raw = np.fromfile(label_path, dtype=np.int32).reshape(-1) & 0xFFFF
            segment = self._lut[raw]
        else:
            segment = np.zeros(scan.shape[0], np.int32)
        return dict(coord=coord, strength=strength, segment=segment)

    def get_data_name(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        seq = os.path.basename(os.path.dirname(os.path.dirname(path)))
        frame = os.path.splitext(os.path.basename(path))[0]
        return f"{seq}_{frame}"
