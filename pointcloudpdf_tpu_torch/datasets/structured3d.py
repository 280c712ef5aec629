# Copied from pointcloudpdf_tpu/datasets/structured3d.py; keep in step.
"""Structured3D panoramic indoor dataset.

Reference: pointcept/datasets/structure3d.py — preprocessed scenes under
``<root>/<split>`` with multiple splits glommed together; scenes carry
coord/color/normal/semantic_gt like ScanNet.
"""

from __future__ import annotations

import glob
import os

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class Structured3DDataset(DefaultDataset):
    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for split in splits:
            for ext in (".pth", ".npz", ".npy"):
                data_list += glob.glob(
                    os.path.join(self.data_root, split, "scene*", f"room*{ext}")
                ) + glob.glob(os.path.join(self.data_root, split, f"*{ext}"))
        return sorted(data_list)

    def get_data_name(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        room = os.path.splitext(os.path.basename(path))[0]
        scene = os.path.basename(os.path.dirname(path))
        return f"{scene}_{room}" if scene.startswith("scene") else room
