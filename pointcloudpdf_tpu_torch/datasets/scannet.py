# Copied from pointcloudpdf_tpu/datasets/scannet.py; keep in step.
"""ScanNet / ScanNet200 datasets (reference: pointcept/datasets/scannet.py).

Per-scene files with keys coord/color/normal/semantic_gt20 (or 200)/
instance_gt/scene_id; supports data-efficient limited-reconstruction
(lr_file) and limited-annotation (la_file) protocols, and the benchmark
class-id mapping for submissions.
"""

from __future__ import annotations

import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene
from .scannet_constants import VALID_CLASS_IDS_20, VALID_CLASS_IDS_200


@DATASETS.register_module()
class ScanNetDataset(DefaultDataset):
    class2id = np.array(VALID_CLASS_IDS_20)
    segment_key = "semantic_gt20"

    def __init__(
        self,
        split="train",
        data_root="data/scannet",
        lr_file=None,
        la_file=None,
        ignore_index=-1,
        cache=False,
        **kwargs,
    ):
        self.lr_file = lr_file
        self.cache = cache
        self._cache_store = {}
        super().__init__(split=split, data_root=data_root, **kwargs)
        if la_file:
            import torch

            self.la = torch.load(la_file, map_location="cpu", weights_only=False)
        else:
            self.la = None
        self.ignore_index = ignore_index

    def get_data_list(self):
        if self.lr_file:
            return [
                os.path.join(self.data_root, "train", name + ".pth")
                for name in np.loadtxt(self.lr_file, dtype=str)
            ]
        return super().get_data_list()

    def get_data(self, idx):
        data_path = self.data_list[idx % len(self.data_list)]
        if self.cache and data_path in self._cache_store:
            data = self._cache_store[data_path]
        else:
            data = load_scene(data_path)
            if self.cache:
                self._cache_store[data_path] = data
        coord = data["coord"]
        segment = (
            data[self.segment_key].reshape(-1)
            if self.segment_key in data
            else np.full(coord.shape[0], -1)
        )
        instance = (
            data["instance_gt"].reshape(-1)
            if "instance_gt" in data
            else np.full(coord.shape[0], -1)
        )
        out = dict(
            coord=coord,
            normal=data["normal"],
            color=data["color"],
            segment=segment.copy(),
            instance=instance,
            scene_id=data.get("scene_id", self.get_data_name(idx)),
        )
        if self.la is not None:
            # limited-annotation: only the sampled points keep labels
            sampled_index = self.la[self.get_data_name(idx)]
            masked = np.ones_like(out["segment"], dtype=bool)
            masked[sampled_index] = False
            out["segment"][masked] = self.ignore_index
            out["sampled_index"] = sampled_index
        return out

    def prepare_test_data(self, idx):
        data_dict = self.get_data(idx)
        segment = data_dict.pop("segment")
        data_dict = self.transform(data_dict)
        from copy import deepcopy

        fragments = []
        for aug in self.aug_transform:
            aug_data = aug(deepcopy(data_dict))
            parts = (
                self.test_voxelize(aug_data)
                if self.test_voxelize is not None
                else [dict(aug_data, index=np.arange(aug_data["coord"].shape[0]))]
            )
            for part in parts:
                crops = self.test_crop(part) if self.test_crop is not None else [part]
                fragments += crops
        fragments = [self.post_transform(f) for f in fragments]
        return dict(
            fragment_list=fragments, segment=segment, name=self.get_data_name(idx)
        )


@DATASETS.register_module()
class ScanNet200Dataset(ScanNetDataset):
    class2id = np.array(VALID_CLASS_IDS_200)
    segment_key = "semantic_gt200"
