"""The PyTorch port runs where JAX is not installed (the GPU machine has
none): with ``import jax`` / ``import flax`` made to fail, the whole
package imports, the shipped open-set configs load, a Seg26 forward, a
narrow Stratified Transformer forward (ST-v1m1 + ST recognizer) and a narrow
PT-v2m2 forward run on the CPU, the open-set trainer takes one training step,
the incremental trainer one distillation step and the default trainer one
PT-v2m2 step (CE + Lovasz) and one CAC-v1m1 step, a narrow SpUNet-v1m1
forward and step from the shipped S3DIS config and a CAC-v1m1 step over
it, a narrow PT-v3m1 forward and step from the shipped S3DIS ``-rpe``
config, one ``MultiDatasetTrainer`` step of a narrow PPT-v1m1 from the
shipped S3DIS PPT config, narrow Swin3D and OctFormer forwards from the
shipped S3DIS and ScanNet configs, a narrow PointGroup step, eval forward
and proposals from the shipped S3DIS PointGroup config (and the ScanNet200
one loaded), a narrow OA-CNNs forward from the shipped ScanNet config, and
``launch`` runs a
gloo group of one (the data-parallel engine's collectives).  The port's
own copy of the native voxel hash is held against the numpy branch here
too.
"""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib.abc, sys

class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, ROOT)

import importlib, pkgutil
import numpy as np
import torch
import pointcloudpdf_tpu_torch as pkg

for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)

from pointcloudpdf_tpu_torch.datasets import build_dataset, TRANSFORMS
from pointcloudpdf_tpu_torch.engines import default_config_parser
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.recognizers import build_recognizer

cfg = default_config_parser(
    ROOT + "/configs/s3dis/openseg-pt-v1-0-pointpdf-v1m1-base.py")
assert cfg.device == "cuda"
cfg.model.backbone.type = "PointTransformer-Seg26"
torch.manual_seed(0)
model = build_model(dict(cfg.model)).eval()
rec = build_recognizer(cfg.recognizer)
rec.model.eval()
rng = np.random.RandomState(0)
coord = rng.rand(300, 3).astype(np.float32) * 2
grid = TRANSFORMS.build(dict(cfg.data.test.test_cfg.voxelize))
parts = grid(dict(coord=coord, color=rng.rand(300, 3).astype(np.float32)))
assert sum(len(p["index"]) for p in parts) == 300
n = 512
batch = dict(coord=torch.from_numpy(rng.rand(1, n, 3).astype(np.float32)),
             feat=torch.from_numpy(rng.rand(1, n, 6).astype(np.float32)),
             mask=torch.arange(n)[None] < 400)
with torch.inference_mode():
    out = model(batch)
    score = rec.score(out["seg_logits"], rec.model(out["intermediates"]))
assert out["seg_logits"].shape == (1, n, 13) and score.shape == (1, n)
assert torch.isfinite(out["seg_logits"]).all() and torch.isfinite(score).all()

# the shipped Stratified Transformer config at narrow widths: ST-v1m1 + the
# ST recognizer, eval forward and score
st_cfg = default_config_parser(
    ROOT + "/configs/s3dis/openseg-st-v1m1-0-origin-pointpdf-v1m1-base.py")
assert st_cfg.model.backbone.type == "ST-v1m1" and st_cfg.optimizer.type == "AdamW"
narrow = dict(channels=[16, 32, 32, 64], num_heads=[1, 2, 2, 4])
st_cfg.model.backbone.update(depths=[1, 2, 2, 1], k_local=8, k_sparse=4, **narrow)
st_cfg.recognizer.recognizer.channels = narrow["channels"]
st_model = build_model(dict(st_cfg.model)).eval()
st_rec = build_recognizer(st_cfg.recognizer)
st_rec.model.eval()
with torch.inference_mode():
    out = st_model(batch)
    score = st_rec.score(out["seg_logits"], st_rec.model(out["intermediates"]))
assert out["seg_logits"].shape == (1, n, 13) and score.shape == (1, n)
assert torch.isfinite(out["seg_logits"]).all() and torch.isfinite(score).all()
assert out["intermediates"]["enc3"].feat.shape == (1, n // 64, 64)
assert (out["seg_logits"][0, 400:] == 0).all()

# the shipped PT-v2m2 config at narrow widths: eval forward, nothing dropped
# by the pooling capacity
from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2

v2_cfg = default_config_parser(ROOT + "/configs/s3dis/semseg-pt-v2m2-0-base.py")
assert v2_cfg.model.backbone.type == "PT-v2m2"
v2_cfg.model.backbone.update(
    patch_embed_channels=16, patch_embed_groups=2, enc_depths=(1, 1, 1),
    enc_channels=(16, 32, 32), enc_groups=(2, 4, 4), dec_channels=(16, 16, 32),
    dec_groups=(2, 2, 4), grid_sizes=(0.2, 0.4, 0.8))
v2_model = build_model(dict(v2_cfg.model)).eval()
ptv2.capacity_dropped_points(reset=True)
with torch.inference_mode():
    out = v2_model(batch)
assert out["seg_logits"].shape == (1, n, 13)
assert torch.isfinite(out["seg_logits"]).all()
assert (out["seg_logits"][0, 400:] == 0).all()
assert ptv2.capacity_dropped_points(reset=True) == 0

# one open-set training step of Seg26 + the PDF recognizer
from pointcloudpdf_tpu_torch.datasets import DATASETS
from pointcloudpdf_tpu_torch.engines.train import TRAINERS


class _Scenes:
    def __init__(self, **kwargs):
        pass

    def __len__(self):
        return 4


DATASETS.register_module("NoJaxScenes", module=_Scenes)
cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                     "enable_amp": False, "evaluate": False, "hooks": [],
                     "epoch": 2, "eval_epoch": 2, "recognizer.start_epoch": 0})
cfg.data.train = dict(type="NoJaxScenes")
trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=cfg))
segment = rng.randint(0, 13, (2, n)).astype(np.int64)
input_dict = dict(coord=rng.rand(2, n, 3).astype(np.float32),
                  feat=rng.rand(2, n, 6).astype(np.float32),
                  segment=segment, segment_known=np.where(segment == 5, -1, segment),
                  count=np.array([n, 400], np.int32))
before = trainer.model.backbone.cls[3].weight.detach().clone()
trainer._dispatch_train(trainer.device_batch(input_dict), 0.01)
out = trainer.comm_info["model_output_dict"]
assert all(np.isfinite(float(out[k])) for k in ("loss", "seg_loss", "loss_rec"))
assert not torch.equal(before, trainer.model.backbone.cls[3].weight)
assert trainer.state_dict()["step"] == 1

# one incremental step of the shipped incr config at Seg26: a frozen teacher
# (13 classes) distilled into a student with two more
from pointcloudpdf_tpu_torch.datasets import ScanNet200Dataset, ScanNetDataset
from pointcloudpdf_tpu_torch.incr_learners import PointPdfIncrV1

incr_cfg = default_config_parser(
    ROOT + "/configs/s3dis/incrseg-pt-v1-0-pointpdf-v1m1-base.py")
assert incr_cfg.train.type == "IncrSegTrainer" and incr_cfg.test.type == "IncrSegTester"
incr_cfg.model.backbone.type = "PointTransformer-Seg26"
incr_cfg.incremental_learner.backbone.type = "PointTransformer-Seg26"
incr_cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                          "enable_amp": False, "evaluate": False, "hooks": [],
                          "epoch": 2, "eval_epoch": 2})
incr_cfg.data.train = dict(type="NoJaxScenes")
incr = TRAINERS.build(dict(type="IncrSegTrainer", cfg=incr_cfg))
assert isinstance(incr.incr_learner, PointPdfIncrV1)
input_dict["segment_incr"] = np.where(segment == 5, 13, np.where(segment == 9, 14, -1))
teacher = {k: v.clone() for k, v in incr.model.state_dict().items()}
before = incr.student.cls[3].weight.detach().clone()
assert before.shape[0] == 15
incr._dispatch_train(incr.device_batch(input_dict))
assert np.isfinite(float(incr.comm_info["model_output_dict"]["loss"]))
assert not torch.equal(before, incr.student.cls[3].weight)
assert all(torch.equal(v, incr.model.state_dict()[k]) for k, v in teacher.items())
assert set(incr.state_dict()["params"]) == {"incr"}

# one DefaultTrainer step of the narrow PT-v2m2 with the Lovasz config's
# criteria (drop path from the trainer's generator, Mix3D's empty slot)
lovasz_cfg = default_config_parser(ROOT + "/configs/s3dis/semseg-pt-v2m2-0-lovasz.py")
v2_cfg.model.criteria = lovasz_cfg.model.criteria
v2_cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                        "enable_amp": False, "evaluate": False, "hooks": [],
                        "epoch": 2, "eval_epoch": 2})
v2_cfg.data.train = dict(type="NoJaxScenes")
v2 = TRAINERS.build(dict(type="DefaultTrainer", cfg=v2_cfg))
v2_input = dict(input_dict, count=np.array([n, 0], np.int32))
before = v2.model.backbone.seg_head[3].weight.detach().clone()
v2._dispatch_train(v2.device_batch(v2_input))
assert set(v2.comm_info["model_output_dict"]) == {"loss"}
assert np.isfinite(float(v2.comm_info["model_output_dict"]["loss"]))
assert not torch.equal(before, v2.model.backbone.seg_head[3].weight)
assert ptv2.capacity_dropped_points(reset=True) == 0

# one step of the shipped CAC-over-PT-v2 config at narrow widths: the
# model's own loss and its four parts
cac_cfg = default_config_parser(ROOT + "/configs/scannet/semseg-cac-v1m1-2-ptv2-lovasz.py")
assert cac_cfg.model.type == "CAC-v1m1"
cac_cfg.model.backbone.update(
    in_channels=6, patch_embed_channels=16, patch_embed_groups=2,
    enc_depths=(1, 1, 1, 1), enc_channels=(16, 32, 32, 32),
    enc_groups=(2, 4, 4, 4), dec_channels=(16, 16, 32, 32),
    dec_groups=(2, 2, 4, 4))
cac_cfg.model.backbone_out_channels = 16
cac_cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                         "enable_amp": False, "evaluate": False, "hooks": [],
                         "epoch": 2, "eval_epoch": 2})
cac_cfg.data.train = dict(type="NoJaxScenes")
cac = TRAINERS.build(dict(type="DefaultTrainer", cfg=cac_cfg))
cac_input = dict(input_dict, segment=np.where(segment < 5, segment, -1))
cac._dispatch_train(cac.device_batch(cac_input))
out = cac.comm_info["model_output_dict"]
assert set(out) == {"loss", "seg_loss", "pre_loss", "pre_self_loss", "kl_loss"}
assert all(np.isfinite(float(v)) for v in out.values())

# the shipped S3DIS SpUNet config at narrow widths: an eval forward, then one
# DefaultTrainer step (its PolyLR dict keeps the base's MultiStepLR keys,
# which the port drops); one step of CAC-v1m1 over SpUNet
from pointcloudpdf_tpu_torch.ops import voxel

sp_cfg = default_config_parser(ROOT + "/configs/s3dis/semseg-spunet-v1m1-0-base.py")
assert sp_cfg.model.backbone.type == "SpUNet-v1m1"
narrow = dict(base_channels=16, channels=(16, 16, 32, 32, 32, 16, 16, 16), layers=(1,) * 8)
sp_cfg.model.backbone.update(narrow)
sp_cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                        "enable_amp": False, "evaluate": False, "hooks": [],
                        "epoch": 2, "eval_epoch": 2})
sp_cfg.data.train = dict(type="NoJaxScenes")
sp = TRAINERS.build(dict(type="DefaultTrainer", cfg=sp_cfg))
cells = np.stack(np.meshgrid(np.arange(24), np.arange(24), np.arange(2)), -1).reshape(-1, 3)
grid = np.zeros((2, n, 3), np.int32)
grid[0, :n] = cells[rng.permutation(len(cells))[:n]]
grid[1, :400] = cells[rng.permutation(len(cells))[:400]]
sp_input = dict(input_dict, grid_coord=grid)
sp.model.eval()
voxel.capacity_dropped_points(reset=True)
with torch.inference_mode():
    logits = sp.model(sp.device_batch(sp_input))["seg_logits"]
assert logits.shape == (2, n, 13) and torch.isfinite(logits).all()
assert (logits[1, 400:] == 0).all()
before = sp.model.backbone.final.weight.detach().clone()
sp._dispatch_train(sp.device_batch(sp_input))
assert set(sp.comm_info["model_output_dict"]) == {"loss"}
assert np.isfinite(float(sp.comm_info["model_output_dict"]["loss"]))
assert not torch.equal(before, sp.model.backbone.final.weight)
assert voxel.capacity_dropped_points(reset=True) == 0
cac_sp_cfg = default_config_parser(ROOT + "/configs/scannet/semseg-cac-v1m1-0-spunet-base.py")
cac_sp_cfg.model.backbone.update(narrow)
cac_sp_cfg.model.backbone_out_channels = 16
cac_sp_cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                            "enable_amp": False, "evaluate": False, "hooks": [],
                            "epoch": 2, "eval_epoch": 2})
cac_sp_cfg.data.train = dict(type="NoJaxScenes")
cac_sp = TRAINERS.build(dict(type="DefaultTrainer", cfg=cac_sp_cfg))
cac_sp._dispatch_train(cac_sp.device_batch(dict(sp_input, segment=cac_input["segment"])))
out = cac_sp.comm_info["model_output_dict"]
assert set(out) == {"loss", "seg_loss", "pre_loss", "pre_self_loss", "kl_loss"}
assert all(np.isfinite(float(v)) for v in out.values())

# the shipped S3DIS PT-v3m1 -rpe config at narrow widths: an eval forward
# through DefaultSegmentorV2, then one DefaultTrainer step (AdamW,
# OneCycleLR, the "block" group, CE + Lovasz, drop path 0.3)
v3_cfg = default_config_parser(ROOT + "/configs/s3dis/semseg-pt-v3m1-0-rpe.py")
assert v3_cfg.model.type == "DefaultSegmentorV2" and v3_cfg.model.backbone.enable_rpe
v3_cfg.model.backbone.update(
    stride=(2,), enc_depths=(1, 1), enc_channels=(16, 16), enc_num_head=(2, 2),
    enc_patch_size=(32, 32), dec_depths=(1,), dec_channels=(16,), dec_num_head=(2,),
    dec_patch_size=(32,))
v3_cfg.model.backbone_out_channels = 16
v3_cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                        "enable_amp": False, "evaluate": False, "hooks": [],
                        "epoch": 2, "eval_epoch": 2})
v3_cfg.data.train = dict(type="NoJaxScenes")
v3 = TRAINERS.build(dict(type="DefaultTrainer", cfg=v3_cfg))
v3.model.eval()
with torch.inference_mode():
    logits = v3.model(v3.device_batch(sp_input))["seg_logits"]
assert logits.shape == (2, n, 13) and torch.isfinite(logits).all()
before = v3.model.seg_head.weight.detach().clone()
v3._dispatch_train(v3.device_batch(sp_input))
assert set(v3.comm_info["model_output_dict"]) == {"loss"}
assert np.isfinite(float(v3.comm_info["model_output_dict"]["loss"]))
assert not torch.equal(before, v3.model.seg_head.weight)
assert voxel.capacity_dropped_points(reset=True) == 0

# the shipped S3DIS PPT config at narrow widths: one MultiDatasetTrainer
# step of PPT-v1m1 over SpUNet-v1m3 under S3DIS (the batch's condition to
# the model), the other banks and the embedding table moved by weight decay
# alone (their zero gradients)
ppt_cfg = default_config_parser(ROOT + "/configs/s3dis/semseg-ppt-v1m1-0-s3-sc-st-spunet.py")
assert ppt_cfg.model.type == "PPT-v1m1" and ppt_cfg.train.type == "MultiDatasetTrainer"
ppt_cfg.model.backbone.update(base_channels=8, channels=(8, 8), layers=(1, 1),
                              context_channels=16)
ppt_cfg.model.update(backbone_out_channels=8, context_channels=16, embed_channels=32)
ppt_cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                         "enable_amp": False, "evaluate": False, "hooks": [],
                         "epoch": 2, "eval_epoch": 2})
ppt_cfg.data.train = dict(type="ConcatDataset", datasets=[dict(type="NoJaxScenes")] * 3)
ppt = TRAINERS.build(dict(type="MultiDatasetTrainer", cfg=ppt_cfg))
idle = ppt.model.backbone.conv_input[1].bns[0].weight.detach().clone()
ppt.comm_info["input_dict"] = dict(sp_input, condition=["S3DIS", "S3DIS"])
ppt.run_step()
assert set(ppt.comm_info["model_output_dict"]) == {"loss"}
assert np.isfinite(float(ppt.comm_info["model_output_dict"]["loss"]))
# SGD, Nesterov momentum 0.9, first step on a zero gradient: 1.9 lr wd p
decayed = idle * (1 - 1.9 * ppt.comm_info["lr"] * ppt_cfg.optimizer.weight_decay)
moved = ppt.model.backbone.conv_input[1].bns[0].weight.detach()
assert not torch.equal(moved, idle) and torch.allclose(moved, decayed, rtol=0, atol=1e-7)
assert ppt.model.embedding_table.weight.grad.abs().max() == 0

# the shipped S3DIS Swin3D-small and ScanNet OctFormer configs at narrow
# widths: an eval forward of each through DefaultSegmentor (Swin3D's kNN
# pooling and interpolation on the plain K1, its cRSE over colour and
# normal; OctFormer's dilated patches and FPN)
for path, update, channels in (
        ("s3dis/semseg-swin3d-v1m1-0-small.py",
         dict(depths=(1, 2, 1), channels=(8, 16, 16), num_heads=(2, 2, 2), num_layers=3,
              patch_cap=16), 9),
        ("scannet/semseg-octformer-v1m1-0-base.py",
         dict(channels=(8, 8, 16, 16), num_blocks=(2, 1, 1, 1), num_heads=(2, 2, 2, 2),
              fpn_channels=8, patch_size=8, dilation=2), 10)):
    wcfg = default_config_parser(ROOT + "/configs/" + path)
    wcfg.model.backbone.update(update)
    torch.manual_seed(0)
    wmodel = build_model(dict(wcfg.model)).eval()
    wbatch = dict(grid_coord=torch.from_numpy(grid), mask=torch.arange(n)[None] < torch.tensor(
        [[n], [400]]), feat=torch.rand(2, n, channels))
    with torch.inference_mode():
        logits = wmodel(wbatch)["seg_logits"]
    assert logits.shape == (2, n, wcfg.model.backbone.num_classes)
    assert torch.isfinite(logits).all() and (logits[1, 400:] == 0).all()

# the shipped S3DIS PointGroup config at narrow widths: one DefaultTrainer
# step (the model's loss and its three parts), an eval forward and the host
# proposals (ops.cluster); the ScanNet200 PointGroup config loads (it imports
# its class names by the JAX package's module path, read from the port)
pg_cfg = default_config_parser(ROOT + "/configs/s3dis/insseg-pointgroup-v1m1-0-spunet-base.py")
assert pg_cfg.model.type == "PG-v1m1"
pg_cfg.model.backbone.update(base_channels=8, channels=(8, 8), layers=(1, 1))
pg_cfg.model.backbone_out_channels = 8
pg_cfg.merge_from_dict({"device": "cpu", "batch_size": 2, "num_worker": 0,
                        "enable_amp": False, "evaluate": False, "hooks": [],
                        "epoch": 2, "eval_epoch": 2})
pg_cfg.data.train = dict(type="NoJaxScenes")
pg = TRAINERS.build(dict(type="DefaultTrainer", cfg=pg_cfg))
inst = (grid[..., 0] // 6) * 4 + grid[..., 1] // 6
centroid = np.zeros((2, n, 3), np.float32)
for b in range(2):
    for iid in np.unique(inst[b]):
        centroid[b][inst[b] == iid] = input_dict["coord"][b][inst[b] == iid].mean(0)
pg_input = dict(sp_input, instance=inst.astype(np.int64), instance_centroid=centroid)
pg.comm_info["input_dict"] = pg_input
pg.run_step()
assert set(pg.comm_info["model_output_dict"]) == {
    "loss", "seg_loss", "bias_l1_loss", "bias_cosine_loss"}
assert all(np.isfinite(float(v)) for v in pg.comm_info["model_output_dict"].values())
with torch.inference_mode():
    pg_out = pg.eval_step(pg.device_batch(pg_input))
masks, classes, scores = pg.model.propose(
    input_dict["coord"][0], pg_out["seg_logits"][0].numpy(), pg_out["bias_pred"][0].numpy(),
    np.ones(n, bool))
assert masks.shape[1:] == (n,) and len(classes) == len(scores)
s200 = default_config_parser(ROOT + "/configs/scannet200/insseg-pointgroup-spunet-0-base.py")
assert len(s200.data.names) == 200 and s200.model.segment_ignore_index == (-1, 0, 2)

# the shipped ScanNet OA-CNNs config at narrow widths: an eval forward
oa_cfg = default_config_parser(ROOT + "/configs/scannet/semseg-oacnns-v1m1-0-base.py")
assert oa_cfg.model.backbone.type == "OACNNs"
oa_cfg.model.backbone.update(embed_channels=8, enc_channels=(8, 16), enc_depth=(1, 1),
                             dec_channels=(8, 16), point_grid_size=((2, 3), (2, 3)))
torch.manual_seed(0)
oa = build_model(dict(oa_cfg.model)).eval()
with torch.inference_mode():
    logits = oa(sp.device_batch(sp_input))["seg_logits"]
assert logits.shape == (2, n, 20) and torch.isfinite(logits).all()
assert (logits[1, 400:] == 0).all()

from pointcloudpdf_tpu_torch.engines.launch import launch
from pointcloudpdf_tpu_torch.utils import comm
seen = []

def in_group():
    total = float(comm.sum_over_ranks(torch.ones(())))
    seen.append((comm.get_world_size(), comm.all_gather(comm.get_rank()), total))

launch(in_group, num_gpus_per_machine=1, backend="gloo", device="cpu")
assert seen == [(1, [0], 1.0)] and not comm.is_distributed()
assert not any(m.split(".")[0] in ("jax", "flax") for m in sys.modules)
print("NOJAX_OK")
"""


_OUTDOOR_SCRIPT = r"""
import importlib.abc, logging, os, sys, tempfile

class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, ROOT)

import numpy as np
import torch

import chip_smoke
from pointcloudpdf_tpu_torch.datasets import (NuScenesDataset, SemanticKITTIDataset,
                                              WaymoDataset, build_dataset)
from pointcloudpdf_tpu_torch.engines.train import TRAINERS

warnings = []
handler = logging.Handler()
handler.emit = lambda record: warnings.append(record.getMessage())
handler.setLevel(logging.WARNING)
logging.getLogger("pointcloudpdf_tpu_torch").addHandler(handler)

work = tempfile.mkdtemp()
rng = np.random.RandomState(0)
roots = {name: os.path.join(work, name) for name in ("semantic_kitti", "nuscenes", "waymo")}

def scan(name):
    return chip_smoke.lidar_scan(rng, name, beams=8, steps=64)

for seq, labels in ((0, True), (8, True), (11, False)):
    chip_smoke.write_semantic_kitti(roots["semantic_kitti"], seq, 0, scan("SemanticKITTI"),
                                    rng, labels=labels)
for split in ("train", "val", "test"):
    chip_smoke.write_nuscenes(roots["nuscenes"], split, [scan("nuScenes")], rng,
                              labels=split != "test")
for split in ("training", "validation"):
    chip_smoke.write_waymo(roots["waymo"], split, "segment-0", 0, scan("Waymo"), rng)
for cls, root, split in ((SemanticKITTIDataset, "semantic_kitti", "val"),
                         (NuScenesDataset, "nuscenes", "val"), (WaymoDataset, "waymo", "training")):
    item = cls(split=split, data_root=roots[root])[0]
    assert item["coord"].shape == (512, 3) and item["strength"].shape == (512, 1)

configs = sorted(os.path.join(d, f) for d in ("semantic_kitti", "nuscenes", "waymo")
                 for f in os.listdir(os.path.join(ROOT, "configs", d)) if "spvcnn" not in f)
assert len(configs) == 17, configs
for rel in configs:
    cfg = chip_smoke.config_with_roots(os.path.join(ROOT, "configs", rel), roots, {
        "device": "cpu", "batch_size": 1, "num_worker": 0, "hooks": [],
        "save_path": os.path.join(work, "exp")})
    trainer = TRAINERS.build(dict(type=cfg.get("train", {}).get("type", "DefaultTrainer"),
                                  cfg=cfg))
    assert len(trainer.train_loader) >= 1 and trainer.optimizer and trainer.scheduler
    test = build_dataset(dict(cfg.data.test)) if "test" in cfg.data else None
    print(rel, type(trainer).__name__, cfg.model.type,
          cfg.model.get("backbone", {}).get("type"), sum(p.numel() for p in
                                                       trainer.model.parameters()),
          len(test) if test is not None else None)
for w in sorted(set(warnings)):
    print("WARNING", w)
assert not any(m.split(".")[0] in ("jax", "flax") for m in sys.modules)
print("OUTDOOR_NOJAX_OK")
"""


def test_outdoor_configs_build_without_jax():
    """With ``jax`` blocked: the SemanticKITTI, nuScenes and Waymo datasets
    read scans written in their layouts, and every one of the 17 shipped
    outdoor configs (all of ``configs/{semantic_kitti,nuscenes,waymo}`` but
    SPVCNN's) builds its trainer over them: model at full width, datasets
    (a PPT config's three through ``MultiDatasetTrainer``), optimizer and
    schedule, and its test dataset."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _OUTDOOR_SCRIPT],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OUTDOOR_NOJAX_OK" in proc.stdout


def test_port_runs_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _SCRIPT],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


@pytest.mark.parametrize("path", [
    "pointcloudpdf_tpu_torch", "chip_smoke.py", "tools/test_torch.py",
    "tools/train_torch.py", "tools/profile_train_torch.py",
    "tools/profile_st_torch.py", "tools/profile_ptv2_torch.py",
    "tools/_profile_torch.py", "tools/attn_fwd_compare_torch.py",
    "tools/attn_bwd_compare_torch.py", "tools/st_attention_compare_torch.py",
    "tools/fps_compare_torch.py", "tools/kpconv_compare_torch.py",
    "tools/kpconv_clocks.py", "tools/ptv3_rpe_compare_torch.py",
    "tools/insseg_cluster_time.py",
    "tests/test_torch_kernels.py",
    "tests/test_torch_fps_windows.py", "tests/test_torch_kpconv_tiles.py",
    "tests/torch_ddp_ranks.py"])
def test_no_jax_import_in_port_sources(path):
    # the JAX package is off limits too, every module of it
    pattern = re.compile(r"^\s*(import|from) (jax|flax|pointcloudpdf_tpu\b(?!_torch))")
    full = os.path.join(ROOT, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    hits = [f"{f}:{i + 1}: {line.rstrip()}" for f in files
            for i, line in enumerate(open(f))
            if pattern.match(line)]
    assert not hits, hits


def test_native_copy_matches_numpy_branch():
    """The port's own voxel-hash library (built from its csrc at first use)
    against the numpy argsort/unique branch of GridSample: the same FNV keys,
    the same grouping of points by voxel, the same sampled cloud."""
    import numpy as np

    from pointcloudpdf_tpu_torch import native
    from pointcloudpdf_tpu_torch.datasets import transform

    if not native.available():
        pytest.skip("no host C++ compiler to build the native library")
    assert os.path.dirname(native._SO_PATH).endswith(
        os.path.join("pointcloudpdf_tpu_torch", "_build"))
    rng = np.random.RandomState(0)
    grid = rng.randint(0, 12, (4000, 3)).astype(np.int32)
    keys = native.fnv_hash(grid)
    np.testing.assert_array_equal(
        keys, transform.fnv_hash_vec(grid).astype(np.uint64))
    order, inverse, counts, starts = native.voxel_unique(keys)
    uniq, inv_np, cnt_np = np.unique(keys, return_inverse=True,
                                     return_counts=True)
    assert len(counts) == len(uniq) and counts.sum() == len(grid)
    # the same partition: voxel ids differ by a relabelling only
    relabel = np.full(len(counts), -1)
    relabel[inverse] = inv_np
    np.testing.assert_array_equal(relabel[inverse], inv_np)
    np.testing.assert_array_equal(counts, cnt_np[relabel])
    np.testing.assert_array_equal(np.diff(starts), counts)
    assert (np.diff(inverse[order]) >= 0).all()

    coord = rng.rand(3000, 3).astype(np.float32) * 3
    sample = transform.GridSample(grid_size=0.1, hash_type="fnv", mode="test",
                                  keys=("coord",), return_grid_coord=True)
    with_native = sample(dict(coord=coord.copy()))
    old = native.available
    native.available = lambda: False
    try:
        with_numpy = sample(dict(coord=coord.copy()))
    finally:
        native.available = old
    # fragments of one point per voxel that together cover the cloud
    assert len(with_native) == len(with_numpy)
    for parts in (with_native, with_numpy):
        np.testing.assert_array_equal(
            np.unique(np.concatenate([p["index"] for p in parts])),
            np.arange(3000))
    assert ([len(p["index"]) for p in with_native]
            == [len(p["index"]) for p in with_numpy])
