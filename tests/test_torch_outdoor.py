"""The port's outdoor LiDAR slice against the JAX package on the CPU: the
SemanticKITTI, nuScenes and Waymo datasets (every shipped transform chain,
test fragments included), the testers' submission writers, the port's wide
voxel keys against a numpy oracle, and a SpUNet-v1m1 and a PT-v2m2 forward
with the outdoor configs' shapes.

Scans are small seeded synthetic ones written in each dataset's layout by
``chip_smoke``'s writers (``lidar_scan``: a spinning LiDAR's rings cast
against a ground plane, boxes, poles and a square of walls; 16 beams here).
The JAX ``SemanticKITTIDataset`` cannot be constructed (its
``learning_map_inv`` passes int keywords to ``dict``, ROADMAP §3 item 39):
its items are taken from an instance made without that line
(``jax_semantic_kitti``).  Past the JAX keys' 2,048 x 2,048 x 1,024 cells
the JAX package wraps and is no oracle: the wide-key tables are held
against ``np.unique`` and a dict of cells, and every input held against
the JAX package is asserted to lie inside its budget.

Tolerances: dataset items, files and tables bit-equal; a whole forward
1e-4 x max |logit|.
"""

import copy
import functools
import os
import random
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.datasets import DATASETS as JAX_DATASETS
from pointcloudpdf_tpu.datasets import semantic_kitti as jsk
from pointcloudpdf_tpu.datasets.defaults import DefaultDataset as JaxDefaultDataset
from pointcloudpdf_tpu.datasets.scannet import ScanNet200Dataset as JaxScanNet200
from pointcloudpdf_tpu.datasets.scannet import ScanNetDataset as JaxScanNet
from pointcloudpdf_tpu.engines.test import SemSegTester as JaxSemSegTester
from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models.point_transformer_v2 import ptv2 as jptv2
from pointcloudpdf_tpu.models.sparse_unet import spconv_unet as jsp
from pointcloudpdf_tpu.models.swin3d import swin3d as jswin
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.ops import voxel as jvox
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict
from pointcloudpdf_tpu_torch.datasets import DATASETS, padded_collate_fn
from pointcloudpdf_tpu_torch.datasets.scannet import ScanNet200Dataset, ScanNetDataset
from pointcloudpdf_tpu_torch.engines.test import TESTERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2 as port_ptv2
from pointcloudpdf_tpu_torch.models.swin3d import swin3d as port_swin
from pointcloudpdf_tpu_torch.ops import voxel
from pointcloudpdf_tpu_torch.utils.config import Config

import chip_smoke
from test_torch_model import MODEL, RECOGNIZER
from test_torch_ptv2 import port_tree
from test_torch_spunet import jax_forward, models
from test_torch_st import japply, knn_tie_gap, tt
from test_torch_st_train import _assert_items_equal, _scannet_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4             # x max |logit|
BEAMS, STEPS = 16, 128  # a test scan's rays: 2,048 points
JAX_LIMITS = (2048, 2048, 1024)  # the JAX keys' cells an axis
JITTER_SEED = 2  # the PT-v2 forward's input jitter: a seed whose kNN tables are tie-free


def scan(rng, name):
    return chip_smoke.lidar_scan(rng, name, beams=BEAMS, steps=STEPS)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Each dataset's layout with a few small scans: SemanticKITTI seq 00
    (train, two frames), 08 (val), 11 (test, no labels); nuScenes train (2),
    val (1), test (1, no labels); Waymo training (2) and validation (1)."""
    base = tmp_path_factory.mktemp("outdoor")
    rng = np.random.RandomState(0)
    out = {name: str(base / name) for name in ("semantic_kitti", "nuscenes", "waymo")}
    for seq, frames, labels in ((0, 2, True), (8, 1, True), (11, 1, False)):
        for f in range(frames):
            chip_smoke.write_semantic_kitti(out["semantic_kitti"], seq, f,
                                            scan(rng, "SemanticKITTI"), rng, labels=labels)
    for split, count, labels in (("train", 2, True), ("val", 1, True), ("test", 1, False)):
        chip_smoke.write_nuscenes(out["nuscenes"], split,
                                  [scan(rng, "nuScenes") for _ in range(count)], rng,
                                  labels=labels)
    for split, count in (("training", 2), ("validation", 1)):
        for f in range(count):
            chip_smoke.write_waymo(out["waymo"], split, f"segment-{split}", f,
                                   scan(rng, "Waymo"), rng)
    return out


def jax_semantic_kitti(split="train", data_root="data/semantic_kitti", ignore_index=-1,
                       **kwargs):
    """The JAX ``SemanticKITTIDataset``, made as its constructor makes it
    but for the line that raises (its ``learning_map_inv``, set here as it
    means to be): every item comes from the JAX package's code."""
    with pytest.raises(TypeError, match="keywords must be strings"):
        jsk.SemanticKITTIDataset(split=split, data_root=data_root,
                                 ignore_index=ignore_index, **kwargs)
    ds = jsk.SemanticKITTIDataset.__new__(jsk.SemanticKITTIDataset)
    ds.ignore_index = ignore_index
    lut = np.full(260, ignore_index, np.int32)
    for raw, train_id in jsk._RAW_TO_TRAIN.items():
        lut[raw] = ignore_index if train_id is None else train_id
    ds._lut = lut
    ds.learning_map = {k: (ignore_index if v is None else v)
                       for k, v in jsk._RAW_TO_TRAIN.items()}
    ds.learning_map_inv = {ignore_index: ignore_index, **jsk._TRAIN_TO_RAW}
    JaxDefaultDataset.__init__(ds, split=split, data_root=data_root, **kwargs)
    return ds


def build_both(cfg):
    """The port's dataset and the JAX package's of one config dict."""
    cfg = copy.deepcopy(dict(cfg))
    port = DATASETS.build(copy.deepcopy(cfg))
    if cfg["type"] == "SemanticKITTIDataset":
        cfg.pop("type")
        return port, jax_semantic_kitti(**cfg)
    return port, JAX_DATASETS.build(cfg)


# (config, data split, which dataset of a list) of every shipped transform
# chain of the three datasets
ITEM_CASES = [
    ("semantic_kitti/semseg-spunet-v1m1-0-base.py", "train", None),
    ("semantic_kitti/semseg-spunet-v1m1-0-base.py", "val", None),
    ("semantic_kitti/semseg-spunet-v1m1-0-base.py", "test", None),
    ("semantic_kitti/semseg-pt-v2m2-1-benchmark-submit.py", "test", None),
    ("semantic_kitti/semseg-ppt-v1m2-0-sk-nu-wa-spunet-submit.py", "test", None),
    ("semantic_kitti/semseg-ppt-v1m1-0-sk-nu-wa-spunet.py", "train", 0),
    ("semantic_kitti/semseg-ppt-v1m1-0-sk-nu-wa-spunet.py", "train", 1),
    ("semantic_kitti/semseg-ppt-v1m1-0-sk-nu-wa-spunet.py", "train", 2),
    ("semantic_kitti/semseg-ppt-v1m1-0-sk-nu-wa-spunet.py", "val", None),
    ("nuscenes/semseg-spunet-v1m1-0-base.py", "train", None),
    ("nuscenes/semseg-spunet-v1m1-0-base.py", "val", None),
    ("nuscenes/semseg-spunet-v1m1-0-base.py", "test", None),
    ("nuscenes/semseg-ppt-v1m1-0-nu-sk-wa-spunet.py", "val", None),
    ("nuscenes/semseg-ppt-v1m2-1-nu-sk-wa-spunet-submit.py", "test", None),
    ("waymo/semseg-spunet-v1m1-0-base.py", "train", None),
    ("waymo/semseg-spunet-v1m1-0-base.py", "val", None),
    ("waymo/semseg-spunet-v1m1-0-base.py", "test", None),
]
ROOT_OF = {"SemanticKITTIDataset": "semantic_kitti", "NuScenesDataset": "nuscenes",
           "WaymoDataset": "waymo"}


@pytest.mark.parametrize("config,split,index", ITEM_CASES)
def test_items_match_jax(roots, config, split, index):
    """Every item of the port's dataset equals the JAX package's, key for
    key and bit for bit (the random transforms from one seed on both
    sides), test fragments included; the same names; the shipped configs
    load alike in both packages."""
    path = os.path.join(ROOT, "configs", config)
    port_cfg, jax_cfg = Config.fromfile(path).data[split], JaxConfig.fromfile(path).data[split]
    if index is not None:
        port_cfg, jax_cfg = port_cfg.datasets[index], jax_cfg.datasets[index]
    assert dict(port_cfg) == dict(jax_cfg)
    cfg = dict(port_cfg, data_root=roots[ROOT_OF[port_cfg.type]])
    port, ref = build_both(cfg)
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        assert port.get_data_name(i) == ref.get_data_name(i)
        items = []
        for ds in (port, ref):
            np.random.seed(i)
            random.seed(i)
            items.append(ds[i])
        _assert_items_equal(*items, f"{config} {split} item {i}")
    if split == "test":
        assert len(items[1]["fragment_list"]) >= 1


def test_raw_labels_map_as_jax(roots):
    """The upper 16 bits of a SemanticKITTI label (the instance) drop, the
    raw ids map through the 19-class table with 0 and 99 ignored; a scan
    without a label file reads as class 0; nuScenes' lidarseg ids through
    its table, without labels all ignored; Waymo's second column less 1."""
    port, ref = build_both(dict(type="SemanticKITTIDataset", split="train",
                                data_root=roots["semantic_kitti"]))
    raw = np.fromfile(port.data_list[0].replace("velodyne", "labels").replace(
        ".bin", ".label"), dtype=np.uint32)
    assert (raw >> 16).max() > 0
    item = port.get_data(0)
    np.testing.assert_array_equal(item["segment"], ref.get_data(0)["segment"])
    np.testing.assert_array_equal(item["segment"], port._lut[raw & 0xFFFF])
    assert set(np.unique(item["segment"])) <= set(range(-1, 19))
    assert (item["segment"] == -1).any() and (item["segment"] >= 0).mean() > 0.9
    test = DATASETS.build(dict(type="SemanticKITTIDataset", split="test",
                               data_root=roots["semantic_kitti"]))
    assert (test.get_data(0)["segment"] == 0).all()
    assert port.learning_map_inv == {-1: -1, **jsk._TRAIN_TO_RAW}
    nu = DATASETS.build(dict(type="NuScenesDataset", split="test",
                             data_root=roots["nuscenes"]))
    assert (nu.get_data(0)["segment"] == -1).all()
    wa, wref = build_both(dict(type="WaymoDataset", split="training",
                               data_root=roots["waymo"]))
    pairs = np.fromfile(wa.data_list[0].replace("velodyne", "labels").replace(
        ".bin", ".label"), dtype=np.int32).reshape(-1, 2)
    np.testing.assert_array_equal(wa.get_data(0)["segment"], pairs[:, 1] - 1)
    np.testing.assert_array_equal(wa.get_data(0)["strength"], wref.get_data(0)["strength"])


# -- submission writers -------------------------------------------------------------


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


WRITER_CASES = [("ScanNetDataset", "scene0011_00", 20), ("ScanNet200Dataset",
                                                          "scene0011_00", 200),
                ("SemanticKITTIDataset", "11_000000", 19), ("NuScenesDataset", "test0000", 16),
                ("S3DISDataset", "office_1", 13)]


@pytest.mark.parametrize("ds_type,name,classes", WRITER_CASES)
def test_write_submit_matches_jax_byte_for_byte(tmp_path, ds_type, name, classes):
    """The port's ``TesterBase.write_submit`` against the JAX tester's on
    the same preds (the JAX tester made without a model or a compile):
    ScanNet / ScanNet200 class ids as text, SemanticKITTI raw ids as uint32,
    nuScenes pred + 1 as uint8, every file byte for byte; S3DIS writes
    none."""
    pred = np.random.RandomState(classes).randint(0, classes, 5000).astype(np.int64)
    port_ds = jax_ds = None
    if ds_type.startswith("ScanNet"):
        port_ds = types.SimpleNamespace(class2id=(ScanNetDataset if ds_type == "ScanNetDataset"
                                                  else ScanNet200Dataset).class2id)
        jax_ds = types.SimpleNamespace(class2id=(JaxScanNet if ds_type == "ScanNetDataset"
                                                 else JaxScanNet200).class2id)
        np.testing.assert_array_equal(port_ds.class2id, jax_ds.class2id)
    elif ds_type == "SemanticKITTIDataset":
        root = str(tmp_path / "sk")
        rng = np.random.RandomState(0)
        chip_smoke.write_semantic_kitti(root, 11, 0, scan(rng, "SemanticKITTI"), rng,
                                        labels=False)
        port_ds = DATASETS.build(dict(type=ds_type, split="test", data_root=root))
        jax_ds = jax_semantic_kitti(split="test", data_root=root)
    written = {}
    for side, cls, ds in (("port", TESTERS.get("SemSegTester"), port_ds),
                          ("jax", JaxSemSegTester, jax_ds)):
        tester = cls.__new__(cls)
        tester.cfg = Config(dict(data=dict(test=dict(type=ds_type))))
        tester.test_dataset = ds
        save = tmp_path / side
        save.mkdir()
        tester.write_submit(str(save), name, pred.copy())
        written[side] = tree_bytes(save)
    assert written["port"] == written["jax"]
    if ds_type == "S3DISDataset":
        assert written["port"] == {}
    else:
        assert len(written["port"]) == 1
    if ds_type == "SemanticKITTIDataset":
        raw = np.frombuffer(next(iter(written["port"].values())), np.uint32)
        np.testing.assert_array_equal(raw, np.array(
            [jsk._TRAIN_TO_RAW[c] for c in range(19)])[pred])


def spunet_model(in_channels, classes):
    return dict(type="DefaultSegmentor", backbone=dict(
        type="SpUNet-v1m1", in_channels=in_channels, num_classes=classes, base_channels=8,
        channels=(8, 8, 8, 8, 8, 8, 8, 8), layers=(1,) * 8),
        criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])


def scannet_config(root, save, tester):
    """A ScanNet val scene under the S3DIS tester test's Seg26 (+ PDF
    recognizer) on (coord, color)."""
    cfg = dict(
        save_path=save, unknown_label=[5, 9], model=copy.deepcopy(MODEL),
        recognizer=copy.deepcopy(RECOGNIZER), test=dict(type=tester),
        data=dict(num_classes=13, ignore_index=-1, names=[str(i) for i in range(13)],
                  test=dict(type="ScanNetDataset", split="val", data_root=root,
                            transform=[dict(type="CenterShift", apply_z=True),
                                       dict(type="NormalizeColor", mode="zeroOne")],
                            test_mode=True, test_cfg=dict(
                                voxelize=dict(type="GridSample", grid_size=0.05,
                                              hash_type="fnv", mode="test",
                                              keys=("coord", "color"),
                                              return_grid_coord=True),
                                crop=None,
                                post_transform=[
                                    dict(type="CenterShift", apply_z=False),
                                    dict(type="ToTensor"),
                                    dict(type="Collect", keys=("coord", "grid_coord", "index"),
                                         feat_keys=("coord", "color"))],
                                aug_transform=[[dict(type="RandomScale", scale=[1, 1])]]))))
    return Config(cfg)


@pytest.mark.parametrize("case", ["SemanticKITTI", "nuScenes", "ScanNet-SemSegTester",
                                  "ScanNet-OpenSegTester"])
def test_testers_write_their_submissions(roots, tmp_path, case):
    """The port's testers write each scene's submission as they test it:
    ``SemSegTester`` on the shipped SemanticKITTI and nuScenes PT-v2m2
    benchmark-submit configs (their test scans have no labels; a narrow
    SpUNet in the model's place), ``SemSegTester`` and ``OpenSegTester`` on
    a ScanNet scene; each file byte for byte what the JAX tester's
    ``write_submit`` makes of the pred the port saved."""
    save = str(tmp_path / "port")
    if case.startswith("ScanNet"):
        root = tmp_path / "scannet"
        (root / "val").mkdir(parents=True)
        scene = _scannet_scene(np.random.RandomState(1), 700)
        scene["semantic_gt20"] = np.clip(scene["semantic_gt20"], -1, 12)
        torch.save(scene, root / "val" / "scene0011_00.pth")
        tester_type = case.split("-")[1]
        cfg = scannet_config(str(root), save, tester_type)
        name = "scene0011_00"
    else:
        kitti = case == "SemanticKITTI"
        cfg = Config.fromfile(os.path.join(
            ROOT, "configs", "semantic_kitti" if kitti else "nuscenes",
            "semseg-pt-v2m2-1-benchmark-submit.py"))
        cfg.merge_from_dict({"save_path": save, "data.test.data_root":
                             roots["semantic_kitti" if kitti else "nuscenes"]})
        cfg.model = spunet_model(4, 19 if kitti else 16)
        tester_type = "SemSegTester"
        name = "11_000000" if kitti else "test0000"
    cfg.device = "cpu"
    os.makedirs(save)
    torch.manual_seed(0)
    tester = TESTERS.build(dict(type=tester_type, cfg=cfg))
    tester._weights_loaded = True          # the seeded initialisation, no checkpoint
    if tester_type == "OpenSegTester":
        tester.recognizer.model.eval()
    tester.test()
    pred = np.load(os.path.join(save, "result", f"{name}_pred.npy"))
    ref = JaxSemSegTester.__new__(JaxSemSegTester)
    ref.cfg = JaxConfig(dict(data=dict(test=dict(type=cfg.data.test.type))))
    ref.test_dataset = (jax_semantic_kitti(split="test", data_root=roots["semantic_kitti"])
                        if case == "SemanticKITTI"
                        else types.SimpleNamespace(class2id=JaxScanNet.class2id))
    jax_save = str(tmp_path / "jax")
    ref.write_submit(jax_save, name, pred)
    got = tree_bytes(os.path.join(save, "result", "submit"))
    want = tree_bytes(os.path.join(jax_save, "submit"))
    assert got == want and len(got) == 1


# -- wide voxel keys ----------------------------------------------------------------


def wide_grid(seed, b=2, n=3000, extent=(3008, 3008, 120)):
    """Padded voxel sets over ``extent`` cells: blobs of 5^3 around random
    centres (so that neighbours and shared parents exist), both far corners
    of x and y taken, the second sample with a masked tail."""
    rng = np.random.RandomState(seed)
    grid = np.zeros((b, n, 3), np.int64)
    counts = [n, n - 311][:b]
    for i, c in enumerate(counts):
        centres = rng.randint(0, extent, (c // 8, 3))
        cells = centres[rng.randint(0, len(centres), 4 * c)] + rng.randint(-2, 3, (4 * c, 3))
        cells = np.clip(cells, 0, np.array(extent) - 1)
        cells = np.unique(cells, axis=0)[rng.permutation(len(np.unique(cells, axis=0)))]
        cells = np.concatenate([[[0, 0, 0], [extent[0] - 1, extent[1] - 1, 0]], cells])
        grid[i, :c] = np.unique(cells, axis=0, return_index=True)[0][
            rng.permutation(len(np.unique(cells, axis=0)))][:c]
    mask = np.arange(n)[None] < np.array(counts)[:, None]
    return grid.astype(np.int32), mask


def oracle_parents(grid, mask, stride, capacity=None):
    """``unique_parents`` by ``np.unique(axis=0)`` (rows sorted
    lexicographically, x first) and its inverse."""
    b, n = mask.shape
    cap = n if capacity is None else capacity
    pg = np.zeros((b, cap, 3), np.int32)
    pm = np.zeros((b, cap), bool)
    c2p = np.full((b, n), -1, np.int32)
    for i in range(b):
        uniq, inv = np.unique(grid[i][mask[i]] // stride, axis=0, return_inverse=True)
        k = min(len(uniq), cap)
        pg[i, :k], pm[i, :k] = uniq[:k], True
        c2p[i, mask[i]] = np.where(inv.reshape(-1) < k, inv.reshape(-1), -1)
    return pg, pm, c2p


def oracle_table(grid, mask, offsets):
    """``neighbor_table`` by a dict of cells (the lowest row of a cell)."""
    b, n = mask.shape
    out = np.full((b, n, len(offsets)), -1, np.int32)
    for i in range(b):
        rows = {}
        for r in np.nonzero(mask[i])[0]:
            rows.setdefault(tuple(grid[i, r]), r)
        for r in np.nonzero(mask[i])[0]:
            for k, off in enumerate(offsets):
                out[i, r, k] = rows.get(tuple(grid[i, r] + off), -1)
    return out


@pytest.mark.parametrize("stride,capacity", [(1, None), (2, None), (4, None), (2, 1500)])
def test_unique_parents_past_the_jax_budget_match_numpy(stride, capacity):
    """On a grid of 3,008 x 3,008 x 120 cells the port's parents, masks and
    child -> parent slots equal ``np.unique(axis=0)``'s, a capacity cut
    included."""
    grid, mask = wide_grid(1)
    assert grid[..., 0].max() >= 2048 and grid[..., 1].max() >= 2048
    got = voxel.unique_parents(*tt(grid, mask), stride, capacity)
    for a, b in zip(got, oracle_parents(grid, mask, stride, capacity)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_neighbor_table_past_the_jax_budget_matches_a_dict():
    """On the same grid, every 3^3 offset of every row (a duplicate cell:
    its lower row is found) equals a dict of cells; no query wraps past an
    axis' top: a cell at y = 2^20 - 1 finds nothing at y + 1, though that
    key would pack as the next x's y = 0, which holds a voxel."""
    grid, mask = wide_grid(2, n=1500)
    grid[0, 1000:1100] = grid[0, :100]
    top = (1 << 20) - 1
    grid[1, 0], grid[1, 1] = (5, top, 7), (6, 0, 7)
    offsets = voxel.kernel_offsets(3)
    got = voxel.neighbor_table(*tt(grid, mask), offsets).numpy()
    np.testing.assert_array_equal(got, oracle_table(grid, mask, offsets))
    up = [k for k, o in enumerate(offsets) if tuple(o) == (0, 1, 0)][0]
    assert got[1, 0, up] == -1
    hits = (got >= 0).sum(-1)[mask]
    assert hits.min() >= 1 and (hits > 1).mean() > 0.5


def test_wide_keys_bound_and_order():
    """A grid past 2^20 cells an axis raises, naming the new budget; the
    wide keys sort as the JAX keys do inside the JAX budget (x, then y,
    then z), so every table there is the JAX one's; ``pack_grid32`` is the
    JAX ``pack_grid`` value for value."""
    grid, mask = wide_grid(3, b=1, n=500)
    bad = grid.copy()
    bad[0, 7, 1] = 1 << 20
    with pytest.raises(ValueError, match=r"\[0, 1048576\) x \[0, 1048576\) x \[0, "
                                         r"1048576\), the voxel keys' x 20, y 20, z 20"):
        voxel.check_grid_bound(*tt(bad, mask))
    rng = np.random.RandomState(4)
    small = rng.randint(0, JAX_LIMITS, (4000, 3)).astype(np.int32)
    wide = voxel.pack_grid(torch.from_numpy(small)).numpy()
    narrow = np.asarray(jvox.pack_grid(jnp.asarray(small))).astype(np.int64)
    np.testing.assert_array_equal(np.argsort(wide, kind="stable"),
                                  np.argsort(narrow, kind="stable"))
    np.testing.assert_array_equal(voxel.pack_grid32(torch.from_numpy(small)).numpy(), narrow)


@pytest.mark.parametrize("shift", [False, True])
def test_swin3d_window_sort_keeps_the_jax_keys(shift):
    """Swin3D's window ids keep the JAX package's 32-bit keys: on a grid
    that fills the JAX budget (windows of one cell, so that the window grid
    reaches 2,047 / 1,023) its order, inverse and sorted window ids equal
    the JAX ``_window_sort``; its grid check keeps that budget."""
    rng = np.random.RandomState(5 + shift)
    grid = rng.randint(0, JAX_LIMITS, (2, 1024, 3)).astype(np.int32)
    grid[0, 0], grid[1, 1] = (2047, 2047, 1023), (2046, 2047, 1022)
    mask = np.arange(1024)[None] < np.array([[1024], [900]])
    ref = jax.jit(jswin._window_sort, static_argnums=(2, 3))(grid, mask, 1, shift)
    got = port_swin.window_sort(*tt(grid, mask), 1, shift)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    bad = grid.copy()
    bad[0, 3, 0] = 2048
    with pytest.raises(ValueError, match="x 11, y 11, z 10 bits"):
        voxel.check_grid_bound(*tt(bad, mask), voxel.KEY32_BITS)


# -- forwards against the JAX package -----------------------------------------------


def item_batch(roots, config, split="val"):
    """The item of ``config``'s ``split`` on the test scans (the dataset's
    own transforms) as a padded batch of one."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", config)).data[split]
    ds = DATASETS.build(dict(cfg, data_root=roots["semantic_kitti"]))
    np.random.seed(0)
    return padded_collate_fn([ds[0]])


def exact_jax_table(grid, mask, offsets):
    """The JAX package's exact neighbour table of one sample: its sorted
    ``build_table`` and ``lookup`` (the hash ``neighbor_table`` is a TPU
    shortcut, ROADMAP §3 item 13), queries masked outside the JAX budget."""
    keys, rows = jvox.build_table(grid, mask)
    q = grid[:, None, :] + jnp.asarray(offsets)[None]
    ok = mask[:, None] & jnp.all(q >= 0, -1) & jnp.all(q < jnp.asarray(JAX_LIMITS), -1)
    qk = jnp.where(ok, jvox.pack_grid(jnp.maximum(q, 0)), jnp.uint32(0xFFFFFFFF))
    return jnp.where(ok, jvox.lookup(keys, rows, qk.reshape(-1)).reshape(ok.shape), -1)


def exact_jax_maps(grid, mask, capacities):
    """The JAX SpUNet's level maps as its module chains them, on the exact
    table: the stem's 5^3 table, each level's 3^3 one and the parents."""
    table = jax.vmap(exact_jax_table, in_axes=(0, 0, None))
    out = dict(nbr5=table(grid, mask, jvox.kernel_offsets(5)), nbr3=[], grid=[grid],
               mask=[mask], c2p=[])
    for cap in capacities:
        out["nbr3"].append(table(grid, mask, jvox.kernel_offsets(3)))
        grid, mask, c2p = jax.vmap(functools.partial(
            jvox.unique_parents, stride=2, capacity=cap))(grid, mask)
        for key, value in (("grid", grid), ("mask", mask), ("c2p", c2p)):
            out[key].append(value)
    out["nbr3"].append(table(grid, mask, jvox.kernel_offsets(3)))
    return out


def test_spunet_on_a_semantic_kitti_item_matches_jax(roots, monkeypatch):
    """A reduced-width SpUNet-v1m1 (the shipped SemanticKITTI config's
    stages, 4 input channels, 19 classes) on the val scan's item, which lies
    inside the JAX keys' budget: every level's maps equal the JAX
    functions' and the eval logits agree within 1e-4 x max |logit|.  The
    JAX hash table gets some 40-90 of a scan's 256,000 stem slots wrong on
    every seed tried (a sparse scan over 1,361 x 1,361 cells), so the JAX
    module runs on the package's exact sorted table here."""
    batch = item_batch(roots, "semantic_kitti/semseg-spunet-v1m1-0-base.py")
    n = int(batch["count"][0])
    mask = np.arange(batch["coord"].shape[1])[None] < n
    grid = batch["grid_coord"].astype(np.int32)
    assert (grid[mask].max(0) < JAX_LIMITS).all() and grid[mask].max() > 1024
    cfg = dict(type="SpUNet-v1m1", in_channels=4, num_classes=19, base_channels=16,
               channels=(16, 16, 32, 32, 32, 16, 16, 16), layers=(1,) * 8)
    jmodel, model, tree = models(cfg, 21)
    got = model.eval().index_maps(*tt(grid, mask))
    ref = jax.jit(exact_jax_maps, static_argnums=2)(
        grid, mask, tuple(m.shape[1] for m in got["mask"][1:]))
    np.testing.assert_array_equal(got["nbr5"].numpy(), np.asarray(ref["nbr5"]))
    for key in ("nbr3", "grid", "mask", "c2p"):
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    monkeypatch.setattr(jsp, "neighbor_table", exact_jax_table)
    inputs = dict(grid_coord=grid, feat=batch["feat"].astype(np.float32), mask=mask)
    with torch.inference_mode():
        logits = model({k: torch.from_numpy(v) for k, v in inputs.items()}).numpy()
    want, dropped = jax_forward(jmodel, tree, inputs)
    assert dropped == 0 and logits.shape == (1, mask.shape[1], 19)
    assert np.abs(want).max() > 0.1
    assert np.abs(logits - want).max() <= TOL * np.abs(want).max()


@pytest.fixture(scope="module")
def exact_jax_ptv2():
    old = (jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA)
    jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA = "exact", "off"
    yield
    jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA = old


def test_ptv2m2_with_the_outdoor_shape_matches_jax(roots, exact_jax_ptv2):
    """A small PT-v2m2 of the shipped SemanticKITTI config's shape (four
    stages, the patch embedding's 8 neighbours, ``pe_multiplier=False``,
    ``pe_bias=True``, its grid sizes, 4 input channels) in eval on the
    SemanticKITTI val scan's points nearest the sensor, jittered, centred
    and scaled by 1/4: every kNN of the port's run tie-free (the JAX kNN's
    matmul-identity distances hold f32 noise that grows with |coord|^2, so
    the PT-v2 tests' gap of 5e-7 at |coord|^2 <= 4.64 grows with it),
    logits within 1e-4 x max |logit| of the JAX package's (unfused, exact
    kNN)."""
    batch = item_batch(roots, "semantic_kitti/semseg-pt-v2m2-0-base.py")
    coord = batch["coord"][0][:int(batch["count"][0])]
    strength = batch["feat"][0][:len(coord), 3:]
    near = np.argsort(np.linalg.norm(coord[:, :2] - np.median(coord[:, :2], 0), axis=1))[:1536]
    # a ring's points lie at near-equal distances from each other: jittered
    # by 2 cm (seeded) they hold no kNN near-tie
    coord = coord[near] + np.random.RandomState(JITTER_SEED).normal(0, 0.02, (len(near), 3))
    coord = (coord - coord.mean(0)) / 4
    feat = np.concatenate([coord, strength[near]], 1).astype(np.float32)
    n = 2048
    mask = np.arange(n)[None] < len(coord)
    coord = np.pad(coord, ((0, n - len(coord)), (0, 0)))[None].astype(np.float32)
    feat = np.pad(feat, ((0, n - len(feat)), (0, 0)))[None]
    shipped = Config.fromfile(os.path.join(
        ROOT, "configs", "semantic_kitti", "semseg-pt-v2m2-0-base.py")).model.backbone
    cfg = dict(type="DefaultSegmentor", criteria=[
        dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
        backbone=dict(shipped, patch_embed_channels=16, patch_embed_groups=2,
                      enc_depths=(1, 1, 1, 1), enc_channels=(16, 32, 32, 32),
                      enc_groups=(2, 4, 4, 4), enc_neighbours=(8, 8, 8, 8),
                      dec_depths=(1, 1, 1, 1), dec_channels=(16, 16, 32, 32),
                      dec_groups=(2, 2, 4, 4), dec_neighbours=(8, 8, 8, 8),
                      drop_path_rate=0.0))
    assert cfg["backbone"]["patch_embed_neighbours"] == 8 and len(
        cfg["backbone"]["grid_sizes"]) == 4
    assert not cfg["backbone"]["pe_multiplier"] and cfg["backbone"]["pe_bias"]
    tree = port_tree(cfg, 23)
    jbatch = dict(coord=jnp.asarray(coord), feat=jnp.asarray(feat), mask=jnp.asarray(mask))
    ref, diag = japply(jax_build_model(cfg), tree, jbatch, train=False,
                       mutable=["diagnostics"])
    assert sum(int(x) for x in jax.tree_util.tree_leaves(diag)) == 0
    ref = np.asarray(ref["seg_logits"])
    model = build_model(cfg).eval()
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    port_knn, gaps = port_ptv2.knn, []

    def recording_knn(query, ref_pts, k, ref_mask=None):
        gaps.append(knn_tie_gap(query, ref_pts, k, ref_mask))
        return port_knn(query, ref_pts, k, ref_mask)

    port_ptv2.knn = recording_knn
    try:
        with torch.inference_mode():
            got = model(dict(zip(("coord", "feat", "mask"),
                                 tt(coord, feat, mask))))["seg_logits"].numpy()
    finally:
        port_ptv2.knn = port_knn
    floor = 5e-7 * max(1.0, float((coord ** 2).sum(-1).max()) / 4.64)
    assert len(gaps) == 5 and min(gaps) >= floor, (gaps, floor)
    assert got.shape == ref.shape == (1, n, 19)
    assert np.abs(ref).max() > 0.1
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    assert (got[0, len(near):] == 0).all()
