"""The host clustering of PointGroup's proposals on one val room, timed.

    python3 tools/insseg_cluster_time.py [--out FILE]

Makes the synthetic S3DIS val room of ``chip_smoke.py`` phases 14-17
(``chip_smoke.synthetic_room`` with ``PTV3_ROOM``: normals, 2,800 points a
square metre, each plane and box an instance), runs it through the shipped
S3DIS PointGroup config's val transform (4 cm grid), and times
``PointGroup.propose`` (``ops.cluster.bfs_cluster``: per-class KD-tree radius
pairs, a Python union-find loop over them) on the host for two sets of
outputs: logits of the true classes with no shift (an untrained model's
shifts are near 0), and the same logits with every point shifted onto its
instance's centroid (a trained model's: each instance collapses to a point,
so the pairs a class grow as the square of its points, up to the truncation
at ``len(sel) * cluster_closed_points``).  Prints the points, proposals and
milliseconds of each, and the host's CPU; ``--out`` writes them as JSON.
Needs no GPU: the clustering runs on the host in both packages.
"""

import argparse
import json
import os
import platform
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="write the numbers here as JSON")
    args = parser.parse_args()

    from pointcloudpdf_tpu_torch.datasets.transform import Compose
    from pointcloudpdf_tpu_torch.models import build_model
    from pointcloudpdf_tpu_torch.utils.config import Config

    cfg = Config.fromfile(chip_smoke.PG_CONFIG)
    grid = chip_smoke.config_grid(chip_smoke.PG_CONFIG)
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "office_1.npz")
        raw = chip_smoke.synthetic_room(np.random.RandomState(chip_smoke.SEED), path,
                                        **chip_smoke.PTV3_ROOM)
        room = dict(np.load(path))
    data = Compose(cfg.data.val.transform)(dict(
        coord=room["coord"], color=room["color"], normal=room["normal"],
        segment=room["semantic_gt"], instance=room["instance_gt"]))
    coord = np.asarray(data["coord"], np.float32)
    segment = np.asarray(data["segment"])
    centroid = np.asarray(data["instance_centroid"], np.float32)
    # propose reads the model's clustering settings only: a narrow backbone
    model = build_model(dict(cfg.model, backbone=dict(cfg.model.backbone, channels=(8, 8),
                                                      layers=(1, 1))))
    logits = 5.0 * np.eye(cfg.data.num_classes, dtype=np.float32)[segment]
    instanced = (np.asarray(data["instance"]) >= 0)[:, None]
    result = dict(host=platform.processor() or platform.machine(), cpus=os.cpu_count(),
                  raw_points=raw, points=len(coord), grid=grid, voxel_size=model.voxel_size,
                  cluster_thresh=model.cluster_thresh, cases={})
    for name, bias in (("no shift", np.zeros_like(coord)),
                       ("shifted to the centroids", np.where(instanced, centroid - coord, 0))):
        t0 = time.perf_counter()
        _, classes, _ = model.propose(coord, logits, bias.astype(np.float32),
                                      np.ones(len(coord), bool))
        ms = (time.perf_counter() - t0) * 1e3
        result["cases"][name] = dict(proposals=len(classes), ms=ms)
        print(f"{name}: {len(coord)} points at {grid} m, {len(classes)} proposals, "
              f"{ms:.1f} ms on the host")
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
