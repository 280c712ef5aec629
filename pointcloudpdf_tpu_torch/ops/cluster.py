# Copied from pointcloudpdf_tpu/ops/cluster.py; keep in step.
"""Host-side instance clustering for PointGroup.

Replaces libs/pointgroup_ops (ballquery_batch_p + bfs_cluster CUDA,
reference functions/functions.py:6-177): a radius graph over
center-shifted points with a same-semantic constraint, connected
components via union-find.  Runs only at eval/test time on host numpy
(scipy cKDTree), outside the jit step.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, a: int) -> int:
        root = a
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[a] != root:
            self.parent[a], a = root, self.parent[a]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def bfs_cluster(
    center: np.ndarray,       # (n, 3) predicted instance centers
    segment: np.ndarray,      # (n,) predicted classes
    radius: float,
    max_neighbors: int = 300,
    min_points: int = 50,
) -> List[np.ndarray]:
    """Connected components of the same-class radius graph.

    Returns a list of index arrays (one per cluster with >= min_points).
    """
    from scipy.spatial import cKDTree

    n = len(center)
    if n == 0:
        return []
    uf = _UnionFind(n)
    # per-class KD-trees keep the same-semantic constraint implicit
    for cls in np.unique(segment):
        sel = np.where(segment == cls)[0]
        if len(sel) < 2:
            continue
        tree = cKDTree(center[sel])
        pairs = tree.query_pairs(radius, output_type="ndarray")
        if max_neighbors and len(pairs) > len(sel) * max_neighbors:
            pairs = pairs[: len(sel) * max_neighbors]
        for a, b in pairs:
            uf.union(sel[a], sel[b])
    roots = np.array([uf.find(i) for i in range(n)])
    clusters = []
    for root in np.unique(roots):
        members = np.where(roots == root)[0]
        if len(members) >= min_points:
            clusters.append(members)
    return clusters
