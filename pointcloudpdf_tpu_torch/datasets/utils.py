# Copied from pointcloudpdf_tpu/datasets/utils.py; keep in step (but for
# ``bucket_capacity`` past the largest bucket, which does not truncate here,
# and the per-instance ``bbox``, a list of arrays here: the JAX collation
# stacks it, which fails across samples of other instance counts, squeezes a
# sample of one instance to (1, 8) and pads one of as many instances as points).
"""Batch collation: variable-length samples -> static padded buffers.

The reference concatenates samples and tracks cumulative ``offset``
(pointcept/datasets/utils.py:15-56). XLA needs static shapes, so this
collation pads every per-point key to a bucketed capacity ``(B, n_pad, ...)``
and emits a ``count (B,)`` vector; validity masks are derived on device via
``mask_from_count``. Mix3D batch mixing (point_collate_fn's offset-dropping)
becomes pairwise sample merging inside the padded buffer.
"""

from __future__ import annotations

import random
from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence

import numpy as np

# label-like per-point keys padded with ignore_index instead of zero
LABEL_KEYS = frozenset(
    {
        "segment",
        "origin_segment",
        "segment_known",
        "segment_incr",
        "segment_incr_remap",
        "instance",
    }
)

# keys that are per-sample rather than per-point
PER_SAMPLE_KEYS = frozenset({"category", "offset", "name", "split", "condition",
                             "min_coord", "weight_scalar"})
# per-instance records (InstanceParser's (instances, 8) boxes): a list of the
# samples' arrays
PER_INSTANCE_KEYS = frozenset({"bbox"})

DEFAULT_BUCKETS = tuple(
    [1024 * 2**i for i in range(8)] + [81920, 98304, 131072, 196608, 262144]
)


# past the largest bucket, the padded length is a multiple of this
BUCKET_STEP = 65536


def bucket_capacity(max_count: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """The smallest bucket that holds ``max_count`` points; past the largest,
    ``max_count`` rounded up to a multiple of ``BUCKET_STEP``.  (The JAX
    package returns the largest bucket there, and its collation truncates the
    sample: a test fragment of a room at 2 cm, or a Mix3D pair of 204,800-point
    crops, loses points.)"""
    for b in sorted(buckets):
        if max_count <= b:
            return int(b)
    return -(-int(max_count) // BUCKET_STEP) * BUCKET_STEP


def padded_collate_fn(
    batch: List[Mapping],
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    ignore_index: int = -1,
    mix_prob: float = 0.0,
    n_pad: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Collate a list of per-sample dicts into padded (B, n_pad, ...) arrays.

    Per-point keys (first dim == the sample's point count) are padded;
    label keys get ``ignore_index`` padding so losses/metrics skip them.
    Returns the padded dict plus ``count`` (B,) int32 and ``offset`` (B,)
    for reference-API parity.
    """
    assert len(batch) > 0 and isinstance(batch[0], Mapping)
    counts = np.array([int(np.asarray(s["coord"]).shape[0]) for s in batch],
                      dtype=np.int32)

    if mix_prob > 0 and len(batch) > 1 and random.random() < mix_prob:
        # Mix3D (arXiv 2110.02210): merge sample pairs into single scenes.
        # In padded form pair (2i, 2i+1) concatenates into slot 2i and slot
        # 2i+1 becomes empty; shapes stay static.
        merged = []
        for i in range(0, len(batch) - 1, 2):
            a, b = dict(batch[i]), batch[i + 1]
            for k, v in a.items():
                if _is_per_point(k, v, counts[i]):
                    a[k] = np.concatenate([v, b[k]], axis=0)
            merged.append(a)
            empty = {
                k: (v[:0] if _is_per_point(k, v, counts[i + 1]) else v)
                for k, v in b.items()
            }
            merged.append(empty)
        if len(batch) % 2 == 1:
            merged.append(dict(batch[-1]))
        batch = merged
        counts = np.array(
            [int(np.asarray(s["coord"]).shape[0]) for s in batch], dtype=np.int32
        )

    if n_pad is None:
        n_pad = bucket_capacity(int(counts.max()), buckets)
    counts = np.minimum(counts, n_pad)

    out: Dict[str, np.ndarray] = {}
    for key in batch[0]:
        values = [s[key] for s in batch]
        v0 = np.asarray(values[0]) if not isinstance(values[0], str) else values[0]
        if isinstance(v0, str):
            out[key] = list(values)
        elif key in PER_INSTANCE_KEYS:
            out[key] = [np.asarray(v) for v in values]
        elif key == "offset":
            pass  # re-derived from counts below
        elif _is_per_point(key, v0, counts[0]) and key not in PER_SAMPLE_KEYS:
            pad = ignore_index if key in LABEL_KEYS else 0
            trailing = v0.shape[1:]
            buf = np.full((len(batch), n_pad) + trailing, pad, dtype=v0.dtype)
            for i, v in enumerate(values):
                v = np.asarray(v)
                n = min(v.shape[0], n_pad)
                buf[i, :n] = v[:n]
            out[key] = buf
        else:
            stacked = np.stack([np.asarray(v) for v in values])
            if stacked.ndim > 1 and stacked.shape[1] == 1:
                stacked = stacked[:, 0]
            out[key] = stacked

    out["count"] = counts
    out["offset"] = np.cumsum(counts).astype(np.int64)
    return out


def _is_per_point(key: str, value, count: int) -> bool:
    if isinstance(value, str) or key in PER_SAMPLE_KEYS or key in PER_INSTANCE_KEYS:
        return False
    value = np.asarray(value)
    return value.ndim >= 1 and value.shape[0] == count


def gaussian_kernel(dist2: np.ndarray, a: float = 1, c: float = 5):
    return a * np.exp(-dist2 / (2 * c**2))
