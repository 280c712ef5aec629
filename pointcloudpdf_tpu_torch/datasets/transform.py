# Copied from pointcloudpdf_tpu/datasets/transform.py; keep in step.
"""Data-space transforms over numpy dict samples.

Behavioral parity with the reference transform zoo
(pointcept/datasets/transform.py, 30 registered names) with a fresh
implementation: everything is numpy (no torch), point-indexed keys are
subset through one shared helper, and ``ToTensor`` keeps arrays as numpy —
device placement happens once per batch at the jit boundary, which is the
TPU-idiomatic host/device split.
"""

from __future__ import annotations

import copy
import numbers
import random
from collections.abc import Mapping, Sequence

import numpy as np

from ..utils.registry import Registry

TRANSFORMS = Registry("transforms")

# keys that are per-point and must be subset together when points are
# dropped/reordered (superset of the reference's hardcoded if-chains)
POINT_KEYS = (
    "coord",
    "origin_coord",
    "grid_coord",
    "color",
    "normal",
    "strength",
    "segment",
    "origin_segment",
    "instance",
    "displacement",
    "segment_known",
    "segment_incr",
    "segment_incr_remap",
)


def index_points(data_dict: dict, idx, keys=POINT_KEYS) -> dict:
    """Apply an index/permutation to every per-point key present."""
    for key in keys:
        if key in data_dict:
            data_dict[key] = data_dict[key][idx]
    return data_dict


@TRANSFORMS.register_module()
class Collect:
    """Select output keys, record offsets, concat feature groups.

    Matches reference Collect (transform.py:26-50): ``feat_keys`` et al are
    concatenated along the channel dim into ``feat``; ``offset`` holds the
    point count (padded batching later turns counts into masks).
    """

    def __init__(self, keys, offset_keys_dict=None, **kwargs):
        if offset_keys_dict is None:
            offset_keys_dict = dict(offset="coord")
        self.keys = (keys,) if isinstance(keys, str) else tuple(keys)
        self.offset_keys = offset_keys_dict
        self.concat_keys = kwargs

    def __call__(self, data_dict):
        out = {}
        for key in self.keys:
            out[key] = data_dict[key]
        for name, src in self.offset_keys.items():
            out[name] = np.array([data_dict[src].shape[0]], dtype=np.int64)
        for name, keys in self.concat_keys.items():
            name = name.replace("_keys", "")
            assert isinstance(keys, Sequence)
            out[name] = np.concatenate(
                [np.asarray(data_dict[k], dtype=np.float32) for k in keys], axis=1
            )
        return out


@TRANSFORMS.register_module()
class Copy:
    def __init__(self, keys_dict=None):
        if keys_dict is None:
            keys_dict = dict(coord="origin_coord", segment="origin_segment")
        self.keys_dict = keys_dict

    def __call__(self, data_dict):
        for src, dst in self.keys_dict.items():
            value = data_dict[src]
            data_dict[dst] = (
                value.copy() if isinstance(value, np.ndarray) else copy.deepcopy(value)
            )
        return data_dict


@TRANSFORMS.register_module()
class ToTensor:
    """Normalize leaf types to numpy arrays (int64 for ints, f32 floats).

    The reference converts to torch tensors here (transform.py:72-96); in
    the TPU build host data stays numpy until batch collation feeds jit.
    """

    def __call__(self, data):
        if isinstance(data, str):
            return data
        if isinstance(data, int):
            return np.array([data], dtype=np.int64)
        if isinstance(data, float):
            return np.array([data], dtype=np.float32)
        if isinstance(data, np.ndarray):
            if np.issubdtype(data.dtype, bool):
                return data
            if np.issubdtype(data.dtype, np.integer):
                return data.astype(np.int64)
            if np.issubdtype(data.dtype, np.floating):
                return data.astype(np.float32)
            return data
        if isinstance(data, Mapping):
            return {k: self(v) for k, v in data.items()}
        if isinstance(data, Sequence):
            return [self(v) for v in data]
        raise TypeError(f"type {type(data)} cannot be converted")


@TRANSFORMS.register_module()
class Add:
    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or {}

    def __call__(self, data_dict):
        data_dict.update(copy.deepcopy(self.keys_dict))
        return data_dict


# --------------------------------------------------------------------------
# coordinate transforms
# --------------------------------------------------------------------------

@TRANSFORMS.register_module()
class NormalizeCoord:
    def __call__(self, data_dict):
        if "coord" in data_dict:
            coord = data_dict["coord"]
            coord = coord - coord.mean(axis=0)
            radius = np.max(np.linalg.norm(coord, axis=1))
            data_dict["coord"] = coord / max(radius, 1e-12)
        return data_dict


@TRANSFORMS.register_module()
class PositiveShift:
    def __call__(self, data_dict):
        if "coord" in data_dict:
            data_dict["coord"] = data_dict["coord"] - data_dict["coord"].min(axis=0)
        return data_dict


@TRANSFORMS.register_module()
class CenterShift:
    def __init__(self, apply_z=True):
        self.apply_z = apply_z

    def __call__(self, data_dict):
        if "coord" in data_dict:
            cmin, cmax = data_dict["coord"].min(0), data_dict["coord"].max(0)
            shift = np.array(
                [
                    (cmin[0] + cmax[0]) / 2,
                    (cmin[1] + cmax[1]) / 2,
                    cmin[2] if self.apply_z else 0.0,
                ]
            )
            data_dict["coord"] = data_dict["coord"] - shift
        return data_dict


@TRANSFORMS.register_module()
class RandomShift:
    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0))):
        self.shift = shift

    def __call__(self, data_dict):
        if "coord" in data_dict:
            delta = np.array([np.random.uniform(lo, hi) for lo, hi in self.shift])
            data_dict["coord"] = data_dict["coord"] + delta
        return data_dict


@TRANSFORMS.register_module()
class PointClip:
    def __init__(self, point_cloud_range=(-80, -80, -3, 80, 80, 1)):
        self.point_cloud_range = point_cloud_range

    def __call__(self, data_dict):
        if "coord" in data_dict:
            data_dict["coord"] = np.clip(
                data_dict["coord"],
                a_min=self.point_cloud_range[:3],
                a_max=self.point_cloud_range[3:],
            )
        return data_dict


@TRANSFORMS.register_module()
class RandomDropout:
    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data_dict):
        if random.random() < self.dropout_application_ratio:
            n = len(data_dict["coord"])
            idx = np.random.choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            if "sampled_index" in data_dict:
                # keep labeled points for data-efficient ScanNet
                idx = np.unique(np.append(idx, data_dict["sampled_index"]))
                mask = np.zeros(n, dtype=bool)
                mask[data_dict["sampled_index"]] = True
                data_dict["sampled_index"] = np.where(mask[idx])[0]
            index_points(data_dict, idx)
        return data_dict


def _rotation_matrix(angle: float, axis: str) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise NotImplementedError(axis)


class _RotateBase:
    center = None
    axis = "z"

    def _apply_rotation(self, data_dict, angle):
        rot = _rotation_matrix(angle, self.axis)
        if "coord" in data_dict:
            if self.center is None:
                cmin, cmax = data_dict["coord"].min(0), data_dict["coord"].max(0)
                center = (cmin + cmax) / 2
            else:
                center = np.asarray(self.center)
            data_dict["coord"] = (data_dict["coord"] - center) @ rot.T + center
        if "normal" in data_dict:
            data_dict["normal"] = data_dict["normal"] @ rot.T
        return data_dict


@TRANSFORMS.register_module()
class RandomRotate(_RotateBase):
    def __init__(self, angle=None, center=None, axis="z", always_apply=False, p=0.5):
        self.angle = [-1, 1] if angle is None else angle
        self.axis = axis
        self.p = 1 if always_apply else p
        self.center = center

    def __call__(self, data_dict):
        if random.random() > self.p:
            return data_dict
        angle = np.random.uniform(self.angle[0], self.angle[1]) * np.pi
        return self._apply_rotation(data_dict, angle)


@TRANSFORMS.register_module()
class RandomRotateTargetAngle(_RotateBase):
    def __init__(self, angle=(1 / 2, 1, 3 / 2), center=None, axis="z",
                 always_apply=False, p=0.75):
        self.angle = angle
        self.axis = axis
        self.p = 1 if always_apply else p
        self.center = center

    def __call__(self, data_dict):
        if random.random() > self.p:
            return data_dict
        angle = np.random.choice(self.angle) * np.pi
        return self._apply_rotation(data_dict, angle)


@TRANSFORMS.register_module()
class RandomScale:
    def __init__(self, scale=None, anisotropic=False):
        self.scale = scale if scale is not None else [0.95, 1.05]
        self.anisotropic = anisotropic

    def __call__(self, data_dict):
        if "coord" in data_dict:
            scale = np.random.uniform(
                self.scale[0], self.scale[1], 3 if self.anisotropic else 1
            )
            data_dict["coord"] = data_dict["coord"] * scale
        return data_dict


@TRANSFORMS.register_module()
class RandomFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, data_dict):
        for dim in (0, 1):
            if np.random.rand() < self.p:
                if "coord" in data_dict:
                    data_dict["coord"][:, dim] = -data_dict["coord"][:, dim]
                if "normal" in data_dict:
                    data_dict["normal"][:, dim] = -data_dict["normal"][:, dim]
        return data_dict


@TRANSFORMS.register_module()
class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05):
        assert clip > 0
        self.sigma = sigma
        self.clip = clip

    def __call__(self, data_dict):
        if "coord" in data_dict:
            jitter = np.clip(
                self.sigma * np.random.randn(data_dict["coord"].shape[0], 3),
                -self.clip,
                self.clip,
            )
            data_dict["coord"] = data_dict["coord"] + jitter
        return data_dict


@TRANSFORMS.register_module()
class ClipGaussianJitter:
    def __init__(self, scalar=0.02, store_jitter=False):
        self.scalar = scalar
        self.quantile = 1.96
        self.store_jitter = store_jitter

    def __call__(self, data_dict):
        if "coord" in data_dict:
            noise = np.random.multivariate_normal(
                np.zeros(3), np.identity(3), data_dict["coord"].shape[0]
            )
            jitter = self.scalar * np.clip(noise / self.quantile, -1, 1)
            data_dict["coord"] = data_dict["coord"] + jitter
            if self.store_jitter:
                data_dict["jitter"] = jitter
        return data_dict


@TRANSFORMS.register_module()
class ElasticDistortion:
    def __init__(self, distortion_params=None):
        self.distortion_params = (
            [[0.2, 0.4], [0.8, 1.6]] if distortion_params is None else distortion_params
        )

    @staticmethod
    def distort(coords, granularity, magnitude):
        """Displace coords with a smoothed random vector field sampled on a
        granularity-spaced lattice, trilinearly interpolated at the point
        locations (reference transform.py:734-776 semantics)."""
        from scipy.ndimage import map_coordinates, uniform_filter1d

        lo = coords.min(0)
        extent = (coords - lo).max(0)
        dims = (extent // granularity).astype(int) + 3
        field = np.random.randn(*dims, 3).astype(np.float32)
        # two rounds of a 3-tap box blur along each spatial axis
        for _ in range(2):
            for ax in range(3):
                field = uniform_filter1d(
                    field, size=3, axis=ax, mode="constant"
                )
        # the lattice origin sits one cell below the cloud's min corner, so
        # every point lands strictly inside the field; trilinear sample per
        # displacement channel
        cell = (coords - (lo - granularity)) / granularity
        disp = np.stack(
            [
                map_coordinates(field[..., c], cell.T, order=1, cval=0.0)
                for c in range(3)
            ],
            axis=-1,
        )
        return coords + disp * magnitude

    def __call__(self, data_dict):
        if "coord" in data_dict and self.distortion_params is not None:
            if random.random() < 0.95:
                for granularity, magnitude in self.distortion_params:
                    data_dict["coord"] = self.distort(
                        data_dict["coord"], granularity, magnitude
                    )
        return data_dict


# --------------------------------------------------------------------------
# color transforms
# --------------------------------------------------------------------------

@TRANSFORMS.register_module()
class NormalizeColor:
    def __init__(self, mode="zeroCenter"):
        self.mode = mode

    def __call__(self, data_dict):
        if "color" in data_dict:
            if self.mode == "zeroCenter":
                data_dict["color"] = data_dict["color"] / 127.5 - 1
            elif self.mode == "zeroOne":
                data_dict["color"] = data_dict["color"] / 255
        return data_dict


@TRANSFORMS.register_module()
class ChromaticAutoContrast:
    def __init__(self, p=0.2, blend_factor=None):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            color = data_dict["color"]
            lo = color.min(0, keepdims=True)
            hi = color.max(0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-12)
            stretched = (color[:, :3] - lo) * scale
            blend = np.random.rand() if self.blend_factor is None else self.blend_factor
            data_dict["color"][:, :3] = (1 - blend) * color[:, :3] + blend * stretched
        return data_dict


@TRANSFORMS.register_module()
class ChromaticTranslation:
    def __init__(self, p=0.95, ratio=0.05):
        self.p = p
        self.ratio = ratio

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            shift = (np.random.rand(1, 3) - 0.5) * 255 * 2 * self.ratio
            data_dict["color"][:, :3] = np.clip(
                data_dict["color"][:, :3] + shift, 0, 255
            )
        return data_dict


@TRANSFORMS.register_module()
class ChromaticJitter:
    def __init__(self, p=0.95, std=0.005):
        self.p = p
        self.std = std

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            noise = np.random.randn(data_dict["color"].shape[0], 3) * self.std * 255
            data_dict["color"][:, :3] = np.clip(
                data_dict["color"][:, :3] + noise, 0, 255
            )
        return data_dict


def rgb_to_grayscale(color, num_output_channels=1):
    if color.shape[-1] < 3:
        raise TypeError("color needs >= 3 channels")
    if num_output_channels not in (1, 3):
        raise ValueError("num_output_channels should be 1 or 3")
    gray = (
        0.2989 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2]
    ).astype(color.dtype)[..., None]
    if num_output_channels == 3:
        gray = np.broadcast_to(gray, color.shape)
    return gray


@TRANSFORMS.register_module()
class RandomColorGrayScale:
    def __init__(self, p):
        self.p = p

    def __call__(self, data_dict):
        if np.random.rand() < self.p:
            data_dict["color"] = rgb_to_grayscale(data_dict["color"], 3)
        return data_dict


def _rgb_to_hsv(rgb):
    """Vectorized colorsys-style rgb->hsv; rgb in [0,255], h/s in [0,1], v=max."""
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb[..., :3].max(-1)
    minc = rgb[..., :3].min(-1)
    span = maxc - minc
    hsv = np.zeros_like(rgb)
    hsv[..., 2] = maxc
    nz = maxc != minc
    hsv[nz, 1] = span[nz] / maxc[nz]
    rc = np.zeros_like(r)
    gc = np.zeros_like(g)
    bc = np.zeros_like(b)
    rc[nz] = (maxc - r)[nz] / span[nz]
    gc[nz] = (maxc - g)[nz] / span[nz]
    bc[nz] = (maxc - b)[nz] / span[nz]
    h = np.select([r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc], default=4.0 + gc - rc)
    hsv[..., 0] = (h / 6.0) % 1.0
    return hsv


def _hsv_to_rgb(hsv):
    """Vectorized colorsys-style hsv->rgb; h/s in [0,1], v in [0,255]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(np.uint8)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i % 6
    conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    rgb = np.empty_like(hsv)
    rgb[..., 0] = np.select(conds, [v, q, p, p, t, v], default=v)
    rgb[..., 1] = np.select(conds, [v, v, v, q, p, p], default=t)
    rgb[..., 2] = np.select(conds, [v, p, t, v, v, q], default=p)
    return rgb.astype("uint8")


@TRANSFORMS.register_module()
class HueSaturationTranslation:
    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, data_dict):
        if "color" in data_dict:
            hsv = _rgb_to_hsv(data_dict["color"][:, :3])
            hue_val = (np.random.rand() - 0.5) * 2 * self.hue_max
            sat_ratio = 1 + (np.random.rand() - 0.5) * 2 * self.saturation_max
            hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
            hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
            data_dict["color"][:, :3] = np.clip(_hsv_to_rgb(hsv), 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class RandomColorJitter:
    """Brightness/contrast/saturation/hue jitter (torchvision-style)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, p=0.95):
        self.brightness = self._range(brightness, "brightness")
        self.contrast = self._range(contrast, "contrast")
        self.saturation = self._range(saturation, "saturation")
        self.hue = self._range(hue, "hue", center=0, bound=(-0.5, 0.5), clip_zero=False)
        self.p = p

    @staticmethod
    def _range(value, name, center=1, bound=(0, float("inf")), clip_zero=True):
        if isinstance(value, numbers.Number):
            if value < 0:
                raise ValueError(f"{name} must be non-negative")
            value = [center - float(value), center + float(value)]
            if clip_zero:
                value[0] = max(value[0], 0.0)
        elif isinstance(value, (tuple, list)) and len(value) == 2:
            if not bound[0] <= value[0] <= value[1] <= bound[1]:
                raise ValueError(f"{name} values must be within {bound}")
        else:
            raise TypeError(f"{name} must be a number or a pair")
        if value[0] == value[1] == center:
            return None
        return value

    @staticmethod
    def _blend(c1, c2, ratio):
        return (float(ratio) * c1 + (1.0 - float(ratio)) * c2).clip(0, 255).astype(
            c1.dtype
        )

    def __call__(self, data_dict):
        order = np.random.permutation(4)
        b = None if self.brightness is None else np.random.uniform(*self.brightness)
        c = None if self.contrast is None else np.random.uniform(*self.contrast)
        s = None if self.saturation is None else np.random.uniform(*self.saturation)
        h = None if self.hue is None else np.random.uniform(*self.hue)
        for fn_id in order:
            if fn_id == 0 and b is not None and np.random.rand() < self.p:
                data_dict["color"] = self._blend(
                    data_dict["color"], np.zeros_like(data_dict["color"]), b
                )
            elif fn_id == 1 and c is not None and np.random.rand() < self.p:
                mean = np.mean(rgb_to_grayscale(data_dict["color"]))
                data_dict["color"] = self._blend(data_dict["color"], mean, c)
            elif fn_id == 2 and s is not None and np.random.rand() < self.p:
                gray = rgb_to_grayscale(data_dict["color"])
                data_dict["color"] = self._blend(data_dict["color"], gray, s)
            elif fn_id == 3 and h is not None and np.random.rand() < self.p:
                hsv = _rgb_to_hsv(data_dict["color"])
                hsv[..., 0] = (hsv[..., 0] + h) % 1.0
                data_dict["color"] = np.clip(_hsv_to_rgb(hsv), 0, 255).astype(
                    data_dict["color"].dtype
                )
        return data_dict


@TRANSFORMS.register_module()
class RandomColorDrop:
    def __init__(self, p=0.2, color_augment=0.0):
        self.p = p
        self.color_augment = color_augment

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            data_dict["color"] = data_dict["color"] * self.color_augment
        return data_dict

    def __repr__(self):
        return f"RandomColorDrop(color_augment: {self.color_augment}, p: {self.p})"


# --------------------------------------------------------------------------
# structural transforms
# --------------------------------------------------------------------------

def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV-1a 64-bit hash of integer coordinate rows (voxel keys)."""
    assert arr.ndim == 2
    arr = arr.astype(np.uint64, copy=True)
    hashed = np.full(arr.shape[0], np.uint64(14695981039346656037), dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed *= np.uint64(1099511628211)
        hashed = np.bitwise_xor(hashed, arr[:, j])
    return hashed


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    """Row-major ravel of shifted integer coordinates (collision-free)."""
    assert arr.ndim == 2
    arr = arr - arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


@TRANSFORMS.register_module()
class GridSample:
    """Voxel-grid subsampling (train: one random point per voxel) or
    complementary fragment enumeration (test), matching the reference
    (transform.py:788-925).
    """

    def __init__(
        self,
        grid_size=0.05,
        hash_type="fnv",
        mode="train",
        keys=("coord", "color", "normal", "segment"),
        return_inverse=False,
        return_grid_coord=False,
        return_min_coord=False,
        return_displacement=False,
        project_displacement=False,
    ):
        self.grid_size = grid_size
        self.hash = fnv_hash_vec if hash_type == "fnv" else ravel_hash_vec
        assert mode in ("train", "test")
        self.mode = mode
        self.keys = keys
        self.return_inverse = return_inverse
        self.return_grid_coord = return_grid_coord
        self.return_min_coord = return_min_coord
        self.return_displacement = return_displacement
        self.project_displacement = project_displacement

    def _voxelize(self, coord):
        scaled = coord / np.array(self.grid_size)
        grid = np.floor(scaled).astype(int)
        gmin = grid.min(0)
        grid = grid - gmin
        scaled = scaled - gmin
        min_coord = gmin * np.array(self.grid_size)

        # native O(N) hash dedup when built (pointcloudpdf_tpu_torch/native);
        # else the numpy argsort + unique path, with the same result
        if self.hash is fnv_hash_vec:
            from .. import native

            if native.available():
                keys = native.fnv_hash(grid)
                result = native.voxel_unique(keys)
                if result is not None:
                    order, inverse_pp, counts, _ = result
                    return (grid, scaled, min_coord, order,
                            inverse_pp[order], counts)
        key = self.hash(grid)
        idx_sort = np.argsort(key)
        _, inverse, count = np.unique(
            key[idx_sort], return_inverse=True, return_counts=True
        )
        return grid, scaled, min_coord, idx_sort, inverse, count

    def _displacement(self, scaled, grid, data_dict):
        disp = scaled - grid - 0.5  # offset of the point inside its voxel
        if self.project_displacement:
            disp = np.sum(disp * data_dict["normal"], axis=-1, keepdims=True)
        return disp

    def __call__(self, data_dict):
        assert "coord" in data_dict
        grid, scaled, min_coord, idx_sort, inverse, count = self._voxelize(
            data_dict["coord"]
        )
        voxel_starts = np.cumsum(np.insert(count, 0, 0)[:-1])

        if self.mode == "train":
            pick = np.random.randint(0, count.max(), count.size) % count
            idx_unique = idx_sort[voxel_starts + pick]
            if "sampled_index" in data_dict:
                # data-efficient ScanNet: the labeled points must survive
                # voxel subsampling, so union them into the kept set and
                # re-express them as positions within it
                labeled = np.unique(data_dict["sampled_index"])
                idx_unique = np.union1d(idx_unique, labeled)
                data_dict["sampled_index"] = np.searchsorted(
                    idx_unique, labeled
                )
            if self.return_inverse:
                inv = np.zeros_like(inverse)
                inv[idx_sort] = inverse
                data_dict["inverse"] = inv
            if self.return_grid_coord:
                data_dict["grid_coord"] = grid[idx_unique]
            if self.return_min_coord:
                data_dict["min_coord"] = min_coord.reshape(1, 3)
            if self.return_displacement:
                data_dict["displacement"] = self._displacement(
                    scaled, grid, data_dict
                )[idx_unique]
            for key in self.keys:
                data_dict[key] = data_dict[key][idx_unique]
            return data_dict

        # test mode: enumerate complementary fragments covering every point
        fragments = []
        for i in range(count.max()):
            idx_part = idx_sort[voxel_starts + i % count]
            part = dict(index=idx_part)
            if self.return_inverse:
                inv = np.zeros_like(inverse)
                inv[idx_sort] = inverse
                data_dict["inverse"] = inv
            if self.return_grid_coord:
                part["grid_coord"] = grid[idx_part]
            if self.return_min_coord:
                part["min_coord"] = min_coord.reshape(1, 3)
            if self.return_displacement:
                part["displacement"] = self._displacement(scaled, grid, data_dict)[
                    idx_part
                ]
            for key in data_dict:
                part[key] = data_dict[key][idx_part] if key in self.keys else data_dict[key]
            fragments.append(part)
        return fragments


@TRANSFORMS.register_module()
class SphereCrop:
    """Crop to the point_max nearest points around a random/center point,
    or enumerate covering crops ('all'), matching transform.py:928-1025."""

    def __init__(self, point_max=80000, sample_rate=None, mode="random"):
        self.point_max = point_max
        self.sample_rate = sample_rate
        assert mode in ("random", "center", "all")
        self.mode = mode

    def __call__(self, data_dict):
        point_max = (
            int(self.sample_rate * data_dict["coord"].shape[0])
            if self.sample_rate is not None
            else self.point_max
        )
        assert "coord" in data_dict
        n = data_dict["coord"].shape[0]

        if self.mode == "all":
            if "index" not in data_dict:
                data_dict["index"] = np.arange(n)
            if n <= point_max:
                part = dict(data_dict)
                part["weight"] = np.zeros(n)
                return [part]
            parts = []
            priority = np.random.rand(n) * 1e-3
            covered = np.zeros(n, dtype=bool)
            while not covered.all():
                center_idx = int(np.argmin(priority))
                dist2 = np.sum(
                    (data_dict["coord"] - data_dict["coord"][center_idx]) ** 2, 1
                )
                idx_crop = np.argsort(dist2)[:point_max]
                part = dict(index=data_dict["index"][idx_crop])
                for key in ("coord", "grid_coord", "normal", "color",
                            "displacement", "strength"):
                    if key in data_dict:
                        part[key] = data_dict[key][idx_crop]
                part["weight"] = dist2[idx_crop]
                parts.append(part)
                priority[idx_crop] += np.square(
                    1 - part["weight"] / np.max(part["weight"])
                )
                covered[idx_crop] = True
            return parts

        if n > point_max:
            if self.mode == "random":
                center = data_dict["coord"][np.random.randint(n)]
            else:  # center
                center = data_dict["coord"][n // 2]
            idx_crop = np.argsort(
                np.sum(np.square(data_dict["coord"] - center), 1)
            )[:point_max]
            index_points(data_dict, idx_crop)
        return data_dict


@TRANSFORMS.register_module()
class ShufflePoint:
    def __call__(self, data_dict):
        assert "coord" in data_dict
        perm = np.random.permutation(data_dict["coord"].shape[0])
        return index_points(data_dict, perm)


@TRANSFORMS.register_module()
class CropBoundary:
    def __call__(self, data_dict):
        segment = data_dict["segment"].flatten()
        keep = (segment != 0) & (segment != 1)
        return index_points(data_dict, keep)


@TRANSFORMS.register_module()
class ContrastiveViewsGenerator:
    def __init__(self, view_keys=("coord", "color", "normal", "origin_coord"),
                 view_trans_cfg=None):
        self.view_keys = view_keys
        self.view_trans = Compose(view_trans_cfg)

    def __call__(self, data_dict):
        for prefix in ("view1_", "view2_"):
            view = {k: data_dict[k].copy() for k in self.view_keys}
            view = self.view_trans(view)
            for key, value in view.items():
                data_dict[prefix + key] = value
        return data_dict


@TRANSFORMS.register_module()
class InstanceParser:
    """Instance GT -> per-point centroid + per-instance bbox records
    (reference transform.py:1097-1141)."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = segment_ignore_index
        self.instance_ignore_index = instance_ignore_index

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        segment = data_dict["segment"]
        instance = data_dict["instance"]
        keep = ~np.isin(segment, self.segment_ignore_index)
        instance[~keep] = self.instance_ignore_index
        unique, inverse = np.unique(instance[keep], return_inverse=True)
        instance_num = len(unique)
        instance[keep] = inverse
        centroid = np.full((coord.shape[0], 3), float(self.instance_ignore_index))
        bbox = np.full((instance_num, 8), float(self.instance_ignore_index))
        vacancy = [i for i in self.segment_ignore_index if i >= 0]
        for inst_id in range(instance_num):
            sel = instance == inst_id
            pts = coord[sel]
            bbox_min, bbox_max = pts.min(0), pts.max(0)
            cls = segment[sel][0] - np.greater(segment[sel][0], vacancy).sum()
            centroid[sel] = pts.mean(0)
            bbox[inst_id] = np.concatenate(
                [
                    (bbox_max + bbox_min) / 2,
                    bbox_max - bbox_min,
                    np.zeros(1),
                    np.array([cls], dtype=float),
                ]
            )
        data_dict["instance"] = instance
        data_dict["instance_centroid"] = centroid
        data_dict["bbox"] = bbox
        return data_dict


# --------------------------------------------------------------------------
# open-world / incremental transforms
# --------------------------------------------------------------------------

@TRANSFORMS.register_module()
class MaskLabel:
    """Open-set label masking: unknown classes -> mask_to in a new
    ``segment_known`` key (reference transform.py:1144-1157)."""

    def __init__(self, mask_label=None, mask_to=-1):
        self.mask_label = mask_label
        self.mask_to = mask_to

    def __call__(self, data_dict):
        if self.mask_label is not None:
            assert "segment" in data_dict
            known = data_dict["segment"].copy()
            known[np.isin(known, self.mask_label)] = self.mask_to
            data_dict["segment_known"] = known
        return data_dict


@TRANSFORMS.register_module()
class RemapLabel:
    """Incremental-learning label remap producing ``segment_incr`` (only
    remapped classes labeled) and ``segment_incr_remap`` (all classes,
    remapped ids), matching reference transform.py:1160-1207."""

    def __init__(self, remap_dict, remap_select=None, ignore_index=-1):
        self.remap_dict = remap_dict
        self.remap_select = remap_select
        self.ignore_index = ignore_index

    def __call__(self, data_dict):
        if self.remap_dict is None:
            return data_dict
        assert "segment" in data_dict
        segment = data_dict["segment"]
        size = int(max(segment.max(), max(self.remap_dict.keys()))) + 1
        lookup_remap = np.arange(size)
        lookup_incr = np.full(size, self.ignore_index, dtype=segment.dtype)
        if self.remap_select is not None:
            selected = set(self.remap_select) & set(self.remap_dict)
            unselected = set(self.remap_dict) - selected
            for old in selected:
                lookup_remap[old] = self.remap_dict[old]
                lookup_incr[old] = self.remap_dict[old]
            if unselected:
                arr = np.array(sorted(unselected))
                lookup_remap[arr] = self.ignore_index
                lookup_incr[arr] = self.ignore_index
        else:
            for old, new in self.remap_dict.items():
                lookup_remap[old] = new
                lookup_incr[old] = new
        data_dict["segment_incr_remap"] = lookup_remap[segment]
        data_dict["segment_incr"] = lookup_incr[segment]
        old_keys = np.array(list(self.remap_dict.keys()))
        assert not np.isin(data_dict["segment_incr_remap"], old_keys).any()
        assert not np.isin(data_dict["segment_incr"], old_keys).any()
        return data_dict


class Compose:
    """Sequential transform pipeline built from a list of config dicts."""

    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.transforms = [TRANSFORMS.build(t) for t in self.cfg]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict
