from .builder import DATASETS, build_dataset
from .transform import TRANSFORMS, Compose
from .utils import padded_collate_fn, bucket_capacity, LABEL_KEYS
from .defaults import DefaultDataset, ConcatDataset, load_scene
from .s3dis import S3DISDataset
from .scannet import ScanNetDataset, ScanNet200Dataset
from .structured3d import Structured3DDataset
from .semantic_kitti import SemanticKITTIDataset
from .nuscenes import NuScenesDataset
from .waymo import WaymoDataset
