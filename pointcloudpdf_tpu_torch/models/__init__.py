from .builder import MODELS, build_model
from .default import DefaultSegmentor, DefaultSegmentorV2
from .norm import MaskedBatchNorm
from . import point_transformer  # registers PointTransformer-Seg26/38/50
from . import stratified_transformer  # registers ST-v1m1 / ST-v1m2
from . import point_transformer_v2  # registers PT-v2m2 / PT-v2m1
from . import context_aware_classifier  # registers CAC-v1m1
from . import sparse_unet  # registers SpUNet-v1m1/v1m2/v1m3, MinkUNet*
from . import point_transformer_v3  # registers PT-v3m1
from . import point_prompt_training  # registers PPT-v1m1 / PPT-v1m2
from . import swin3d  # registers Swin3D-v1m1
from . import octformer  # registers OctFormer-v1m1
from . import oacnns  # registers OACNNs / OACNNs-v1m1
from . import point_group  # registers PG-v1m1
