from .ptv2 import (Block, BlockSequence, GridPool, GroupedVectorAttention,
                   PointBatchNorm, PointTransformerV2, UnpoolWithSkip,
                   capacity_dropped_points, point_transformer_v2m1)
