from .st import (KPConvBlock, STBlock, StratifiedTransformer,
                 StratifiedWindowAttention, TransitionDown, Upsample,
                 key_sets_layer, kpconv_kernel_points)
