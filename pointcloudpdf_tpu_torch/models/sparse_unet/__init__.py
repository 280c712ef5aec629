from .spconv_unet import (BasicBlock, BottleneckBlock, SparseDownConv,
                          SparseInverseConv, SpUNet, SubMConv)
