from .swin3d import Swin3DUNet
