from .ptv3 import PointTransformerV3
