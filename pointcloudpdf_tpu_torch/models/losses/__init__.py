from .builder import LOSSES, Criteria, build_criteria
from .misc import (
    CrossEntropyLoss,
    SmoothCELoss,
    BinaryFocalLoss,
    FocalLoss,
    DiceLoss,
)
from .lovasz import LovaszLoss
