from .pdnorm import PDNorm
from .ppt import PointPromptTraining, PointPromptTrainingV2
