from .builder import LOSSES, Criteria, build_criteria
from .misc import CrossEntropyLoss
