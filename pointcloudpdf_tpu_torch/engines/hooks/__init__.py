from .builder import HOOKS, build_hooks
from .default import HookBase
from .misc import (
    IterationTimer,
    InformationWriter,
    CheckpointSaver,
    CheckpointLoader,
    OpenSegCheckpointSaver,
    OpenSegCheckpointLoader,
    IncrSegCheckpointSaver,
    IncrSegCheckpointLoader,
    PreciseEvaluator,
)
from .evaluator import (SemSegEvaluator, OpenSegEvaluator, IncrSegEvaluator,
                        InsSegEvaluator)
