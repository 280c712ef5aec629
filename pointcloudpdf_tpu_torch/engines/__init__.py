from .defaults import (
    default_argument_parser,
    default_config_parser,
    default_setup,
)
from .test import TESTERS, OpenSegTester, SemSegTester, TesterBase
from .train import TRAINERS, OpenSegTrainer, Trainer, TrainerBase
