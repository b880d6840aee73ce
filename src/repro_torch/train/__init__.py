"""Training: the train step and the trainer with checkpoint restarts."""

from .step import init_train_state, make_train_step, train_state_specs
from .trainer import FailureInjector, InjectedFailure, Trainer

__all__ = ["FailureInjector", "InjectedFailure", "Trainer",
           "init_train_state", "make_train_step", "train_state_specs"]
