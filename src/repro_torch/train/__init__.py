"""Training substrate: optimizers, train-step factory, host loop.  The
pipeline-parallel twins and ``state_logical_axes`` wait for the port's
``dist.pipeline`` and ``dist.sharding``."""

from repro_torch.train.optimizer import OptimizerConfig, global_norm, make_optimizer, make_schedule
from repro_torch.train.state import TrainState
from repro_torch.train.loop import (
    TrainHooks,
    make_init_state,
    make_train_step,
    train_loop,
)

__all__ = [
    "OptimizerConfig",
    "make_optimizer",
    "make_schedule",
    "global_norm",
    "TrainState",
    "make_train_step",
    "make_init_state",
    "train_loop",
    "TrainHooks",
]
