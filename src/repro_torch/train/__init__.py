"""Training substrate: optimizers, train-step factory, host loop, and the
pipeline-parallel twins of the step (``make_pipeline_*``)."""

from repro_torch.train.optimizer import OptimizerConfig, global_norm, make_optimizer, make_schedule
from repro_torch.train.state import TrainState, state_logical_axes
from repro_torch.train.loop import (
    TrainHooks,
    make_init_state,
    make_pipeline_init_state,
    make_pipeline_train_step,
    make_train_step,
    train_loop,
)

__all__ = [
    "OptimizerConfig",
    "make_optimizer",
    "make_schedule",
    "global_norm",
    "TrainState",
    "state_logical_axes",
    "make_train_step",
    "make_init_state",
    "make_pipeline_train_step",
    "make_pipeline_init_state",
    "train_loop",
    "TrainHooks",
]
