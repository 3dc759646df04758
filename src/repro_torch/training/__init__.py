"""Training substrate: optimizers, schedules, compression, train loop."""
from .optimizer import OPTIMIZERS, adamw, apply_updates, clip_by_global_norm, lion  # noqa: F401
from .schedule import constant, warmup_cosine  # noqa: F401
from .train_loop import TrainLoopConfig, build_train_step, run_training  # noqa: F401
from .train_state import (  # noqa: F401
    TrainState, train_state_from_numpy, train_state_to_numpy,
)
