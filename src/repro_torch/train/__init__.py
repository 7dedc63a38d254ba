"""Training at world size 1 (``repro.train``): AdamW, the train step and
the ``Trainer`` loop."""
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.train.train_loop import (
    TrainState, Trainer, copy_state, init_state, make_train_step,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "TrainState",
    "Trainer",
    "copy_state",
    "init_state",
    "make_train_step",
]
