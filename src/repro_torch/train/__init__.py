"""Training (``repro.train``): AdamW, the train step, the data-parallel
step with its int8 gradient compression, the step under a sharding
policy, and the ``Trainer`` loop."""
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.train.grad_compress import compressed_psum
from repro_torch.train.train_loop import (
    TrainState, Trainer, copy_state, init_state, make_ddp_train_step,
    make_sharded_train_step, make_train_step,
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
    "make_ddp_train_step",
    "make_sharded_train_step",
    "make_train_step",
    "compressed_psum",
]
