from repro_torch.checkpoint.checkpoint import (
    Checkpointer, load_latest, reshard,
)

__all__ = ["Checkpointer", "load_latest", "reshard"]
