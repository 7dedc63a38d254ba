from repro_torch.checkpoint.checkpoint import Checkpointer, load_latest

__all__ = ["Checkpointer", "load_latest"]
