from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore
from byol_tpu_torch.checkpoint.saver import ModelSaver

__all__ = ["CheckpointStore", "ModelSaver"]
