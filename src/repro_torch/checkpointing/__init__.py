from repro_torch.checkpointing.checkpoint import (
    CheckpointError,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

__all__ = ["CheckpointError", "save_checkpoint", "restore_checkpoint",
           "latest_step", "verify_checkpoint"]
