from repro_torch.checkpoint.store import (checkpoint_path, checkpoint_step,
                                          latest_checkpoint, load_checkpoint,
                                          read_checkpoint_meta,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "checkpoint_step", "checkpoint_path", "read_checkpoint_meta"]
