"""Checkpointing: async saves, rotation, restore from any shard layout
(counterpart of ``repro/checkpoint``)."""

from repro_torch.checkpoint.checkpointing import (CheckpointManager,
                                                  latest_step, latest_steps,
                                                  load_checkpoint,
                                                  save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "latest_steps", "CheckpointManager"]
