"""Optimizers and schedules (counterpart of ``repro/optimizer``)."""

from repro_torch.optimizer.optimizers import (OptConfig, adafactor_init,
                                              adafactor_update, adamw_init,
                                              adamw_update,
                                              clip_by_global_norm,
                                              global_norm, make_optimizer)
from repro_torch.optimizer.schedules import cosine_schedule, wsd_schedule

__all__ = ["adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "OptConfig", "make_optimizer",
           "cosine_schedule", "wsd_schedule", "global_norm",
           "clip_by_global_norm"]
