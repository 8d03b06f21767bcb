"""Optimizer and gradient transforms of the trainer (counterpart of
``repro.optim``): AdamW with its schedules and int8 gradient compression
with error feedback."""
from repro_torch.optim.adamw import (AdamW, AdamWState, ScaledGrads,
                                     clip_by_global_norm, clip_scale,
                                     cosine_schedule, wsd_schedule)

__all__ = ["AdamW", "AdamWState", "ScaledGrads", "clip_by_global_norm",
           "clip_scale", "cosine_schedule", "wsd_schedule"]
