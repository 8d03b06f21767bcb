"""Checkpoints in the reference's on-disk format (counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import Checkpointer

__all__ = ["Checkpointer"]
