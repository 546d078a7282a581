"""Checkpointing: atomic, asynchronous save and restore of state trees."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
