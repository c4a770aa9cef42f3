"""Checkpoints in the JAX package's file format (``ckpt/checkpoint.py``)."""

from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
