"""Checkpointing: npz + manifest, async writes, auto-resume
(``repro/checkpoint``)."""

from .manager import FAULT_KINDS, CheckpointManager

__all__ = ["CheckpointManager", "FAULT_KINDS"]
