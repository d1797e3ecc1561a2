"""Checkpoint / restart (port of ``repro.checkpoint``)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
