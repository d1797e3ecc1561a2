"""Synthetic token pipeline (port of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticTokens, place, with_extras

__all__ = [k for k in dir() if not k.startswith("_")]
