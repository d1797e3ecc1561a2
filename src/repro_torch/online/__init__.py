"""Online scheduling — the part of ``repro.online`` ported so far.

events     discrete-event core: heap, virtual clock, pool, noise models

``state``, ``scheduler``, ``queue`` and ``replay`` are not ported yet
(ROADMAP queue 1 item 7).
"""
from .events import (
    Arrival,
    EventQueue,
    LognormalNoise,
    NoNoise,
    ProcessorPool,
    SetCapacity,
    SetNodeSpeed,
    TaskFailure,
    UniformNoise,
    VirtualClock,
)

__all__ = [k for k in dir() if not k.startswith("_")]
