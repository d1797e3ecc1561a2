"""Model configurations of the assigned architectures (port of
``repro.models``, the config only).

config       ModelConfig / MoEConfig / SSMConfig, the shape cells

The models themselves (attention, MoE, the SSM blocks, the transformer
assembly, decode) are ROADMAP queue 1 item 10; the workload zoo
(:mod:`repro_torch.workloads`) needs only the configs.
"""
from .config import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeCell,
    SSMConfig,
    cell_is_runnable,
    shape_by_name,
)

__all__ = [k for k in dir() if not k.startswith("_")]
