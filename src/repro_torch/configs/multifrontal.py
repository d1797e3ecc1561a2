"""The paper's own 'architecture': a PM-scheduled multifrontal Cholesky
solver configuration (grid, ordering, amalgamation, alpha, mesh)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class SolverConfig:
    name: str = "multifrontal-cholesky"
    grid: int = 63                  # 2D grid edge (n = grid²)
    dim: int = 2                    # 2 or 3
    relax: int = 2                  # supernode amalgamation
    alpha: float = 0.9              # §3-calibrated speedup exponent
    total_devices: int = 256        # single-pod mesh
    min_devices: int = 1
    dtype: str = "float32"


CONFIG = SolverConfig()
