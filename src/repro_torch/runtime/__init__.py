from .executor import (
    ExecutionReport,
    PlanExecutor,
    TraceEvent,
    execute_plan,
)

__all__ = [k for k in dir() if not k.startswith("_")]
