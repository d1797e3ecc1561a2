from .elastic import (
    ElasticController,
    ElasticEvent,
    HeartbeatMonitor,
    run_elastic_online,
    run_elastic_schedule,
)
from .executor import (
    ExecutionReport,
    PlanExecutor,
    TraceEvent,
    execute_plan,
)
from .straggler import (
    FrontDelays,
    StragglerDetector,
    StragglerInjector,
    rebalance_two_pods,
)

__all__ = [k for k in dir() if not k.startswith("_")]
