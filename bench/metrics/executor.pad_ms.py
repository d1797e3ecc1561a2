"""Host milliseconds per factorization that ``PlanExecutor.run``'s main
thread spends in padding fronts to their shape class and stacking them:
stage ``pad`` of the program's counter
``repro_executor_stage_seconds_total`` (self time), over the window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    seconds = REGISTRY.get("repro_executor_stage_seconds_total")
    if seconds is None or not ctx.count:
        return None
    return 1e3 * seconds.value_of(stage="pad") / ctx.count
