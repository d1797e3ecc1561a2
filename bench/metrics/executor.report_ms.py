"""Host milliseconds per factorization that ``PlanExecutor.run``'s main
thread spends in the report (the plan's projected peak, the report and
its publishing): stage ``report`` of the program's counter
``repro_executor_stage_seconds_total`` (self time), over the window."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    seconds = REGISTRY.get("repro_executor_stage_seconds_total")
    if seconds is None or not ctx.count:
        return None
    return 1e3 * seconds.value_of(stage="report") / ctx.count
