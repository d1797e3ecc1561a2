"""Host seconds of the executor's set-up of the pattern: building every
front's entry maps and uploading them to the lanes, once a pattern (stage
``maps`` of the program's counter
``repro_executor_setup_seconds_total``).  The harness calls ``warmup()``
without a matrix, so the first factorization of the window does it."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    seconds = REGISTRY.get("repro_executor_setup_seconds_total")
    if seconds is None:
        return None
    return seconds.value_of(stage="maps")
