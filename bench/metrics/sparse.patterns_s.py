"""Host seconds of the column patterns in set-up's analysis: stage
``patterns`` of the program's counter
``repro_sparse_analyze_seconds_total`` (on the supervariables where
consecutive columns share their structure, else on the columns)."""


def read(ctx):
    from repro_torch.obs import REGISTRY

    seconds = REGISTRY.get("repro_sparse_analyze_seconds_total")
    if seconds is None:
        return None
    return seconds.value_of(stage="patterns")
