"""device_idle_pct: 1 - the union of the device operations' intervals
over the traced queries' span (torch.profiler in the run's own
process), in %."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "query_ms"


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return run.trace.idle_pct
