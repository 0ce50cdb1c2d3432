"""kernels_per_query: kernel records in the traced queries over the
queries traced."""

UNIT, BETTER, SOURCE = "kernels", "lower", "device_trace"
LAYER, MOVES = "device", "query_ms"


def read(run):
    if run.trace is None or run.trace.kernels == 0:
        return None
    return run.trace.kernels / run.trace.queries
