"""query_ms: the window's time over the queries completed in it (one
client, closed loop, each query returning its answer to the host)."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    return 1e3 * run.window_s / len(run.latencies)
