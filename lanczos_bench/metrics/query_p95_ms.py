"""query_p95_ms: the 95th percentile of every window query's host-wall
latency, call to return."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    return 1e3 * float(np.percentile(run.latencies, 95))
