"""driver_ms: the window's mean query wall less ``lanczos_ms``: the
query driver's device eigh, GEMV, masked top-k and O(topk) fetch, and
the host's share.  A difference of two measurements, noisier than
either."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "query driver", "query_ms"


def read(run):
    lanczos = run.metric("lanczos_ms")
    if lanczos is None:
        return None
    return 1e3 * float(np.mean(run.latencies)) - lanczos
