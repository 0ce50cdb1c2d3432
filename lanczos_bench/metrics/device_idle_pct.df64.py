"""device_idle_pct.df64: ``device_idle_pct`` in the df64 cells, which
report ``query_ms.df64``."""

from lanczos_bench.metrics.device_idle_pct import (  # noqa: F401
    BETTER, LAYER, SOURCE, UNIT, read)

MOVES = "query_ms.df64"
