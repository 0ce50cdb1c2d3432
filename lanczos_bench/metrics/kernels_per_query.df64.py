"""kernels_per_query.df64: ``kernels_per_query`` in the df64 cells, which
report ``query_ms.df64``."""

from lanczos_bench.metrics.kernels_per_query import (  # noqa: F401
    BETTER, LAYER, SOURCE, UNIT, read)

MOVES = "query_ms.df64"
