"""query_p95_ms.df64: ``query_p95_ms`` in the df64 cells, with a bound
of its own (see ``query_ms.df64``)."""

from lanczos_bench.metrics.query_p95_ms import (  # noqa: F401
    BETTER, SOURCE, UNIT, read)
