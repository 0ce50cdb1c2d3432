"""query_ms.df64: ``query_ms`` in the df64 cells.  Their queries are
some 2.5 times longer than float32's and spread less from run to run,
so they get a bound of their own."""

from lanczos_bench.metrics.query_ms import (  # noqa: F401
    BETTER, SOURCE, UNIT, read)
