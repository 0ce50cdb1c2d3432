"""host_stage_ms.df64: ``host_stage_ms`` in the df64 cells, which report
``query_ms.df64``: the host eigh, ``to_f64`` and ``permute_out``."""

from lanczos_bench.harness import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "query driver", "query_ms.df64"


def read(run):
    if run.traffic["precision"] != "df64":
        return None
    return spans.median(spans.recorded(run), "wall_ms",
                        spans.of_kind("host"))
