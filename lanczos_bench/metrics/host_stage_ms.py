"""host_stage_ms: the summed wall of the ``host`` spans of a served
float32 query (the host's own work with nothing queued on the card,
``map_nodes`` in the fused query), median over the recorded queries:
device idle that the host's own work causes."""

from lanczos_bench.harness import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "query driver", "query_ms"


def read(run):
    if run.traffic["precision"] != "float32":
        return None
    return spans.median(spans.recorded(run), "wall_ms",
                        spans.of_kind("host"))
