"""query_lanczos_ms: card time of the ``lanczos`` span inside the served
float32 query (the program's CUDA events at the span's bounds, so the
card's waits on launches within the loop count), median over the
recorded queries.  Against ``lanczos_ms``, the same work called alone,
it shows how long the card waited on the host inside the served loop."""

from lanczos_bench.harness import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "Lanczos loop", "query_ms"


def read(run):
    if run.traffic["precision"] != "float32":
        return None
    return spans.median(spans.recorded(run), "device_ms",
                        spans.named("lanczos"))
