"""eigh_ms: card time of the ``eigh`` span inside the served float32
query (the dense T and cuSOLVER's eigh with its error-check sync),
median over the recorded queries."""

from lanczos_bench.harness import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "eigensolve", "query_ms"


def read(run):
    if run.traffic["precision"] != "float32":
        return None
    return spans.median(spans.recorded(run), "device_ms",
                        spans.named("eigh"))
