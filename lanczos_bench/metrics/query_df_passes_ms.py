"""query_df_passes_ms: card time of the ``pass1`` and ``pass2`` spans of
the served df64 query together (the alpha/beta pass, and the recombine
pass with its coefficients' copy), median over the recorded queries.
Against twice ``df_pass_ms`` it shows the card's waits on launches
inside the served passes."""

from lanczos_bench.harness import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "Lanczos loop", "query_ms.df64"


def read(run):
    if run.traffic["precision"] != "df64":
        return None
    return spans.median(spans.recorded(run), "device_ms",
                        spans.named("pass1", "pass2"))
