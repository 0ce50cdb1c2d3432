"""The benchmark's general code: specs found by name, graph generation,
the query loop, the trace reduction, rooflines and the check."""
